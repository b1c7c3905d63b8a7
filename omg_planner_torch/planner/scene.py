"""Host-side scene layer: Env, PointEnv, PlanningScene
(counterpart of ``omg_planner_tpu/planner/scene.py``; reference
``omg/core.py:243-779``).

The Env is a host container that stages tensors on its device (the
collision scene, CostParams, GoalSet, PlanProblem); the PlanningScene runs
the plan.  Scene edits bump ``env.version`` and invalidate what was
staged.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU they raise.
"""

from __future__ import annotations

import time
from typing import List

import numpy as np
import torch

from .. import resolve_device
from ..config import OMGConfig
from ..io.assets import (DEFAULT_END, DEFAULT_START, SceneObject,
                         make_primitive, pose_at, synthetic_tabletop_scene)
from ..models import api as model_api
from ..models import panda
from ..ops.chomp import CostParams, GoalSet
from ..ops.sdf import (AnalyticScene, WorldField, WorldPotential,
                       analytic_prim_arrays, bake_scene, bake_world_field,
                       bake_world_field_analytic, bake_world_potential,
                       bake_world_potential_analytic, make_analytic_scene,
                       stage_scene_sdfs)
from ..utils import timing
from ..utils.sync import host_int
from . import goal_set as gs
from . import plan as plan_mod


def _f32(a, device) -> torch.Tensor:
    """Host array -> float32 tensor on ``device`` (host poses, extents and
    configurations are float64)."""
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class Env:
    """Scene container (reference ``Env``, ``omg/core.py:243-411``)."""

    def __init__(self, cfg: OMGConfig, model=None, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = model if model is not None else panda.load_panda(
            cfg.collision_point_num, str(self.device))
        self.objects: List[SceneObject] = []
        self.target_idx = 0
        self._scene_sdf = None
        self._cost_params_cache = None
        self.version = 0  # bumped on every edit; staged-state invalidation

    # -- edits ------------------------------------------------------------
    def add_object(self, obj: SceneObject):
        self.objects.append(obj)
        self._scene_sdf = None
        self.version += 1

    def remove_object(self, name: str):
        idx = self.names.index(name)
        del self.objects[idx]
        if idx == self.target_idx:
            self.target_idx = 0
        elif idx < self.target_idx:
            self.target_idx -= 1
        if self.target_idx >= len(self.objects):
            self.target_idx = 0
        self._scene_sdf = None
        self.version += 1

    def clear(self):
        self.objects = []
        self._scene_sdf = None
        self.version += 1

    def set_target(self, name: str):
        self.target_idx = self.names.index(name)
        self.objects[self.target_idx].compute_grasp = True
        self.version += 1

    def update_pose(self, name: str, pose_mat: np.ndarray):
        self.objects[self.names.index(name)].update_pose(pose_mat)
        self.version += 1

    def add_table(self, trans, extents=(1.0, 1.6, 0.36), delta=0.02):
        """A box table (reference ``Env.add_table``,
        ``omg/core.py:294-306``)."""
        self.add_object(make_primitive(
            "table", "box", list(extents), pose_at(trans),
            compute_grasp=False, delta=delta))

    def add_plane(self, z: float = 0.0):
        """The floor, collision-disabled by name (reference
        ``Env.add_plane``; 'floor' is skipped in the cost layer,
        ``omg/cost.py:311``)."""
        self.add_object(make_primitive(
            "floor", "box", [3.0, 3.0, 0.02], pose_at([0, 0, z - 0.01]),
            compute_grasp=False, delta=0.05))

    @property
    def names(self):
        return [o.name for o in self.objects]

    @property
    def target(self) -> SceneObject:
        return self.objects[self.target_idx]

    # -- staging ----------------------------------------------------------
    def stage_scene(self, pad_to: tuple | None = None):
        """Stage the collision scene anew: an :class:`AnalyticScene` when
        every object is an analytic primitive (``cfg.sdf_analytic``), else
        the padded voxel stack (baked per ``cfg.sdf_baked``), synthesised
        on the device for primitives.  ``pad_to`` pads the stack to a
        suite-wide shape."""
        with timing.span("scene_stage"):
            fields = [o.sdf for o in self.objects]
            scene = (make_analytic_scene(fields, self.device)
                     if self.cfg.sdf_analytic else None)
            if scene is None:
                scene = stage_scene_sdfs(fields, self.device,
                                         baked=self.cfg.sdf_baked,
                                         pad_to=pad_to)
        self._scene_sdf = scene
        return scene

    def scene_sdf(self):
        """The staged collision scene (staged on first use)."""
        if self._scene_sdf is None:
            self.stage_scene()
        return self._scene_sdf

    def cost_params(self) -> CostParams:
        """Per-object collision parameters (reference
        ``Cost.compute_obstacle_cost_layer``, ``omg/cost.py:299-335``),
        cached per (env version, ``cfg.jit_key()``)."""
        cfg = self.cfg
        key = (self.version, cfg.jit_key())
        cached = self._cost_params_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        n = len(self.objects)
        inv_poses = np.zeros((n, 4, 4), np.float32)
        eps = np.full(n, cfg.epsilon, np.float32)
        pad = np.ones(n, np.float32)
        clear = np.full(n, cfg.clearance, np.float32)
        disab = np.zeros(n, np.float32)
        for i, o in enumerate(self.objects):
            inv_poses[i] = np.linalg.inv(o.pose_mat)
            if o.name == "floor" or o.name in cfg.disable_collision_set:
                disab[i] = 1.0
            if i == self.target_idx:
                clear[i] = cfg.target_clearance
                eps[i] = cfg.target_epsilon
        if self.target.attached:
            # placement: soften the support surface (cost.py:325-328)
            support = [i for i, o in enumerate(self.objects)
                       if o.name.split("_")[0] in
                       ("table", "shelf", "support", "floor")]
            for i in support or [n - 1]:
                clear[i] = 0.0
                eps[i] = 0.05
                pad[i] = 0.5
        d = self.device
        params = CostParams(
            inv_poses=_f32(inv_poses, d), epsilons=_f32(eps, d),
            padding_scales=_f32(pad, d), clearances=_f32(clear, d),
            disables=_f32(disab, d),
            target_idx=torch.tensor(self.target_idx, device=d))
        self._cost_params_cache = (key, params)
        return params

    def grasp_poses_world(self) -> np.ndarray:
        """Target grasp DB transformed to world (``omg/planner.py:319-322``)."""
        t = self.target
        if t.attached:
            return t.pose_mat[None] @ np.linalg.inv(t.rel_hand_pose)[None]
        return t.pose_mat[None] @ t.grasps_poses


class PointEnv(Env):
    """Perception-mode environment: one SDF built from an observed point
    cloud (reference ``PointEnv``, ``omg/core.py:413-457``)."""

    def compute_sdf_from_points(self, points: np.ndarray,
                                resolution: float = 0.02,
                                margin: float = 0.24):
        from ..ops.pointsdf import sdf_from_points

        sdf = sdf_from_points(points, resolution=resolution, margin=margin,
                              device=self.device)
        obj = SceneObject("env_points", sdf, np.eye(4), target=True,
                          compute_grasp=False)
        self.objects = [obj]
        self.target_idx = 0
        self._scene_sdf = None
        self.version += 1


def goal_set_batch(model, cfg: OMGConfig, scene, params: CostParams, poses,
                   valid, n_grasps, start, gens, obj_pos,
                   attached: bool = False, z_up: bool = False,
                   y_up: bool = False):
    """The goal sets of a wave of scenes in one batched build (the JAX
    package's vmapped ``_goal_set_batch_fn``): the z/y upsampling with the
    grasp mask repeated by the bins, then
    :func:`goal_set.build_goal_set_batch`.  ``scene``, ``params``, ``poses
    [S, N, 4, 4]``, ``valid [S, N]``, ``start [S, D]`` and ``obj_pos [S,
    3]`` are stacked, ``n_grasps`` and ``gens`` one per scene.  Returns
    the goal sets [S, ...]."""
    n_scenes = poses.shape[0]
    if z_up:
        bins = 50
        poses = torch.func.vmap(
            lambda p, o: gs.z_upsample_poses(p, o, bins=bins))(poses, obj_pos)
        valid = valid.repeat_interleave(bins, dim=1)
        n_grasps = [n * bins for n in n_grasps]
    if y_up:
        bins = 10
        poses = gs.y_upsample_poses(poses.reshape(-1, 4, 4), bins=bins)
        poses = poses.reshape(n_scenes, -1, 4, 4)
        valid = valid.repeat_interleave(bins, dim=1)
        n_grasps = [n * bins for n in n_grasps]
    return gs.build_goal_set_batch(
        model, cfg, scene, params, poses, valid, n_grasps, start, gens=gens,
        attached=attached, obj_pos=obj_pos)


class PlanningScene:
    """Owner of an Env and its plans (reference ``PlanningScene``,
    ``omg/core.py:459-779``, minus the renderer)."""

    def __init__(self, cfg: OMGConfig, env: Env | None = None,
                 seed: int = 233, device=None):
        self.cfg = cfg
        if env is None:
            # use_point_sdf selects the perception-mode environment
            env = (PointEnv(cfg, device=device) if cfg.use_point_sdf
                   else Env(cfg, device=device))
        elif device is not None and resolve_device(device) != env.device:
            raise ValueError(f"env is on {env.device}, not {device}")
        self.env = env
        self.device = env.device
        self.model = env.model
        self.start = np.array(DEFAULT_START)
        self.end = np.array(DEFAULT_END)
        self.gen = torch.Generator().manual_seed(seed)
        self.history_trajectories: list = []
        self.info = None
        self.goal_set: GoalSet | None = None
        # external grasp poses (world panda_hand frames) override the grasp
        # DB (reference ``load_goal_from_external``, planner.py:176-186)
        self.external_grasps: np.ndarray | None = None
        self._precomputed_goals: GoalSet | None = None
        # (key, goal set, valid-goal count or None); key = (env version,
        # start, cfg.jit_key())
        self._staged = None
        # consume-once marker: the pipelined runner keeps a staged goal set
        # it finds marked instead of rebuilding it (and clears the mark)
        self._staged_fresh = False
        self._wp_cache = None
        self._wf_cache = None
        self._n_valid_goals = 0
        # host syncs of the last staging + plan of the pipelined runner
        self.dispatch_syncs = 0

    @classmethod
    def _from_objects(cls, cfg, objects, target, device):
        env = Env(cfg, device=device)
        for o in objects:
            env.add_object(o)
        env.set_target(target)
        return cls(cfg, env)

    @classmethod
    def synthetic(cls, cfg: OMGConfig, scene_id: int = 0, device=None, **kw):
        objects, target = synthetic_tabletop_scene(scene_id, **kw)
        return cls._from_objects(cfg, objects, target, device)

    @classmethod
    def hard(cls, cfg: OMGConfig, scene_id: int = 0, device=None, **kw):
        """Difficulty-calibrated scene (clutter/shelf/far families with
        settle-and-reject placement; ``io/scene_gen.py``)."""
        from ..io.scene_gen import synthetic_hard_scene
        objects, target = synthetic_hard_scene(scene_id, **kw)
        return cls._from_objects(cfg, objects, target, device)

    @classmethod
    def from_npz(cls, cfg: OMGConfig, path: str, device=None):
        """Scene from a pinned ``.npz`` artifact (``data/suite_v2/``)."""
        from ..io.scene_io import load_npz_scene, objects_from_npz
        objects, target = objects_from_npz(load_npz_scene(path))
        return cls._from_objects(cfg, objects, target, device)

    def set_precomputed_goals(self, goals: np.ndarray,
                              reach_grasps: np.ndarray | None = None):
        """Use precomputed goal configurations instead of grasp-DB IK
        (reference ``load_goal_from_scene``, ``omg/planner.py:155-174``)."""
        g = self.cfg.goal_set_max_num
        n = min(len(goals), g)
        dof = model_api.dof(self.model)
        grasps = np.zeros((g, dof), np.float32)
        grasps[:n] = goals[:n]
        if reach_grasps is None:
            tails = np.repeat(grasps[:, None, :],
                              self.cfg.reach_tail_length, axis=1)
        else:
            tails = np.zeros((g, self.cfg.reach_tail_length, dof),
                             np.float32)
            tails[:n] = reach_grasps[:n]
        mask = np.zeros(g, bool)
        mask[:n] = True
        d = self.device
        self._precomputed_goals = GoalSet(
            grasps=_f32(grasps, d), reach_grasps=_f32(tails, d),
            mask=torch.as_tensor(mask, device=d),
            potentials=torch.zeros(g, device=d))

    def _sync_env_cfg(self):
        """Env staging must see the planning scene's cfg.  The staged
        collision scene is dropped only when a device-relevant field
        changed (``jit_key``): a value-equal cfg, or one that differs in a
        host-only field, re-stages nothing."""
        if self.env.cfg is not self.cfg:
            invalidate = self.env.cfg.jit_key() != self.cfg.jit_key()
            self.env.cfg = self.cfg
            if invalidate:
                self.env._scene_sdf = None

    # -- staging ----------------------------------------------------------
    def build_goal_set(self) -> GoalSet:
        """Goal-set construction for the target (or the external grasps)."""
        self._sync_env_cfg()
        cfg = self.cfg
        env = self.env
        t = env.target
        d = self.device
        poses = (np.asarray(self.external_grasps)
                 if self.external_grasps is not None
                 else env.grasp_poses_world())
        t0 = time.time()
        poses = _f32(poses, d)
        obj_pos = _f32(t.pose_mat[:3, 3], d)
        if t.attached and cfg.z_upsample:
            poses = gs.z_upsample_poses(poses, obj_pos)
        if cfg.y_upsample and not t.attached:
            poses = gs.y_upsample_poses(poses)
        valid = torch.ones(poses.shape[0], dtype=torch.bool, device=d)
        goal_set = gs.build_goal_set(
            self.model, cfg, env.scene_sdf(), env.cost_params(), poses,
            valid, _f32(self.start, d), gen=self.gen,
            attached=bool(t.attached), obj_pos=obj_pos)
        if not cfg.silent:
            n_valid = host_int(goal_set.mask.sum(), "goal_set.n_valid")
            print(f"{t.name} IK init time: {time.time() - t0:.3f}, "
                  f"goal set num: {n_valid}")
            if n_valid == 0:
                print(f"{t.name} IK FAIL")
        return goal_set

    def _staged_key(self):
        return (self.env.version, tuple(self.start), self.cfg.jit_key())

    def has_staged(self) -> bool:
        """True when the staged goal set matches the current (env version,
        start, cfg): a repeat request re-plans off it with no staging."""
        return self._staged is not None and \
            self._staged[0] == self._staged_key()

    def build_problem(self, goal_set: GoalSet | None = None,
                      assume_goals: bool = False) -> plan_mod.PlanProblem:
        """Stage the plan problem: goal set (cached per env version, start
        and ``cfg.jit_key()``), initial goal and spline, limits, learner
        field.

        ``assume_goals=True`` skips the host read of the valid-goal count
        (the empty-goal-set check), so a caller can queue many scenes'
        staging and plans; the caller then checks ``goal_set.mask``."""
        with timing.span("goal_set"):
            self._sync_env_cfg()
            cfg = self.cfg
            d = self.device
            start = _f32(self.start, d)
            end = _f32(self.end, d)
            n_valid = None
            if cfg.goal_set_proj:
                if goal_set is None:
                    goal_set = self._precomputed_goals
                if goal_set is None:
                    if self.has_staged():
                        _, goal_set, n_valid = self._staged
                    else:
                        goal_set = self.build_goal_set()
                        self._staged = (self._staged_key(), goal_set, None)
            else:
                g, dof = cfg.goal_set_max_num, model_api.dof(self.model)
                goal_set = GoalSet(
                    grasps=torch.zeros((g, dof), device=d),
                    reach_grasps=torch.zeros(
                        (g, cfg.reach_tail_length, dof), device=d),
                    mask=torch.zeros(g, dtype=torch.bool, device=d),
                    potentials=torch.zeros(g, device=d))
            self.goal_set = goal_set
            with timing.span("goal_set.init"):
                return self._initial_problem(cfg, goal_set, start, end,
                                             n_valid, assume_goals)

    def _initial_problem(self, cfg, goal_set, start, end, n_valid,
                         assume_goals) -> plan_mod.PlanProblem:
        """:meth:`build_problem` past the goal set: the valid-goal count
        (unless ``assume_goals``), the initial goal and spline, the
        limits and the learner's field."""
        if assume_goals and cfg.goal_set_proj:
            self._n_valid_goals = -1  # unknown: the caller checks the mask
        else:
            if n_valid is None:
                n_valid = host_int(goal_set.mask.sum(),
                                   "build_problem.n_valid")
                if (self._staged is not None
                        and self._staged[1] is goal_set):
                    self._staged = self._staged[:2] + (n_valid,)
            self._n_valid_goals = n_valid
        if cfg.goal_set_proj and self._n_valid_goals != 0:
            end = goal_set.grasps[gs.goal_idx_policy(cfg, goal_set, start)]
            if cfg.dynamic_timestep:
                t_dyn = cfg.dynamic_timesteps(self.start,
                                              end.cpu().numpy())
                if t_dyn != cfg.timesteps:
                    cfg = cfg.replace(timesteps=t_dyn)
                    self.cfg = cfg
        traj0 = plan_mod.init_trajectory(cfg, start, end)
        lo, hi = self.model.soft_limits(cfg.soft_joint_limit_padding)
        env = self.env
        return plan_mod.PlanProblem(
            start=start, end=end, traj_init=traj0, goal_set=goal_set,
            scene=env.scene_sdf(), cost_params=env.cost_params(),
            joint_lower=lo, joint_upper=hi,
            world_potential=self._world_potential(),
            world_field=self._world_field())

    def _world_field(self) -> WorldField | None:
        """The fused CHOMP field of ``cfg.sdf_fused``, cached per (env
        version, ``cfg.jit_key()``); None when the flag is off and on an
        analytic scene (the grid-free query is exact there).  Primitive
        scenes bake the true SDF at the world cells (``snap=False``);
        data-backed ones read the baked stack at the nearest cell."""
        cfg = self.cfg
        if not cfg.sdf_fused:
            return None
        scene = self.env.scene_sdf()
        if isinstance(scene, AnalyticScene):
            return None
        key = (self.env.version, cfg.jit_key())
        if self._wf_cache is not None and self._wf_cache[0] == key:
            return self._wf_cache[1]
        params = self.env.cost_params()
        prims = analytic_prim_arrays([o.sdf for o in self.env.objects])
        if prims is not None:
            kinds, halfs, pens, _, _, dims_act, limits, _ = prims

            def t(a):
                return torch.as_tensor(a, device=self.device)

            wf = bake_world_field_analytic(
                t(kinds), t(halfs), t(pens), t(limits), params.inv_poses,
                params.epsilons, params.padding_scales, params.clearances,
                params.disables, t(dims_act),
                resolution=cfg.world_field_resolution, snap=False)
        else:
            wf = bake_world_field(
                bake_scene(scene), params.inv_poses, params.epsilons,
                params.padding_scales, params.clearances, params.disables,
                resolution=cfg.world_field_resolution)
        self._wf_cache = (key, wf)
        return wf

    def _world_potential(self) -> WorldPotential:
        """Scene-fused learner scoring field, cached per (env version,
        ``cfg.jit_key()``); a 1-cell dummy for analytic scenes (the learner
        queries the true SDF there) and when the field is off.  Under
        ``sdf_fused`` it is a view of the fused field's potential channel
        (one bake serves both); otherwise a primitive scene on the grid
        backend bakes it from the true primitive SDF."""
        cfg = self.cfg
        scene = self.env.scene_sdf()
        d = self.device
        if isinstance(scene, AnalyticScene) or not (
                cfg.learner_world_potential and cfg.goal_set_proj):
            return WorldPotential(data=torch.zeros((2, 2, 2), device=d),
                                  origin=torch.zeros(3, device=d),
                                  delta=torch.tensor(1.0, device=d))
        if cfg.sdf_fused:
            wf = self._world_field()
            return WorldPotential(data=wf.data5[..., 0], origin=wf.origin,
                                  delta=wf.delta)
        key = (self.env.version, cfg.jit_key())
        if self._wp_cache is not None and self._wp_cache[0] == key:
            return self._wp_cache[1]
        params = self.env.cost_params()
        prims = analytic_prim_arrays([o.sdf for o in self.env.objects])
        if prims is not None:
            kinds, halfs, pens, _, _, dims_act, limits, _ = prims

            def t(a):
                return torch.as_tensor(a, device=d)

            wp = bake_world_potential_analytic(
                t(kinds), t(halfs), t(pens), t(limits), params.inv_poses,
                params.epsilons, params.padding_scales, params.disables,
                t(dims_act), resolution=cfg.world_potential_resolution,
                snap=False)
        else:
            wp = bake_world_potential(
                scene, params.inv_poses, params.epsilons,
                params.padding_scales, params.clearances, params.disables,
                resolution=cfg.world_potential_resolution)
        self._wp_cache = (key, wp)
        return wp

    # -- planning ---------------------------------------------------------
    def plan_fresh(self):
        """Fresh-scene path of the planning service: the goal-set build,
        the initial goal and spline, and the early-termination plan in one
        call, with no host read of the valid-goal count (the JAX package's
        one-dispatch ``_plan_fresh_fn``).  Fills the staged cache so the
        next request takes the repeat path.  Returns ``(result,
        goal_mask)`` as device tensors (the caller harvests and checks the
        mask for an empty goal set), or None where the general path is
        needed: a dynamic horizon, goal-set projection off, precomputed
        goals or external grasps."""
        self._sync_env_cfg()
        cfg = self.cfg
        if (cfg.dynamic_timestep or not cfg.goal_set_proj
                or self._precomputed_goals is not None
                or self.external_grasps is not None):
            return None
        self._staged = None
        problem = self.build_problem(assume_goals=True)
        timing.mark("plan_fresh.plan")
        res = plan_mod.plan_fast(self.model, cfg, problem)
        return res, problem.goal_set.mask

    def step(self, fast: bool = False, traj_init: np.ndarray | None = None,
             goal_mask: np.ndarray | None = None):
        """One full plan (reference ``PlanningScene.step``,
        ``omg/core.py:694-699``).  Returns the :class:`PlanResult` as numpy
        arrays, or None when the goal set is empty.

        ``traj_init`` warm-starts from a given [T, 9] trajectory;
        ``goal_mask`` overrides the goal set's validity mask."""
        problem = self.build_problem()
        cfg = self.cfg
        if traj_init is not None:
            cfg = cfg.replace(warm_start_init=True)
            ti = _f32(traj_init, self.device)
            problem = problem._replace(traj_init=ti, end=ti[-1])
        n_valid = self._n_valid_goals
        if goal_mask is not None:
            gm = np.asarray(goal_mask, bool)
            problem = problem._replace(goal_set=problem.goal_set._replace(
                mask=torch.as_tensor(gm, device=self.device)))
            n_valid = int(gm.sum())
        if cfg.goal_set_proj and n_valid == 0:
            if not cfg.silent:
                print("planning not run... (empty goal set)")
            return None
        if cfg.report_time:
            print(f"goal set num: {n_valid}")
        t0 = time.time()
        fn = plan_mod.plan_fast if fast else plan_mod.plan
        result = fn(self.model, cfg, problem)
        result = type(result)(*(
            None if x is None else
            type(x)(*(f.cpu().numpy() for f in x)) if isinstance(x, tuple)
            else x.cpu().numpy() for x in result))
        if not self.cfg.silent:
            verdict = ("SUCCESS BE GENTLE" if bool(result.flag)
                       else "FAIL DONT EXECUTE")
            print(f"planning time: {time.time() - t0:.3f} PLAN {verdict} "
                  f"Length: {len(result.traj)}")
        self.history_trajectories = list(result.history)
        self.info = result
        if self.cfg.report_cost and result.info_history is not None:
            self.report_cost(result)
        return result

    def report_cost(self, result):
        """Per-iteration cost table (reference ``Optimizer.report``,
        ``omg/optimizer.py:23-57``) from the host copy of
        ``result.info_history``."""
        ih = result.info_history
        steps = int(result.steps_used)
        for t in range(min(steps, len(np.atleast_1d(ih.cost)))):
            print(
                f"step {t:3d} | obs {float(ih.obs[t]):8.3f} "
                f"smooth {float(ih.smooth[t]):8.3f} "
                f"cost {float(ih.cost[t]):8.3f} | "
                f"grad {float(ih.grad_norm[t]):7.3f} "
                f"collide {float(ih.collide[t]):4.0f} "
                f"reach {float(ih.reach[t]):6.4f} "
                f"violate {bool(ih.violate_limit[t])}")

    # -- attachment API for pick-and-place (trial.py:68-185) --------------
    def attach_target(self, hand_q: np.ndarray):
        """Attach the target to the hand at configuration ``hand_q``."""
        hand = model_api.tip_pose(self.model, _f32(hand_q, self.device))
        t = self.env.target
        t.rel_hand_pose = np.linalg.inv(hand.cpu().numpy()) @ t.pose_mat
        t.attached = True
        self.env._scene_sdf = None
        self.env.version += 1

    def detach_target(self):
        self.env.target.attached = False
        self.env.target.rel_hand_pose = None
        self.env._scene_sdf = None
        self.env.version += 1
