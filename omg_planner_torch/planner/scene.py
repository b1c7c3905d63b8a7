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
                         synthetic_tabletop_scene)
from ..models import panda
from ..ops.chomp import CostParams, GoalSet
from ..ops.sdf import (AnalyticScene, WorldPotential, bake_scene,
                       bake_world_potential, combine_sdfs,
                       make_analytic_scene)
from ..utils.sync import host_int
from . import goal_set as gs
from . import plan as plan_mod


def _f32(a, device) -> torch.Tensor:
    """Host array -> float32 tensor on ``device`` (host poses, extents and
    configurations are float64)."""
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


class Env:
    """Scene container (reference ``Env``, ``omg/core.py:243-411``)."""

    def __init__(self, cfg: OMGConfig, model: panda.PandaModel | None = None,
                 device=None):
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

    def set_target(self, name: str):
        self.target_idx = self.names.index(name)
        self.objects[self.target_idx].compute_grasp = True
        self.version += 1

    @property
    def names(self):
        return [o.name for o in self.objects]

    @property
    def target(self) -> SceneObject:
        return self.objects[self.target_idx]

    # -- staging ----------------------------------------------------------
    def scene_sdf(self):
        """The collision scene: an :class:`AnalyticScene` when every
        object is an analytic primitive (``cfg.sdf_analytic``), else the
        padded voxel stack with baked gradient channels."""
        if self._scene_sdf is None:
            fields = [o.sdf for o in self.objects]
            if self.cfg.sdf_analytic:
                self._scene_sdf = make_analytic_scene(fields, self.device)
            if self._scene_sdf is None:
                if all(f.analytic is not None for f in fields):
                    raise NotImplementedError(
                        "voxelized primitive scenes (sdf_analytic=False) "
                        "are not ported yet")
                if not self.cfg.sdf_baked:
                    raise NotImplementedError(
                        "the exact grid query (sdf_baked=False) is not "
                        "ported yet")
                self._scene_sdf = bake_scene(combine_sdfs(fields,
                                                          self.device))
        return self._scene_sdf

    def cost_params(self) -> CostParams:
        """Per-object collision parameters (reference
        ``Cost.compute_obstacle_cost_layer``, ``omg/cost.py:299-335``),
        cached per (env version, cfg)."""
        cfg = self.cfg
        key = (self.version, cfg)
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
        self._staged = None
        self._wp_cache = None
        self._n_valid_goals = 0

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
        grasps = np.zeros((g, 9), np.float32)
        grasps[:n] = goals[:n]
        if reach_grasps is None:
            tails = np.repeat(grasps[:, None, :],
                              self.cfg.reach_tail_length, axis=1)
        else:
            tails = np.zeros((g, self.cfg.reach_tail_length, 9), np.float32)
            tails[:n] = reach_grasps[:n]
        mask = np.zeros(g, bool)
        mask[:n] = True
        d = self.device
        self._precomputed_goals = GoalSet(
            grasps=_f32(grasps, d), reach_grasps=_f32(tails, d),
            mask=torch.as_tensor(mask, device=d),
            potentials=torch.zeros(g, device=d))

    def _sync_env_cfg(self):
        """Env staging must see the planning scene's cfg."""
        if self.env.cfg is not self.cfg:
            if self.env.cfg != self.cfg:
                self.env._scene_sdf = None
            self.env.cfg = self.cfg

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
            n_valid = host_int(goal_set.mask.sum())
            print(f"{t.name} IK init time: {time.time() - t0:.3f}, "
                  f"goal set num: {n_valid}")
            if n_valid == 0:
                print(f"{t.name} IK FAIL")
        return goal_set

    def build_problem(self) -> plan_mod.PlanProblem:
        """Stage the plan problem: goal set (cached per env version, start
        and cfg), initial goal and spline, limits, learner field."""
        self._sync_env_cfg()
        cfg = self.cfg
        env = self.env
        d = self.device
        start = _f32(self.start, d)
        end = _f32(self.end, d)
        if cfg.goal_set_proj:
            goal_set = self._precomputed_goals
            if goal_set is None:
                key = (env.version, tuple(self.start), cfg)
                if self._staged is not None and self._staged[0] == key:
                    goal_set = self._staged[1]
                else:
                    goal_set = self.build_goal_set()
                    self._staged = (key, goal_set)
        else:
            g = cfg.goal_set_max_num
            goal_set = GoalSet(
                grasps=torch.zeros((g, 9), device=d),
                reach_grasps=torch.zeros((g, cfg.reach_tail_length, 9),
                                         device=d),
                mask=torch.zeros(g, dtype=torch.bool, device=d),
                potentials=torch.zeros(g, device=d))
        self.goal_set = goal_set
        self._n_valid_goals = host_int(goal_set.mask.sum())
        if cfg.goal_set_proj and self._n_valid_goals > 0:
            end = goal_set.grasps[gs.goal_idx_policy(cfg, goal_set, start)]
            if cfg.dynamic_timestep:
                t_dyn = cfg.dynamic_timesteps(self.start,
                                              end.cpu().numpy())
                if t_dyn != cfg.timesteps:
                    cfg = cfg.replace(timesteps=t_dyn)
                    self.cfg = cfg
        traj0 = plan_mod.init_trajectory(cfg, start, end)
        lo, hi = self.model.soft_limits(cfg.soft_joint_limit_padding)
        return plan_mod.PlanProblem(
            start=start, end=end, traj_init=traj0, goal_set=goal_set,
            scene=env.scene_sdf(), cost_params=env.cost_params(),
            joint_lower=lo, joint_upper=hi,
            world_potential=self._world_potential())

    def _world_potential(self) -> WorldPotential:
        """Scene-fused learner scoring field, cached per env version; a
        1-cell dummy for analytic scenes (the learner queries the true SDF
        there) and when the field is off."""
        cfg = self.cfg
        scene = self.env.scene_sdf()
        d = self.device
        if isinstance(scene, AnalyticScene) or not (
                cfg.learner_world_potential and cfg.goal_set_proj):
            return WorldPotential(data=torch.zeros((2, 2, 2), device=d),
                                  origin=torch.zeros(3, device=d),
                                  delta=torch.tensor(1.0, device=d))
        if cfg.sdf_fused:
            raise NotImplementedError(
                "the fused world field (sdf_fused=True) is not ported yet")
        key = (self.env.version, cfg)
        if self._wp_cache is not None and self._wp_cache[0] == key:
            return self._wp_cache[1]
        params = self.env.cost_params()
        wp = bake_world_potential(
            scene, params.inv_poses, params.epsilons, params.padding_scales,
            params.clearances, params.disables,
            resolution=cfg.world_potential_resolution)
        self._wp_cache = (key, wp)
        return wp

    # -- planning ---------------------------------------------------------
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
        return result
