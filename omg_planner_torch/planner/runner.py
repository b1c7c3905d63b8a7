"""Resumable suite runner and the pipelined executor (counterpart of
``omg_planner_tpu/planner/runner.py``).

:func:`plan_pipelined` is the production path of a suite: ``SuiteRunner``
and ``bench_torch.py`` go through it.  :class:`SuiteRunner` persists a
manifest (which scenes are done) and one ``.npz`` result shard per scene,
with the execution-validation grade of ``planner/validate.py`` beside the
planner's verdict.

A plan result travels to the host as ONE flat float32 buffer in the JAX
package's layout (trajectory, cost trajectory, the scalars of
``_SCALAR_FIELDS`` then goal index, steps and flag, then the goal-set mask
and the plan's final mask), so the JAX ``_unpack_flat`` reads a buffer the
port packed.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from ..config import OMGConfig
from ..io import scene_io
from ..ops.chomp import CostInfo
from ..parallel.batch import pad_objects
from ..utils import timing
from ..utils.sync import SYNCS
from ..utils.timing import TRANSIENT, retry_transient
from .plan import PlanResult, plan_fast

#: CostInfo scalar fields in pack order (floats then bools), followed by
#: the PlanResult's own scalars.  See _pack/_unpack_result.
_SCALAR_FIELDS = (
    "cost", "obs", "smooth", "weighted_obs", "weighted_smooth",
    "grad_norm", "smooth_grad_norm", "obs_grad_norm", "collide", "reach",
    "terminate", "failure_terminate", "execute", "violate_limit")

_N_SCALARS = len(_SCALAR_FIELDS) + 3


def _pack(res: PlanResult, mask: torch.Tensor) -> torch.Tensor:
    """A plan result and its goal-set mask as one flat float32 tensor on
    the result's device."""
    info = res.info
    scalars = torch.stack(
        [getattr(info, f).to(torch.float32).reshape(()) for f in _SCALAR_FIELDS]
        + [res.goal_idx.to(torch.float32).reshape(()),
           res.steps_used.to(torch.float32).reshape(()),
           res.flag.to(torch.float32).reshape(())])
    masks = torch.stack(
        [mask, mask if res.goal_mask is None else res.goal_mask])
    return torch.cat([
        res.traj.reshape(-1).to(torch.float32),
        info.cost_traj.reshape(-1).to(torch.float32),
        scalars, masks.reshape(-1).to(torch.float32)])


def _unpack_flat(flat, traj_shape, ct_shape, g):
    """Slice the packed buffer back into (traj, cost_traj, scalars,
    masks) and rebuild the result (shapes recorded at dispatch)."""
    flat = np.asarray(flat)
    nt = int(np.prod(traj_shape))
    nc = int(np.prod(ct_shape))
    traj = flat[:nt].reshape(traj_shape)
    cost_traj = flat[nt:nt + nc].reshape(ct_shape)
    scalars = flat[nt + nc:nt + nc + _N_SCALARS]
    masks = flat[nt + nc + _N_SCALARS:].reshape(2, g) > 0.5
    return _unpack_result(traj, cost_traj, scalars, masks)


def _unpack_result(traj, cost_traj, scalars, masks):
    """Rebuild the numpy-mapped (PlanResult, n_valid) a harvest returns."""
    floats = [np.float32(scalars[i]) for i in range(10)]
    bools = [bool(scalars[10 + i]) for i in range(4)]
    info = CostInfo(*floats, *bools, cost_traj=cost_traj)
    goal_idx = np.int32(scalars[14])
    steps = np.int32(scalars[15])
    flag = bool(scalars[16])
    res = PlanResult(
        traj=traj, goal_idx=goal_idx, info=info, info_history=info,
        history=traj[None], selected_goals=np.asarray([goal_idx]),
        steps_used=steps, flag=flag, goal_mask=masks[1])
    return res, int(masks[0].sum())


class PackedResult:
    """A plan result on its way to the host: the packed buffer, the copy's
    completion event (None on the CPU) and the shapes to unpack with."""

    def __init__(self, res: PlanResult, mask: torch.Tensor):
        packed = _pack(res, mask)
        self.shapes = (tuple(res.traj.shape), tuple(res.info.cost_traj.shape),
                       mask.shape[0])
        if packed.device.type == "cuda":
            # queue the copy into pinned memory behind the plan's own work;
            # the event marks its end
            self.host = torch.empty(packed.shape, dtype=packed.dtype,
                                    pin_memory=True)
            self.host.copy_(packed, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = packed, None

    def result(self):
        """(numpy PlanResult, valid-goal count); waits for the copy."""
        with timing.span("harvest"):
            if self.event is not None:
                self.event.synchronize()
            return _unpack_flat(self.host.numpy(), *self.shapes)


def suite_shapes(scenes):
    """(pad_to, max_obj) over (sid, PlanningScene) pairs: the largest
    per-axis field shape and the largest object count, so every scene of
    a suite stages and plans at one set of shapes."""
    shapes = np.array([o.sdf.shape for _, s in scenes
                       for o in s.env.objects])
    pad_to = tuple(int(v) for v in shapes.max(axis=0)) if len(shapes) \
        else None
    return pad_to, max(len(s.env.objects) for _, s in scenes)


def prebuild_goal_sets(scenes, cfg: OMGConfig, model, batch: int,
                       max_obj: int):
    """Build the goal sets of (sid, PlanningScene) pairs in waves of
    ``batch`` scenes, each wave one batched build
    (``scene.goal_set_batch``), and stage them: each scene's ``_staged``
    cache holds its goal set and its consume-once ``_staged_fresh``
    marker is set, so the pipelined runner's dispatch plans off it instead
    of rebuilding.  Each scene's goal set equals its own build's, its
    generator drawn as that build draws it.

    Eligible are the scenes with ``cfg``'s ``jit_key``, goal-set
    projection, a fixed horizon, the grasp database (no precomputed goals,
    no external grasps), a target not attached and an analytic collision
    scene, and only when there are at least two; the others stage per
    scene as before.  The collision scenes pad to ``max_obj`` objects, the
    grasp databases to the wave's largest.  (The JAX package pads its
    tail wave by repeating the last scene to share one compiled program;
    with no program to share, the tail wave here is just shorter.)"""
    from ..ops.sdf import AnalyticScene
    from ..parallel.batch import _pad_cost_params, _stack, pad_scene
    from .scene import _f32, goal_set_batch

    canon = cfg.jit_key()
    elig = []
    for _, sc in scenes:
        sc._sync_env_cfg()
        if (sc.cfg.jit_key() != canon or not sc.cfg.goal_set_proj
                or sc.cfg.dynamic_timestep
                or sc._precomputed_goals is not None
                or sc.external_grasps is not None
                or sc.env.target.attached
                or not isinstance(sc.env.scene_sdf(), AnalyticScene)):
            continue
        elig.append(sc)
    if len(elig) < 2:
        return
    dev = elig[0].device
    for lo in range(0, len(elig), batch):
        wave = elig[lo:lo + batch]
        poses = [sc.env.grasp_poses_world() for sc in wave]
        max_g = max(len(p) for p in poses)
        pp = np.tile(np.eye(4, dtype=np.float32), (len(wave), max_g, 1, 1))
        va = np.zeros((len(wave), max_g), bool)
        for i, p in enumerate(poses):
            pp[i, :len(p)] = p
            va[i, :len(p)] = True
        goal_sets = goal_set_batch(
            model, cfg,
            _stack([pad_scene(sc.env.scene_sdf(), max_obj) for sc in wave]),
            _stack([_pad_cost_params(sc.env.cost_params(),
                                     max_obj - len(sc.env.objects))
                    for sc in wave]),
            _f32(pp, dev), torch.as_tensor(va, device=dev),
            [len(p) for p in poses], _f32([sc.start for sc in wave], dev),
            [sc.gen for sc in wave],
            _f32([sc.env.target.pose_mat[:3, 3] for sc in wave], dev),
            y_up=bool(cfg.y_upsample))
        for i, sc in enumerate(wave):
            gset = type(goal_sets)(*(a[i] for a in goal_sets))
            sc._staged = (sc._staged_key(), gset, None)
            sc._staged_fresh = True


def plan_pipelined(scenes, cfg: OMGConfig, model=None, depth: int = 4,
                   pad_to=None, max_obj: int | None = None,
                   build_batch: int = 0):
    """Pipelined suite execution: up to ``depth`` scenes' staging + plan
    dispatched ahead of the harvest point.

    ``scenes``: iterable of (sid, PlanningScene), all on one device.
    Yields ``(sid, scene, result-or-None, wall_s)`` in order; ``result``
    is the numpy-mapped PlanResult, ``None`` = empty goal set (the
    reference's IK-FAIL "planning not run" path).  ``wall_s`` is
    dispatch->ready; ``scene.dispatch_syncs`` counts the host syncs of the
    scene's staging and plan.  ``depth`` bounds device memory to O(depth) staged
    scenes: each harvested scene drops its collision scene.  A failed
    harvest re-runs that scene once, serially, through
    ``utils.timing.retry_transient``, and a second failure raises.

    What overlaps in eager PyTorch: ``dispatch`` packs each result into one
    flat tensor and queues its copy into pinned host memory behind the
    plan, with an event that ``harvest`` waits on.  But the plan loop reads
    its termination flag on the host every step (6 to 147 host syncs per
    plan on suite scenes 0-2, ``PERF.md`` section 5), so the host cannot
    run ahead of the device inside a plan: only the final copy and the
    host work queued after a plan's last read overlap the device.
    ``pipelined_plans_per_s`` is therefore expected within about 10% of
    ``serial_e2e_plans_per_s``.  No extra threads or streams force more
    overlap than the JAX package has; that is the work of CUDA graphs.

    ``build_batch`` > 1 first builds the goal sets of the eligible scenes
    in waves of that many (:func:`prebuild_goal_sets`); the plans still
    run one scene after another.
    """
    scenes = list(scenes)
    if scenes:
        default_pad, default_obj = suite_shapes(scenes)
        pad_to = default_pad if pad_to is None else pad_to
        max_obj = default_obj if max_obj is None else max_obj
        if model is None:
            model = scenes[0][1].model
        if build_batch > 1:
            prebuild_goal_sets(scenes, cfg, model, build_batch, max_obj)

    def dispatch(sc):
        t0, s0 = time.time(), SYNCS.count
        if sc._staged_fresh:
            sc._staged_fresh = False  # consumed; a retry rebuilds
        else:
            sc._staged = None
        sc._sync_env_cfg()
        sc.env.stage_scene(pad_to)
        # assume_goals: the empty-goal-set check is deferred to harvest
        problem = pad_objects(sc.build_problem(assume_goals=True), max_obj)
        res = plan_fast(model, sc.cfg, problem)
        sc.dispatch_syncs = SYNCS.count - s0
        return PackedResult(res, problem.goal_set.mask), t0

    def harvest(sid, sc, handle):
        packed, t0 = handle
        try:
            res, n_valid = packed.result()
        except (RuntimeError, *TRANSIENT):
            def rerun():
                return dispatch(sc)[0].result()

            res, n_valid = retry_transient(rerun, f"pipelined scene {sid}")
        sc.env._scene_sdf = None  # device memory: O(depth) staged scenes
        if sc.cfg.goal_set_proj and n_valid == 0:
            return None, time.time() - t0
        return res, time.time() - t0

    window: list = []
    for sid, sc in scenes:
        window.append((sid, sc, dispatch(sc)))
        if len(window) > depth:
            s0, sc0, h0 = window.pop(0)
            yield (s0, sc0) + harvest(s0, sc0, h0)
    for s0, sc0, h0 in window:
        yield (s0, sc0) + harvest(s0, sc0, h0)


class SuiteRunner:
    def __init__(self, out_dir: str, cfg: OMGConfig | None = None,
                 n_obstacles: int = 3, scene_source: str = "synthetic",
                 suite_dir: str | None = None, validate: bool = True,
                 device=None):
        """``scene_source``: "synthetic" | "hard" | "npz" (pinned suite in
        ``suite_dir``).  Scenes run on ``device`` (``cuda`` unless named)."""
        from .. import resolve_device

        self.out_dir = out_dir
        self.cfg = cfg or OMGConfig(silent=True)
        self.n_obstacles = n_obstacles
        self.scene_source = scene_source
        self.suite_dir = suite_dir
        self.validate = validate
        self.device = resolve_device(device)
        os.makedirs(out_dir, exist_ok=True)
        self.manifest_path = os.path.join(out_dir, "manifest.json")
        self.manifest = self._load_manifest()

    def _load_manifest(self) -> dict:
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as f:
                return json.load(f)
        return {"done": {}, "config": repr(self.cfg),
                "source": self.scene_source}

    def _save_manifest(self):
        with open(self.manifest_path, "w") as f:
            json.dump(self.manifest, f, indent=1)

    def pending(self, scene_ids) -> list:
        return [s for s in scene_ids if str(s) not in self.manifest["done"]]

    def _make_scene(self, sid: int):
        from .scene import PlanningScene

        if self.scene_source == "hard":
            return PlanningScene.hard(self.cfg, scene_id=int(sid),
                                      device=self.device)
        if self.scene_source == "npz":
            return PlanningScene.from_npz(
                self.cfg, os.path.join(self.suite_dir, f"scene_{sid}.npz"),
                device=self.device)
        return PlanningScene.synthetic(
            self.cfg, scene_id=int(sid), n_obstacles=self.n_obstacles,
            device=self.device)

    def run(self, scene_ids=range(100), pipeline_depth: int = 4) -> dict:
        """Plan all pending scenes through :func:`plan_pipelined`
        (``pipeline_depth`` in flight; 1 = strictly serial); resume-safe."""
        from .validate import validate_execution

        pending = self.pending(scene_ids)
        wins = sum(v["success"] for v in self.manifest["done"].values())
        exec_wins = sum(v.get("exec_valid", False)
                        for v in self.manifest["done"].values())

        scenes = [(sid, self._make_scene(sid)) for sid in pending]

        for sid, sc, res, dt in plan_pipelined(
                scenes, self.cfg, depth=max(1, pipeline_depth)):
            if res is None:
                rec = {"success": False, "steps": 0, "no_goals": True,
                       "exec_valid": False, "wall_s": 0.0}
                self.manifest["done"][str(sid)] = rec
                self._save_manifest()
                continue

            report = None
            if self.validate:
                report = validate_execution(sc, res.traj)
                exec_wins += report.valid
            ok = bool(res.flag)
            wins += ok
            shard_info = {
                "success": ok, "steps": int(res.steps_used),
                "collide": float(res.info.collide),
                "smooth": float(res.info.smooth),
                "reach": float(res.info.reach)}
            if report is not None:
                shard_info.update(report.to_dict())
            scene_io.save_result_shard(
                os.path.join(self.out_dir, f"scene_{sid}.npz"),
                int(sid), res.traj, shard_info)
            rec = {"success": ok, "steps": int(res.steps_used),
                   "wall_s": round(dt, 3)}
            if report is not None:
                rec["exec_valid"] = bool(report.valid)
            self.manifest["done"][str(sid)] = rec
            self._save_manifest()
            sc.env._scene_sdf = None
            if not self.cfg.silent:
                extra = (f" exec={report.valid}" if report else "")
                print(f"scene {sid}: {dt:.2f}s success={ok}{extra} "
                      f"cumulative {wins}/{len(self.manifest['done'])}")
        out = {"success": wins, "total": len(self.manifest["done"])}
        if self.validate:
            out["exec_valid"] = exec_wins
        return out
