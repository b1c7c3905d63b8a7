"""Backend escalation cascade: cheap-first planning with verdict-gated
fallback (counterpart of ``omg_planner_tpu/planner/cascade.py``, where the
policy's measurements are recorded).

Plan on the analytic backend; on a FAIL verdict, retry with the failed
goal's neighbourhood blacklisted (a pure mask change on the same staged
problem), and when the backend's retries are spent, re-stage the scene on
the exact grid backend and plan again.  The reference has no counterpart:
it plans once per scene with its one CUDA backend
(``omg/core.py:869-885``).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..config import OMGConfig
from ..parallel.batch import pad_objects, pad_scene
from .plan import plan_fast
from .runner import PackedResult, suite_shapes
from .scene import PlanningScene


class SuiteCascadeOut(NamedTuple):
    flag: bool
    backend: str
    attempts: int
    traj: np.ndarray
    goal_idx: int


#: cfg field overrides selecting each collision backend, cheapest first.
BACKENDS: dict[str, dict] = {
    "analytic": {"sdf_analytic": True, "sdf_fused": False},
    "exact": {"sdf_analytic": False, "sdf_fused": False},
    "fused": {"sdf_analytic": False, "sdf_fused": True},
}


class CascadeResult(NamedTuple):
    result: object        # PlanResult (numpy-mapped) of the chosen attempt
    backend: str          # backend that produced it
    attempts: int         # how many plans ran
    success: bool         # chosen attempt's verdict


def _fail_rank(res) -> tuple:
    """Order failed attempts: fewer colliding points, then closer to the
    goal, then lower final cost (the verdict criteria, ``omg/cost.py:
    489-494``, in severity order)."""
    info = res.info
    return (float(np.asarray(info.collide)), float(np.asarray(info.reach)),
            float(np.asarray(info.cost)))


#: joint-space L2 radius (arm joints) around a failed goal inside which
#: goals are blacklisted before a retry: the reference's goal-set dedupe
#: diversity radius (``omg/planner.py:545-560``).
BLACKLIST_RADIUS = 0.5


def goal_blacklist(goal_set, mask: np.ndarray, goal_idx: int,
                   radius: float = BLACKLIST_RADIUS) -> np.ndarray:
    """Clear ``mask`` entries within ``radius`` (arm-joint L2) of the
    failed goal.  Returns the new mask (all-False when nothing is left)."""
    grasps = torch.as_tensor(goal_set.grasps).cpu().numpy()
    failed = grasps[int(goal_idx)]
    d = np.linalg.norm(grasps[:, :7] - failed[None, :7], axis=-1)
    return mask & ~(d < radius)


def _backend_cfg(base_cfg: OMGConfig, name: str) -> OMGConfig:
    over = BACKENDS[name]
    if any(getattr(base_cfg, k) != v for k, v in over.items()):
        return base_cfg.replace(**over)
    return base_cfg


def plan_cascade(scene: PlanningScene,
                 backends: Sequence[str] = ("analytic", "exact"),
                 fast: bool = True,
                 goal_retries: int = 3,
                 budget_s: float | None = None) -> CascadeResult | None:
    """Plan ``scene`` escalating until one verdict is SUCCESS; on total
    failure return the least-bad attempt by :func:`_fail_rank`.

    Per backend: one plan from the full goal set, then up to
    ``goal_retries`` goal-blacklist retries, each masking the last FAIL's
    goal and its near-duplicates and re-planning the same staged problem.
    Backend switches go through ``scene.cfg``; the staged caches key on
    ``cfg.jit_key()``, so a backend whose fields already match the session
    cfg re-stages nothing, and the session cfg is restored afterwards.
    Returns ``None`` only if every backend refused to plan (empty goal
    set); such a refusal does not count as an attempt and moves on to the
    next backend.  Once the elapsed wall exceeds ``budget_s`` no further
    attempt launches."""
    base_cfg: OMGConfig = scene.cfg
    best = None
    attempts = 0
    t_begin = time.time()

    def over_budget():
        return budget_s is not None and time.time() - t_begin > budget_s

    try:
        for name in backends:
            if over_budget():
                break
            scene.cfg = _backend_cfg(base_cfg, name)
            res = scene.step(fast=fast)
            if res is None:  # IK FAIL on this backend's goal filtering
                continue
            attempts += 1
            if bool(np.asarray(res.flag)):
                return CascadeResult(res, name, attempts, True)
            if best is None or _fail_rank(res) < _fail_rank(best[0]):
                best = (res, name)
            # the attempt's final mask already holds the in-plan blacklist
            # rejections: the retry baseline
            mask = (np.asarray(res.goal_mask).copy()
                    if res.goal_mask is not None
                    else scene.goal_set.mask.cpu().numpy().copy())
            for _ in range(goal_retries):
                if over_budget():
                    break
                mask = goal_blacklist(scene.goal_set, mask, res.goal_idx)
                if not mask.any():
                    break
                res = scene.step(fast=fast, goal_mask=mask)
                if res is None:
                    break
                attempts += 1
                if bool(np.asarray(res.flag)):
                    return CascadeResult(res, name, attempts, True)
                if _fail_rank(res) < _fail_rank(best[0]):
                    best = (res, name)
                if res.goal_mask is not None:
                    mask &= np.asarray(res.goal_mask)
    finally:
        scene.cfg = base_cfg
        scene._sync_env_cfg()
    if best is None:
        return None
    return CascadeResult(best[0], best[1], attempts, False)


def plan_cascade_suite(scenes, base_cfg: OMGConfig,
                       backends: Sequence[str] = ("analytic", "exact"),
                       goal_retries: int = 3, chunk: int = 8,
                       model=None, pad_to=None, max_obj: int | None = None,
                       log=None):
    """Wave-ordered cascade over many scenes (the suite form of
    :func:`plan_cascade`), on the runner's pack and unpack.

    Per backend, scenes go in chunks: every pending scene of a chunk is
    staged and planned, then retry WAVES run, wave k re-planning every
    still-failing scene's k-th blacklist retry on its cached problem (a
    mask swap: no re-staging, no goal-set rebuild).  A fallback backend
    reuses the first backend's goal set with its own staged collision
    scene and learner field.  ``chunk`` bounds device memory to O(chunk)
    staged problems.

    Returns {sid: SuiteCascadeOut}.
    """
    scenes = list(scenes)
    default_pad, default_obj = suite_shapes(scenes)
    pad_to = default_pad if pad_to is None else pad_to
    max_obj = default_obj if max_obj is None else max_obj
    if model is None:
        model = scenes[0][1].model

    results: dict = {}
    attempts: dict = {sid: 0 for sid, _ in scenes}
    cached_problems: dict = {}
    pending = scenes
    try:
        for bi, name in enumerate(backends):
            t_backend = time.time()
            cfg_b = _backend_cfg(base_cfg, name)
            still_failing = []
            for lo in range(0, len(pending), chunk):
                batch = pending[lo:lo + chunk]
                probs, handles = [], []
                for sid, sc in batch:
                    sc.cfg = cfg_b
                    sc._sync_env_cfg()
                    sc._staged = None
                    sc.env.stage_scene(pad_to)
                    if bi > 0 and sid in cached_problems:
                        # IK is backend independent: swap in this backend's
                        # scene, learner field and fused field, keep the
                        # goal set
                        pr = cached_problems[sid]._replace(
                            scene=pad_scene(sc.env.scene_sdf(), max_obj),
                            world_potential=sc._world_potential(),
                            world_field=sc._world_field())
                    else:
                        pr = pad_objects(
                            sc.build_problem(assume_goals=True), max_obj)
                        cached_problems[sid] = pr
                    probs.append(pr)
                    handles.append(PackedResult(plan_fast(model, cfg_b, pr),
                                                pr.goal_set.mask))
                    attempts[sid] += 1
                masks = [None] * len(batch)
                live = list(range(len(batch)))
                for wave in range(goal_retries + 1):
                    fetched = [handles[i].result()[0] for i in live]
                    redispatch = []
                    for i, res in zip(live, fetched):
                        sid, sc = batch[i]
                        gi = int(res.goal_idx)
                        out = SuiteCascadeOut(
                            flag=bool(res.flag), backend=name,
                            attempts=attempts[sid],
                            traj=np.asarray(res.traj), goal_idx=gi)
                        if out.flag:
                            results[sid] = out
                            continue
                        # the latest failed attempt is the fallback result
                        if sid not in results or not results[sid].flag:
                            results[sid] = out
                        if wave == goal_retries:
                            redispatch.append((i, None))
                            continue
                        rm = res.goal_mask
                        masks[i] = (rm.copy() if masks[i] is None
                                    else masks[i] & rm)
                        masks[i] = goal_blacklist(
                            probs[i].goal_set, masks[i], gi)
                        redispatch.append(
                            (i, masks[i] if masks[i].any() else None))
                    live = []
                    for i, mask in redispatch:
                        sid, sc = batch[i]
                        if mask is None:
                            still_failing.append((sid, sc))
                            continue
                        gs_ = probs[i].goal_set
                        pr2 = probs[i]._replace(goal_set=gs_._replace(
                            mask=torch.as_tensor(mask,
                                                 device=gs_.mask.device)))
                        handles[i] = PackedResult(
                            plan_fast(model, cfg_b, pr2), pr2.goal_set.mask)
                        attempts[sid] += 1
                        live.append(i)
                    if not live:
                        break
                for sid, sc in batch:
                    sc.env._scene_sdf = None
            if log is not None:
                log(f"[cascade] backend={name}: {len(pending)} in, "
                    f"{len(still_failing)} still failing, "
                    f"{time.time() - t_backend:.1f}s")
            pending = still_failing
            if not pending:
                break
    finally:
        for sid, sc in scenes:
            sc.cfg = base_cfg
            sc._sync_env_cfg()
            sc.env._scene_sdf = None
    return results
