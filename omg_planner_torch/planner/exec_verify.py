"""Execution-verified planning: simulate the lift, steer off bad goals
(counterpart of ``omg_planner_tpu/planner/exec_verify.py``, where the
diagnosis behind it is recorded).

The suite's goal candidates can look identical relative to the target
while one lifts and the other squirts out of the closing grip; what
separates them is the simulated rollout itself.  :func:`plan_execute_verified`
plans, executes, and on a failed lift blacklists the converged goal's
joint-space neighbourhood (``planner/cascade.py::goal_blacklist``) and
re-plans — a mask change on the staged problem, nothing re-staged.  The
reference's counterpart is the demonstration filter
(``bullet/gen_data.py:153-166`` keeps only rew > 0 rollouts): it discards
failures; this retries them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .cascade import BACKENDS, goal_blacklist, plan_cascade


class ExecVerifiedOut(NamedTuple):
    result: object          # PlanResult of the chosen attempt
    report: object          # PhysExecReport of that attempt (None: no exec)
    exec_attempts: int      # executions run here (a seeded failure excluded)
    verified: bool          # True iff the returned plan's lift reward == 1
    reason: str = ""        # why report is None ("plan failed" /
    #                         "no mass model"); empty otherwise


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _exec_rank(rep) -> tuple:
    """Order failed executions: closer to the hand, then higher lift."""
    return (float(rep.hand_dist_m), -float(rep.lifted_m))


def plan_execute_verified(scene, exec_retries: int = 2, fast: bool = True,
                          cascade: bool = False, plan_retries: int = 3,
                          seed=None, **exec_kw) -> ExecVerifiedOut | None:
    """Plan ``scene``, execute the plan, and re-plan with the failed
    goal's neighbourhood blacklisted until the simulated lift succeeds (up
    to ``exec_retries`` re-plans).

    ``cascade=True`` recovers plan-level failures with the backend cascade
    first; when the recovery came from another collision backend, the retry
    loop runs under that backend's config (goal indices and masks only
    align with the goal set they were built from) and the session config is
    restored on exit.  ``seed=(result, report)`` hands in an attempt the
    caller already executed and saw fail: the loop starts from its
    blacklist, and ``exec_attempts`` counts only executions run here.

    Returns None when no plan exists at all (IK-FAIL refusal), otherwise
    the first verified attempt or the least-bad execution by (hand
    distance, lift height).  ``exec_kw`` goes to
    :func:`omg_planner_torch.physics.execute_plan`."""
    base_cfg = getattr(scene, "cfg", None)
    try:
        return _verified_loop(scene, exec_retries, fast, cascade,
                              plan_retries, seed, exec_kw)
    finally:
        if base_cfg is not None and scene.cfg is not base_cfg:
            scene.cfg = base_cfg
            scene._sync_env_cfg()


def _verified_loop(scene, exec_retries, fast, cascade, plan_retries,
                   seed, exec_kw):
    from .. import physics

    pre_rep = None
    if seed is not None:
        res, pre_rep = seed
    else:
        res = scene.step(fast=fast)
    if (res is None or not bool(np.asarray(res.flag))) and cascade:
        cr = plan_cascade(scene, fast=fast)
        if cr is not None:
            res = cr.result
            over = BACKENDS.get(getattr(cr, "backend", None), {})
            if any(getattr(scene.cfg, k) != v for k, v in over.items()):
                # pin the recovering backend for the whole retry loop: its
                # goal set is the one res.goal_idx and goal_mask index
                scene.cfg = scene.cfg.replace(**over)
                scene._sync_env_cfg()
    if res is None:
        return None
    if not bool(np.asarray(res.flag)):
        return ExecVerifiedOut(res, None, 0, False, "plan failed")

    best = None
    n_exec = 0
    mask = np.array(_host(res.goal_mask if res.goal_mask is not None
                          else scene.goal_set.mask), bool)
    for attempt in range(exec_retries + 1):
        if attempt == 0 and pre_rep is not None:
            rep = pre_rep          # the caller already rolled this one out
        else:
            try:
                rep = physics.execute_plan(scene, np.asarray(res.traj),
                                           **exec_kw)
            except physics.NoMassModelError:
                # no mass model: execution can neither verify nor refute
                return ExecVerifiedOut(res, None, n_exec, False,
                                       "no mass model")
            n_exec += 1
        if rep.reward == 1:
            return ExecVerifiedOut(res, rep, n_exec, True)
        if best is None or _exec_rank(rep) < _exec_rank(best.report):
            best = ExecVerifiedOut(res, rep, 0, False)
        if attempt == exec_retries:
            break
        mask = goal_blacklist(scene.goal_set, mask, int(res.goal_idx))
        # re-plan, steering past plan-level failures too (a blacklist retry
        # can land on a colliding goal: blacklist it as well)
        res2 = None
        for _ in range(plan_retries):
            if not mask.any():
                break
            cand = scene.step(fast=fast, goal_mask=mask)
            if cand is None:
                break
            if cand.goal_mask is not None:
                mask &= _host(cand.goal_mask).astype(bool)
            if bool(np.asarray(cand.flag)):
                res2 = cand
                break
            mask = goal_blacklist(scene.goal_set, mask,
                                  int(cand.goal_idx))
        if res2 is None:
            break  # no alternative plan: keep the least-bad execution
        res = res2
    return best._replace(exec_attempts=n_exec)
