"""Batched damped-least-squares inverse kinematics (counterpart of
``omg_planner_tpu/ops/ik.py``).

A joint-limit-clamped damped Newton iteration solves the whole goal set
(grasps x seeds x standoff tail) at once.  The standoff chain reproduces
``solve_one_pose_ik`` (``omg/planner.py:17-86``): the farthest standoff
first from the seed, then the tail poses, each seeded by the previous
solution.  Every data-dependent loop exit (the JAX package's
``while_loop`` conditions) is read on the host once per iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import OMGConfig
from ..models import panda
from ..utils.linalg import solve_spd_unrolled, take_rows, top_k
from ..utils.pose import so3_angle, so3_log
from ..utils.sync import host_bool


class IKResult(NamedTuple):
    q: torch.Tensor        # [..., 7]
    success: torch.Tensor  # [...] bool
    pos_err: torch.Tensor
    rot_err: torch.Tensor


def _fingers(lead_shape, like):
    return torch.full(lead_shape + (2,), 0.04, dtype=like.dtype,
                      device=like.device)


def _hand_fk_and_jacobian(model: panda.PandaModel, q7: torch.Tensor):
    """panda_hand pose and its 6x7 geometric Jacobian for arm joints."""
    q9 = torch.cat([q7, _fingers((), q7)])
    poses, origins, axes = panda.forward_kinematics(
        model, q9, apply_offset=False, return_joint_info=True)
    hand = poses[7]
    p = hand[:3, 3]
    lin = torch.linalg.cross(axes[:7], p[None, :] - origins[:7], dim=-1)
    jac = torch.cat([lin, axes[:7]], dim=-1).T    # [6, 7]
    return hand, jac


def ik_single(model, target, seed, cfg: OMGConfig, lower7, upper7) -> IKResult:
    """Damped Newton IK for one pose with joint-limit clamping; exits on
    convergence (twist norm <= ``ik_pos_tol``) or ``ik_max_iters``."""
    lam = cfg.ik_damping
    eye6 = torch.eye(6, dtype=seed.dtype, device=seed.device)

    def error_and_jac(q):
        hand, jac = _hand_fk_and_jacobian(model, q)
        e_pos = target[:3, 3] - hand[:3, 3]
        e_rot = so3_log(target[:3, :3] @ hand[:3, :3].T)
        return torch.cat([e_pos, e_rot]), jac

    q, it = seed, 0
    err = torch.tensor(torch.inf, device=seed.device)
    while it < cfg.ik_max_iters and host_bool(err > cfg.ik_pos_tol):
        e, jac = error_and_jac(q)
        jjt = jac @ jac.T + lam * eye6
        dq = jac.T @ solve_spd_unrolled(jjt, e)
        q = torch.minimum(torch.maximum(q + torch.clamp(dq, -0.5, 0.5),
                                        lower7), upper7)
        err = torch.linalg.norm(e)
        it += 1
    hand, _ = _hand_fk_and_jacobian(model, q)
    pos_err = torch.linalg.norm(target[:3, 3] - hand[:3, 3])
    rot_err = torch.linalg.norm(so3_log(target[:3, :3] @ hand[:3, :3].T))
    ok = (pos_err < cfg.ik_pos_tol * 10) & (rot_err < cfg.ik_rot_tol * 10)
    return IKResult(q=q, success=ok, pos_err=pos_err, rot_err=rot_err)


def _batch_error_and_jac(model, q7, targets):
    """Errors and Jacobians for a batch: q7 [B,7], targets [B,4,4]
    -> (e [B,6], jac [B,6,7])."""
    b = q7.shape[0]
    q9 = torch.cat([q7, _fingers((b,), q7)], dim=1)
    poses, origins, axes = panda.forward_kinematics_batch(
        model, q9, return_joint_info=True, apply_offset=False)
    hand = poses[:, 7]
    p = hand[:, :3, 3]
    e_pos = targets[:, :3, 3] - p
    r_err = torch.einsum("bij,bkj->bik", targets[:, :3, :3], hand[:, :3, :3])
    e = torch.cat([e_pos, so3_log(r_err)], dim=1)
    lin = torch.linalg.cross(axes[:, :7], p[:, None, :] - origins[:, :7],
                             dim=-1)                            # [B,7,3]
    jac = torch.cat([lin, axes[:, :7]], dim=-1)                 # [B,7,6]
    return e, jac.transpose(1, 2)


def _newton_step(jac, e, q, lam, lower7, upper7):
    eye6 = torch.eye(6, dtype=q.dtype, device=q.device)
    jjt = torch.einsum("bij,bkj->bik", jac, jac) + lam * eye6
    dq = torch.einsum("bij,bi->bj", jac, solve_spd_unrolled(jjt, e))
    return torch.minimum(torch.maximum(q + torch.clamp(dq, -0.5, 0.5),
                                       lower7), upper7)


def ik_batch(model, targets, seeds, cfg: OMGConfig, lower7, upper7,
             active=None) -> IKResult:
    """Damped Newton IK over a batch in one loop, exiting when every gating
    lane converges.  ``active`` masks the exit (hopeless lanes can't hold
    the batch); a lane whose twist error hasn't improved >=15% in
    ``ik_stall_window`` iterations stops gating too (sticky)."""
    b = seeds.shape[0]
    act = (torch.ones(b, dtype=torch.bool, device=seeds.device)
           if active is None else active)
    window = cfg.ik_stall_window
    q = seeds
    err_best = torch.full((b,), torch.inf, device=seeds.device)
    stall = torch.zeros(b, dtype=torch.int32, device=seeds.device)
    gate_err = torch.tensor(torch.inf, device=seeds.device)
    it = 0
    while it < cfg.ik_max_iters and host_bool(gate_err > cfg.ik_pos_tol):
        e, jac = _batch_error_and_jac(model, q, targets)
        q = _newton_step(jac, e, q, cfg.ik_damping, lower7, upper7)
        err = torch.linalg.norm(e, dim=1)
        improved = err < 0.85 * err_best
        dropped = stall >= window  # sticky: never re-arm a dropped lane
        stall = torch.where(improved & ~dropped, torch.zeros_like(stall),
                            stall + 1)
        err_best = torch.minimum(err_best, err)
        gate = act if window == 0 else act & (stall < window)
        gate_err = torch.where(gate, err, torch.zeros_like(err)).max()
        it += 1
    e, _ = _batch_error_and_jac(model, q, targets)
    q9 = torch.cat([q, _fingers((b,), q)], dim=1)
    hand = panda.forward_kinematics_batch(model, q9, apply_offset=False)[:, 7]
    r_err = torch.einsum("bij,bkj->bik", targets[:, :3, :3], hand[:, :3, :3])
    pos_err = torch.linalg.norm(e[:, :3], dim=1)
    # angle from the trace: robust where so3_log degenerates at pi
    rot_err = so3_angle(r_err)
    ok = (pos_err < cfg.ik_pos_tol * 10) & (rot_err < cfg.ik_rot_tol * 10)
    return IKResult(q=q, success=ok, pos_err=pos_err, rot_err=rot_err)


def ik_batch_fixed(model, targets, seeds, cfg: OMGConfig, lower7, upper7,
                   iters: int):
    """Fixed-iteration damped Newton sweep (the two-stage prefilter).
    Returns (q [B, 7], post-sweep twist norm [B])."""
    q = seeds
    for _ in range(iters):
        e, jac = _batch_error_and_jac(model, q, targets)
        q = _newton_step(jac, e, q, cfg.ik_damping, lower7, upper7)
    e, _ = _batch_error_and_jac(model, q, targets)
    return q, torch.linalg.norm(e, dim=1)


def solve_standoff_chain(model, grasp_pose, standoff_poses, seed,
                         cfg: OMGConfig, lower7, upper7,
                         attached: bool = False):
    """One (grasp, seed) standoff chain (``omg/planner.py:41-77``).
    Returns (reach_traj [tail, 9], standoff_goal [9], valid)."""
    tail = standoff_poses.shape[0]
    far = ik_single(model, standoff_poses[-1], seed, cfg, lower7, upper7)
    q_prev, ok = far.q, far.success
    qs = []
    for k in range(tail):
        res = ik_single(model, standoff_poses[k], q_prev, cfg, lower7, upper7)
        ok = ok & res.success
        q_prev = res.q
        qs.append(res.q)
    qs = torch.stack(qs)
    if not attached:
        qs = qs.flip(0)  # farthest ... grasp (planner.py:65)
    diff = torch.linalg.norm(torch.diff(qs, dim=0))
    valid = ok & (diff < 2.0)
    reach_traj = torch.cat([qs, _fingers((tail,), qs)], dim=-1)
    standoff_q = qs[-1] if attached else qs[0]
    standoff_goal = torch.cat([standoff_q, _fingers((), qs)])
    return reach_traj, standoff_goal, valid


def _solve_chain_fused(model, cfg: OMGConfig, chain_tgts, seeds, lower7,
                       upper7, active):
    """The whole standoff chain as one loop with per-lane stage
    advancement: when a lane's current stage converges (or exhausts
    ``ik_max_iters``, or stalls) it records the solution, is graded by the
    10x-loose acceptance on the ``so3_log`` norm (as the JAX package does),
    and re-targets the next stage from the same q.  A failed stage ends the
    lane.  ``ik_chain_total_budget`` caps the global iteration count.
    Returns (qs [B, K-1, 7] tail solutions, ok [B])."""
    b, k = chain_tgts.shape[0], chain_tgts.shape[1]
    dev = seeds.device
    tol = cfg.ik_pos_tol
    max_it = cfg.ik_max_iters
    window = cfg.ik_stall_window
    budget = cfg.ik_chain_total_budget
    lanes = torch.arange(b, device=dev)

    q = seeds
    s = torch.where(active, 0, k)                # inactive lanes: done
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    err_best = torch.full((b,), torch.inf, device=dev)
    stall = torch.zeros(b, dtype=torch.int32, device=dev)
    ok = active
    qs = torch.zeros((b, k, 7), dtype=seeds.dtype, device=dev)
    glob = 0
    while (not budget or glob < budget) and host_bool(torch.any(s < k)):
        live = s < k
        stage = torch.clamp(s, max=k - 1)
        tgt_now = chain_tgts[lanes, stage]
        e, jac = _batch_error_and_jac(model, q, tgt_now)
        err = torch.linalg.norm(e, dim=1)

        stalled = (stall >= window) if window else torch.zeros_like(live)
        fin = live & ((err <= tol) | (it >= max_it) | stalled)
        pos_err = torch.linalg.norm(e[:, :3], dim=1)
        rot_err = torch.linalg.norm(e[:, 3:], dim=1)
        succ = (pos_err < tol * 10) & (rot_err < cfg.ik_rot_tol * 10)

        rec = (fin[:, None]
               & (torch.arange(k, device=dev)[None, :] == stage[:, None]))
        qs = torch.where(rec[:, :, None], q[:, None, :], qs)
        ok = ok & torch.where(fin, succ, torch.ones_like(succ))
        s = torch.where(fin, torch.where(succ, s + 1, k), s)

        q_new = _newton_step(jac, e, q, cfg.ik_damping, lower7, upper7)
        upd = live & ~fin
        improved = err < 0.85 * err_best
        q = torch.where(upd[:, None], q_new, q)
        it = torch.where(fin, 0, it + upd.to(it.dtype))
        err_best = torch.where(fin, torch.full_like(err, torch.inf),
                               torch.minimum(err_best, err))
        stall = torch.where(fin | improved, 0, stall + upd.to(stall.dtype))
        glob += 1
    # budget-capped lanes never completed every stage: not valid
    ok = ok & (s >= k)
    return qs[:, 1:], ok


def solve_lanes(cfg: OMGConfig, n_grasps: int, n_seeds: int) -> int:
    """K, the number of lanes :func:`solve_goal_set` returns: every
    (grasp, seed) lane, or the two-stage survivors."""
    b = n_grasps * n_seeds
    if cfg.ik_two_stage and cfg.ik_survivor_cap:
        return min(b, cfg.ik_survivor_cap)
    return b


def solve_goal_set(model, cfg: OMGConfig, grasp_poses_world, seeds, lower7,
                   upper7, attached: bool = False, grasp_valid=None):
    """All (grasp x seed) standoff chains as staged batched solves
    (replaces ``multiprocessing.Pool(4)``, ``omg/planner.py:395-443``).

    Two-stage (``cfg.ik_two_stage``): a fixed-iteration prefilter over all
    lanes, the best ``ik_survivor_cap`` lanes by post-sweep error survive
    (ties to the lower lane), and only they run the standoff chain, warm
    started.  Returns (reach [K, tail, 9], standoff [K, 9], valid [K],
    lane_idx [K]) with ``lane_idx`` the (grasp-major, seed-minor) lane."""
    tail = cfg.reach_tail_length
    dev = grasp_poses_world.device
    offs = torch.eye(4, device=dev).repeat(tail, 1, 1)
    if cfg.use_standoff:
        offs[:, 2, 3] = (-cfg.standoff_dist
                         * torch.arange(tail, dtype=torch.float32,
                                        device=dev)) / tail
    standoffs = torch.einsum("nab,kbc->nkac", grasp_poses_world, offs)

    n, s = grasp_poses_world.shape[0], seeds.shape[0]
    b = n * s
    tgt = torch.repeat_interleave(standoffs, s, dim=0)  # [B, tail, 4, 4]
    seeds_b = seeds.repeat(n, 1)                          # [B, 7]
    lane_valid = (torch.repeat_interleave(grasp_valid, s)
                  if grasp_valid is not None
                  else torch.ones(b, dtype=torch.bool, device=dev))

    if cfg.ik_two_stage:
        q_pre, err_pre = ik_batch_fixed(
            model, tgt[:, -1], seeds_b, cfg, lower7, upper7,
            cfg.ik_prefilter_iters)
        score = torch.where(lane_valid, err_pre,
                            torch.full_like(err_pre, torch.inf))
        k_cap = solve_lanes(cfg, n, s)
        lane_idx = top_k(-score, k_cap)[1]
        act_full = lane_valid & (err_pre < cfg.ik_prefilter_tol)
        tgt = take_rows(tgt, lane_idx)
        seeds_b = take_rows(q_pre, lane_idx)
        active = act_full[lane_idx]
        b = k_cap
    else:
        k_cap = b
        lane_idx = torch.arange(b, device=dev)
        active = lane_valid

    chain_cfg = (cfg.replace(ik_max_iters=cfg.ik_chain_max_iters)
                 if cfg.ik_chain_max_iters else cfg)
    chain_tgts = torch.cat([tgt[:, -1:], tgt], dim=1)  # far first, then tail

    if cfg.ik_chain_fused:
        # the whole-chain budget applies only in the regime it was
        # calibrated in: warm chains on a full survivor-cap compaction
        if not (cfg.ik_two_stage and k_cap >= cfg.ik_survivor_cap > 0):
            chain_cfg = chain_cfg.replace(ik_chain_total_budget=0)
        qs, ok = _solve_chain_fused(model, chain_cfg, chain_tgts, seeds_b,
                                    lower7, upper7, active)
    else:
        prev, ok = seeds_b, active
        sols = []
        for kk in range(chain_tgts.shape[1]):
            res = ik_batch(model, chain_tgts[:, kk], prev, chain_cfg,
                           lower7, upper7, active=active)
            ok = ok & res.success
            active = active & res.success
            prev = res.q
            sols.append(res.q)
        qs = torch.stack(sols[1:], dim=1)                  # [B, tail, 7]
    if not attached:
        qs = qs.flip(1)  # farthest ... grasp (planner.py:65)
    diff = torch.linalg.norm(torch.diff(qs, dim=1), dim=(1, 2))
    valid = ok & (diff < 2.0)
    reach = torch.cat([qs, _fingers((b, tail), qs)], dim=-1)
    standoff_q = qs[:, -1] if attached else qs[:, 0]
    standoff = torch.cat([standoff_q, _fingers((b,), qs)], dim=-1)
    return reach, standoff, valid, lane_idx
