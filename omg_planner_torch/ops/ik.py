"""Batched damped-least-squares inverse kinematics (counterpart of
``omg_planner_tpu/ops/ik.py``).

A joint-limit-clamped damped Newton iteration solves the whole goal set
(grasps x seeds x standoff tail) at once.  The standoff chain reproduces
``solve_one_pose_ik`` (``omg/planner.py:17-86``): the farthest standoff
first from the seed, then the tail poses, each seeded by the previous
solution.  The goal-set build's two loops, the two-stage prefilter and
the fused standoff chain, are the ``ik_prefilter`` and ``ik_chain``
operators of ``ops/kernels.py`` (one launch each on the card, no host
read); every other data-dependent loop exit (the JAX package's
``while_loop`` conditions) is read on the host once per iteration.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..config import OMGConfig
from ..models import panda
from ..utils.collectives import all_gather_cat, all_reduce_max
from ..utils.linalg import solve_spd_unrolled, take_rows, top_k
from ..utils.pose import so3_angle, so3_log
from ..utils.sync import host_bool
from . import kernels


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
    while it < cfg.ik_max_iters and host_bool(err > cfg.ik_pos_tol,
                                              "ik.single"):
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
    return kernels.ik_error_and_jac(
        panda.pqr_table(model.pose_0, model.chain_post), model.pose_0, q7,
        targets)


def ik_batch(model, targets, seeds, cfg: OMGConfig, lower7, upper7,
             active=None, err_reduce=None, num_scenes=None) -> IKResult:
    """Damped Newton IK over a batch in one loop, exiting when every gating
    lane converges.  ``active`` masks the exit (hopeless lanes can't hold
    the batch); a lane whose twist error hasn't improved >=15% in
    ``ik_stall_window`` iterations stops gating too (sticky).

    ``err_reduce`` reduces the 0-d exit gate each iteration: the
    goal-sharded solve passes an all-reduce MAX over its group, so every
    rank runs as many iterations as the single-process solve of the whole
    batch (lanes are independent, so a synced exit makes the sharded chain
    interchangeable with the unsharded one).

    ``num_scenes`` S: the batch is S scenes' lanes, scene-major, with one
    exit gate per scene (JAX's vmapped ``while_loop``).  A scene whose gate
    has closed keeps its q while the others iterate; the loop reads "any
    scene still open" on the host once per iteration."""
    b = seeds.shape[0]
    act = (torch.ones(b, dtype=torch.bool, device=seeds.device)
           if active is None else active)
    window = cfg.ik_stall_window
    q = seeds
    err_best = torch.full((b,), torch.inf, device=seeds.device)
    stall = torch.zeros(b, dtype=torch.int32, device=seeds.device)
    gate_open = torch.tensor(True, device=seeds.device)
    running = None  # per scene: [S] bool, the gates still open
    if num_scenes is not None:
        running = torch.ones(num_scenes, dtype=torch.bool,
                             device=seeds.device)
    it = 0
    while it < cfg.ik_max_iters and host_bool(gate_open, "ik.batch"):
        e, jac = _batch_error_and_jac(model, q, targets)
        q_new = kernels.ik_newton_step(jac, e, q, cfg.ik_damping, lower7,
                                        upper7)
        q = (q_new if running is None else torch.where(
            running.repeat_interleave(b // num_scenes)[:, None], q_new, q))
        err = torch.linalg.norm(e, dim=1)
        improved = err < 0.85 * err_best
        dropped = stall >= window  # sticky: never re-arm a dropped lane
        stall = torch.where(improved & ~dropped, torch.zeros_like(stall),
                            stall + 1)
        err_best = torch.minimum(err_best, err)
        gate = act if window == 0 else act & (stall < window)
        gate_err = torch.where(gate, err, torch.zeros_like(err))
        if running is None:
            gate_err = gate_err.max()
            if err_reduce is not None:
                gate_err = err_reduce(gate_err)
            gate_open = gate_err > cfg.ik_pos_tol
        else:
            running = running & (gate_err.reshape(num_scenes, -1).amax(1)
                                 > cfg.ik_pos_tol)
            gate_open = running.any()
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
    """Fixed-iteration damped Newton sweep (the two-stage prefilter), one
    launch of the ``ik_prefilter`` kernel on the card, which reads
    ``targets`` in place where it is a view of one standoff stage.
    Returns (q [B, 7], post-sweep twist norm [B])."""
    return kernels.ik_prefilter(targets, seeds, model.pose_0,
                                model.chain_post, lower7, upper7,
                                cfg.ik_damping, iters)


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
                       upper7, active, scene_budgets=None):
    """The whole standoff chain as one loop with per-lane stage
    advancement (``kernels.ik_chain_plain``; one launch of the ``ik_chain``
    kernel on the card): when a lane's current stage converges (or
    exhausts ``ik_max_iters``, or stalls) it records the solution, is
    graded by the 10x-loose acceptance on the ``so3_log`` norm (as the JAX
    package does), and re-targets the next stage from the same q.  A
    failed stage ends the lane.  ``ik_chain_total_budget`` caps the global
    iteration count.

    ``scene_budgets`` (one per scene, 0 = none) replaces the budget for a
    batch of scenes' lanes, scene-major and alike in count: a scene's
    lanes stop at its own budget.  The global iteration count is the same
    for every scene still running, so the lanes of S scenes advance as in
    S separate solves.  Returns (qs [B, K-1, 7] tail solutions, ok [B])."""
    b = chain_tgts.shape[0]
    if scene_budgets is None or len(set(scene_budgets)) == 1:
        # one budget for every lane: an argument of the launch, no tensor
        budgets = (cfg.ik_chain_total_budget if scene_budgets is None
                   else scene_budgets[0])
    else:
        budgets = torch.tensor(scene_budgets, dtype=torch.int32
                               ).repeat_interleave(b // len(scene_budgets)
                                                   ).to(seeds.device)
    return kernels.ik_chain(
        chain_tgts, seeds, active, budgets, model.pose_0,
        model.chain_post, lower7, upper7, cfg.ik_damping, cfg.ik_pos_tol,
        cfg.ik_rot_tol, cfg.ik_max_iters, cfg.ik_stall_window)


def solve_lanes(cfg: OMGConfig, n_grasps: int, n_seeds: int) -> int:
    """K, the number of lanes :func:`solve_goal_set` returns: every
    (grasp, seed) lane, or the two-stage survivors."""
    b = n_grasps * n_seeds
    if cfg.ik_two_stage and cfg.ik_survivor_cap:
        return min(b, cfg.ik_survivor_cap)
    return b


def _standoff_targets(cfg: OMGConfig, grasp_poses_world):
    """The standoff chain's poses of every grasp: [..., N, 4, 4] ->
    [..., N, tail, 4, 4] (farthest standoff last)."""
    tail = cfg.reach_tail_length
    dev = grasp_poses_world.device
    offs = torch.eye(4, device=dev).repeat(tail, 1, 1)
    if cfg.use_standoff:
        offs[:, 2, 3] = (-cfg.standoff_dist
                         * torch.arange(tail, dtype=torch.float32,
                                        device=dev)) / tail
    return torch.einsum("...nab,kbc->...nkac", grasp_poses_world, offs)


def _solve_chains(model, cfg: OMGConfig, chain_cfg: OMGConfig, tgt, seeds_b,
                  lower7, upper7, active, attached, err_reduce=None,
                  num_scenes=None, scene_budgets=None):
    """The standoff chains of lanes ``tgt [B, tail, 4, 4]`` from
    ``seeds_b [B, 7]``: far standoff first, then the tail.  Returns
    (reach [B, tail, 9], standoff [B, 9], valid [B])."""
    b, tail = tgt.shape[0], tgt.shape[1]
    chain_tgts = torch.cat([tgt[:, -1:], tgt], dim=1)  # far first, then tail
    if cfg.ik_chain_fused:
        qs, ok = _solve_chain_fused(model, chain_cfg, chain_tgts, seeds_b,
                                    lower7, upper7, active, scene_budgets)
    else:
        prev, ok = seeds_b, active
        sols = []
        for kk in range(chain_tgts.shape[1]):
            res = ik_batch(model, chain_tgts[:, kk], prev, chain_cfg,
                           lower7, upper7, active=active,
                           err_reduce=err_reduce, num_scenes=num_scenes)
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
    return reach, standoff, valid


def _chain_cfg(cfg: OMGConfig) -> OMGConfig:
    return (cfg.replace(ik_max_iters=cfg.ik_chain_max_iters)
            if cfg.ik_chain_max_iters else cfg)


def _chain_budgeted(cfg: OMGConfig, k_cap: int) -> bool:
    """Does the whole-chain budget apply?  Only in the regime it was
    calibrated in: warm chains on a full survivor-cap compaction."""
    return bool(cfg.ik_two_stage and k_cap >= cfg.ik_survivor_cap > 0)


def solve_goal_set(model, cfg: OMGConfig, grasp_poses_world, seeds, lower7,
                   upper7, attached: bool = False, grasp_valid=None,
                   group=None):
    """All (grasp x seed) standoff chains as staged batched solves
    (replaces ``multiprocessing.Pool(4)``, ``omg/planner.py:395-443``).

    Two-stage (``cfg.ik_two_stage``): a fixed-iteration prefilter over all
    lanes, the best ``ik_survivor_cap`` lanes by post-sweep error survive
    (ties to the lower lane), and only they run the standoff chain, warm
    started.  Returns (reach [K, tail, 9], standoff [K, 9], valid [K],
    lane_idx [K]) with ``lane_idx`` the (grasp-major, seed-minor) lane.

    ``group`` (a ``torch.distributed`` process group; JAX's ``axis``)
    shards the chain lanes over its ranks.  The prefilter and the ranking
    run replicated, so every rank compacts to the same survivor list; each
    rank solves a contiguous slice of it, padded to a multiple of the
    group size with inactive dummy lanes.  The non-fused chain syncs its
    convergence exit with an all-reduce MAX; the fused chain needs none
    (its lanes advance independently and its budget counts global
    iterations, alike on every rank).  One all-gather per output, in rank
    order, trimmed to K, restores the single-process lane order."""
    dev = grasp_poses_world.device
    standoffs = _standoff_targets(cfg, grasp_poses_world)

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
        warm = q_pre
        act_full = lane_valid & (err_pre < cfg.ik_prefilter_tol)
    else:
        k_cap = b
        lane_idx = torch.arange(b, device=dev)
        warm = seeds_b
        act_full = lane_valid

    err_reduce = None
    if group is not None:
        # this rank's contiguous slice of the (replicated) survivor list,
        # padded with inactive dummy lanes that the gather trims
        ns, shard = dist.get_world_size(group), dist.get_rank(group)
        per = -(-k_cap // ns)
        lane_padded = torch.cat([lane_idx,
                                 lane_idx.new_zeros(per * ns - k_cap)])
        my_lane = lane_padded[shard * per:(shard + 1) * per]
        my_live = torch.arange(shard * per, (shard + 1) * per,
                               device=dev) < k_cap
        tgt = take_rows(tgt, my_lane)
        seeds_b = take_rows(warm, my_lane)
        active = act_full[my_lane] & my_live
        err_reduce = functools.partial(all_reduce_max, group=group)
    elif cfg.ik_two_stage:
        tgt = take_rows(tgt, lane_idx)
        seeds_b = take_rows(warm, lane_idx)
        active = act_full[lane_idx]
    else:
        active = act_full

    chain_cfg = _chain_cfg(cfg)
    if cfg.ik_chain_fused and not _chain_budgeted(cfg, k_cap):
        chain_cfg = chain_cfg.replace(ik_chain_total_budget=0)
    reach, standoff, valid = _solve_chains(
        model, cfg, chain_cfg, tgt, seeds_b, lower7, upper7, active,
        attached, err_reduce=err_reduce)
    if group is not None:
        reach, standoff, valid = (all_gather_cat(x, group)[:k_cap]
                                  for x in (reach, standoff, valid))
    return reach, standoff, valid, lane_idx


def solve_goal_set_batch(model, cfg: OMGConfig, grasp_poses_world, seeds,
                         lower7, upper7, n_grasps, attached: bool = False,
                         grasp_valid=None):
    """:func:`solve_goal_set` for a batch of S scenes in one solve: the
    scene-batched form of JAX's vmapped goal-set build.

    ``grasp_poses_world [S, N, 4, 4]`` holds each scene's grasps padded to
    the wave's largest database, ``n_grasps`` the host count of each
    scene's own (unpadded) grasps, ``seeds [S, n_seeds, 7]`` and
    ``grasp_valid [S, N]`` (padded grasps False).  The prefilter runs over
    every lane of every scene; the survivors are ranked within each scene;
    the chains run over the flattened survivors, with one exit gate
    (unfused) or budget (fused) per scene, each scene's as in its own
    solve.  Scene i's K_i = ``solve_lanes(cfg, n_grasps[i], n_seeds)``
    output lanes are the first K_i of its row, in its own solve's order;
    the rest are invalid padding.  Returns (reach [S, K, tail, 9],
    standoff [S, K, 9], valid [S, K], lane_idx [S, K], [K_i])."""
    dev = grasp_poses_world.device
    n_scenes, n, _, _ = grasp_poses_world.shape
    s = seeds.shape[1]
    b = n * s
    standoffs = _standoff_targets(cfg, grasp_poses_world)
    tail = standoffs.shape[2]
    tgt = torch.repeat_interleave(standoffs, s, dim=1)  # [S, B, tail, 4, 4]
    seeds_b = seeds.repeat(1, n, 1)                       # [S, B, 7]
    lane_valid = (torch.repeat_interleave(grasp_valid, s, dim=1)
                  if grasp_valid is not None
                  else torch.ones((n_scenes, b), dtype=torch.bool,
                                  device=dev))
    lanes = [solve_lanes(cfg, ni, s) for ni in n_grasps]

    if cfg.ik_two_stage:
        q_pre, err_pre = ik_batch_fixed(
            model, tgt[:, :, -1].reshape(-1, 4, 4), seeds_b.reshape(-1, 7),
            cfg, lower7, upper7, cfg.ik_prefilter_iters)
        q_pre = q_pre.reshape(n_scenes, b, 7)
        err_pre = err_pre.reshape(n_scenes, b)
        score = torch.where(lane_valid, err_pre,
                            torch.full_like(err_pre, torch.inf))
        lane_idx = top_k(-score, solve_lanes(cfg, n, s))[1]  # [S, K]
        act_full = lane_valid & (err_pre < cfg.ik_prefilter_tol)
        tgt = torch.gather(tgt, 1, lane_idx[:, :, None, None, None].expand(
            -1, -1, tail, 4, 4))
        seeds_b = torch.gather(q_pre, 1, lane_idx[:, :, None].expand(
            -1, -1, 7))
        active = torch.gather(act_full, 1, lane_idx)
    else:
        lane_idx = torch.arange(b, device=dev).expand(n_scenes, b)
        active = lane_valid
    k = lane_idx.shape[1]

    chain_cfg = _chain_cfg(cfg)
    budgets = [chain_cfg.ik_chain_total_budget
               if _chain_budgeted(cfg, ki) else 0 for ki in lanes]
    reach, standoff, valid = _solve_chains(
        model, cfg, chain_cfg, tgt.reshape(n_scenes * k, tail, 4, 4),
        seeds_b.reshape(n_scenes * k, 7), lower7, upper7,
        active.reshape(-1), attached, num_scenes=n_scenes,
        scene_budgets=budgets)
    return (reach.reshape((n_scenes, k) + reach.shape[1:]),
            standoff.reshape(n_scenes, k, -1), valid.reshape(n_scenes, k),
            lane_idx, lanes)
