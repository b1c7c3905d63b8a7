"""Goal-set construction: grasp augmentation, batched IK, pruning, sampling
(counterpart of ``omg_planner_tpu/planner/goal_set.py``; reference
``omg/planner.py:226-597``):

  grasp DB (object frame) -> world poses -> [z/y upsampling] ->
  batched standoff-chain IK over (grasps x seeds) ->
  C-space wrist-flip augmentation -> task-space rotation/downward filters
  -> batched collision pruning -> greedy diversity dedupe -> random sample.

Randomness: the ``increment_iks`` reseed, the prune-cap subsample and the
final sample are Gumbel top-k draws.  The port draws the Gumbel noise from
a ``torch.Generator``; a caller (the parity tests) may pass
``gumbel_fn(tag, n)`` to supply the noise instead, ``tag`` being
``"increment"``, ``"prune"`` or ``"sample"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import OMGConfig
from ..models import api as model_api
from ..models import panda
from ..ops import ik as ik_ops
from ..ops.chomp import CostParams, GoalSet
from ..ops.sdf import sdf_potentials
from ..utils.linalg import take_rows, top_k
from ..utils.pose import rot_y, rot_z
from ..utils.spline import multi_linear_interpolate
from ..utils.sync import host_bool

# 13 anchor seed configurations for IK (reference ``omg/util.py:19-35``;
# the first row is replaced by the trajectory start).
ANCHOR_SEEDS = np.array(
    [
        [2.5, 0.23, -2.89, -1.69, 0.056, 1.46, -1.27, 0.04, 0.04],
        [2.8, 0.23, -2.89, -1.69, 0.056, 1.46, -1.27, 0.04, 0.04],
        [2.0, 0.23, -2.89, -1.69, 0.056, 1.46, -1.27, 0.04, 0.04],
        [2.5, 0.83, -2.89, -1.69, 0.056, 1.46, -1.27, 0.04, 0.04],
        [0.049, 1.22, -1.87, -0.67, 2.12, 0.99, -0.85, 0.04, 0.04],
        [-2.28, -0.43, 2.47, -1.35, 0.62, 2.28, -0.27, 0.04, 0.04],
        [-2.02, -1.29, 2.20, -0.83, 0.22, 1.18, 0.74, 0.04, 0.04],
        [-2.2, 0.03, -2.89, -1.69, 0.056, 1.46, -1.27, 0.04, 0.04],
        [-2.5, -0.71, -2.73, -0.82, -0.7, 0.62, -0.56, 0.04, 0.04],
        [-2.0, -0.71, -2.73, -0.82, -0.7, 0.62, -0.56, 0.04, 0.04],
        [-2.66, -0.55, 2.06, -1.77, 0.96, 1.77, -1.35, 0.04, 0.04],
        [1.51, -1.48, -1.12, -1.55, -1.57, 1.15, 0.24, 0.04, 0.04],
        [-2.61, -0.98, 2.26, -0.85, 0.61, 1.64, 0.23, 0.04, 0.04],
    ]
)


def gumbel_noise(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(U))`` with U uniform on
    [tiny, 1), drawn on the host generator and moved to ``device``."""
    tiny = float(np.finfo(np.float32).tiny)
    u = torch.rand(n, generator=gen, dtype=torch.float32)
    u = torch.clamp(u, min=tiny)
    return (-torch.log(-torch.log(u))).to(device)


def z_upsample_poses(poses, object_pos, bins: int = 50):
    """Upsample grasps by global-z rotation about the object origin
    (``omg/planner.py:324-334``). [N,4,4] -> [N*bins,4,4]."""
    angs = torch.linspace(-math.pi, math.pi, bins, device=poses.device)
    rz = rot_z(angs).to(poses.device)  # [bins, 4, 4]
    centered = poses.clone()
    centered[:, :3, 3] -= object_pos
    out = torch.einsum("bac,ncd->nbad", rz, centered)
    out[:, :, :3, 3] += object_pos
    return out.reshape(-1, 4, 4)


def y_upsample_poses(poses, bins: int = 10):
    """Upsample by local-y tilts about the antipodal finger contact
    (``omg/planner.py:336-347``)."""
    angs = torch.linspace(-math.pi / 4, math.pi / 4, bins,
                          device=poses.device)
    ry = rot_y(angs).to(poses.device)[:, :3, :3]
    finger = torch.tensor([0.0, 0.0, 0.13], device=poses.device)
    contact = (torch.einsum("nab,b->na", poses[:, :3, :3], finger)
               + poses[:, :3, 3])
    local_rot = torch.einsum("nab,Bbc->nBac", poses[:, :3, :3], ry)
    delta = torch.einsum("nBab,b->nBa", local_rot, finger)
    out = poses[:, None].repeat(1, bins, 1, 1)
    out[:, :, :3, :3] = local_rot
    out[:, :, :3, 3] = contact[:, None] - delta
    return out.reshape(-1, 4, 4)


def flip_wrist(configs, cfg: OMGConfig):
    """C-space wrist +/- pi augmentation (``omg/planner.py:226-237``).
    Returns (flipped configs, within-limits mask)."""
    wrist = configs[..., 6]
    flipped = torch.where(wrist < 0, wrist + math.pi, wrist - math.pi)
    out = configs.clone()
    out[..., 6] = flipped
    lim = 2.8973 - cfg.soft_joint_limit_padding
    ok = (flipped < lim) & (flipped > -lim)
    return out, ok


def task_space_filter(model, cfg: OMGConfig, start, reach_grasps, valid):
    """Remove grasps needing heavy wrist rotation or a camera-downward
    approach (``omg/planner.py:260-293``)."""
    start_hand = panda.hand_pose(model, start)
    if cfg.use_standoff:
        n = 5
        interp = multi_linear_interpolate(start, reach_grasps[:, -1], n)
        flat = interp.reshape(-1, 9)
    else:
        n = 1
        flat = reach_grasps[:, -1]
    hands = panda.hand_pose_batch(model, flat).reshape(-1, n, 4, 4)
    r_diff = torch.einsum("cnab,db->cnad", hands[..., :3, :3],
                          start_hand[:3, :3])
    tr = r_diff[..., 0, 0] + r_diff[..., 1, 1] + r_diff[..., 2, 2]
    angle = torch.abs(torch.arccos(torch.clamp((tr - 1) / 2, -1.0, 1.0)))
    rot_mask = angle * 180 / math.pi > cfg.target_hand_filter_angle
    x_axis = hands[..., :3, 0]
    x_axis = x_axis / (torch.linalg.norm(x_axis, dim=-1, keepdim=True) + 1e-9)
    down_mask = x_axis[..., 2] < -0.3
    bad = (rot_mask | down_mask).sum(-1) > 0
    if not cfg.remove_flip_grasp:
        bad = torch.zeros_like(bad)
    return valid & ~bad


def collision_prune(model, scene, params: CostParams, cfg: OMGConfig,
                    standoff_goals, valid):
    """Batch collision check of candidate goal configs
    (``omg/planner.py:508-539``).  Returns (valid', potentials [C])."""
    poses = panda.forward_kinematics_batch(model, standoff_goals)
    x = panda.collision_point_positions(model, poses)
    c = standoff_goals.shape[0]
    p = x.shape[2]
    pot, _, collide = sdf_potentials(
        scene, params.inv_poses, x.reshape(-1, 3), params.epsilons,
        params.padding_scales, params.clearances, params.disables)
    pot = pot.reshape(c, panda.NUM_LINKS, p)
    collide = collide.reshape(c, panda.NUM_LINKS, p).clone()
    # uncheck_finger_collision=-1 semantics (cost.py:350-353)
    scale = torch.ones(panda.NUM_LINKS, device=pot.device)
    scale[-2:] = 0.1
    pot = pot * scale[None, :, None]
    collide[:, -2:] = 0.0
    n_collide = collide.sum(dim=(1, 2))
    potentials = pot.sum(dim=(1, 2))
    return valid & (n_collide <= cfg.allow_collision_point), potentials


def diversity_dedupe(configs, valid, min_dist: float = 0.5,
                     mode: str = "scan"):
    """Greedy config-space dedupe (``omg/planner.py:547-562``): keep a
    candidate only if farther than ``min_dist`` from every kept one.

    ``"scan"`` replays the sequential greedy pass; ``"rounds"`` resolves
    the same lexicographically-first maximal independent set as a fixed
    point, one host-read condition per round.  Unlike the JAX package,
    which falls back to "scan" for any other string, an unknown mode
    raises."""
    c = configs.shape[0]
    d2 = torch.sum((configs[:, None, :] - configs[None, :, :]) ** 2, dim=-1)
    close = d2 < min_dist**2
    ar = torch.arange(c, device=configs.device)

    if mode == "rounds":
        lower_close = close & (ar[None, :] < ar[:, None])
        kept = torch.zeros(c, dtype=torch.bool, device=configs.device)
        rejected = ~valid
        while host_bool(torch.any(~kept & ~rejected)):
            unknown = ~kept & ~rejected
            blocked = torch.any(lower_close & kept[None, :], dim=1)
            ready = ~torch.any(lower_close & ~rejected[None, :], dim=1)
            kept = kept | (unknown & ready & ~blocked)
            rejected = rejected | (unknown & blocked)
        return kept
    if mode != "scan":
        raise ValueError(f"unknown dedupe_mode {mode!r}")

    kept = torch.zeros(c, dtype=torch.bool, device=configs.device)
    for i in range(c):
        conflict = torch.any(kept & close[i] & (ar < i))
        kept[i] = valid[i] & ~conflict
    return kept


def sample_goals(noise, valid, capacity: int):
    """Uniform sample of <= capacity valid candidates without replacement
    (``omg/planner.py:565-568``) via Gumbel top-k of ``noise``.  Returns
    indices [cap] and a mask [cap]."""
    scores = torch.where(valid, noise, torch.full_like(noise, -torch.inf))
    vals, idx = top_k(scores, capacity)
    return idx, torch.isfinite(vals)


def pinch_centers(model, configs):
    """World midpoint of the two finger-pad centers at each config
    [C, 9] -> [C, 3]."""
    poses = model_api.fk_batch(model, configs)            # [C, L, 4, 4]
    pts = model.collision_points[-2:]                     # [2, P, 3]
    centers = (pts.amin(dim=1) + pts.amax(dim=1)) / 2.0
    pad = poses[:, -2:]
    pc = pad[..., :3, 3] + torch.einsum("cfab,fb->cfa", pad[..., :3, :3],
                                        centers)
    return pc.mean(dim=1)


def build_goal_set(model, cfg: OMGConfig, scene, params: CostParams,
                   grasp_poses_world, grasp_valid, start,
                   gen: torch.Generator | None = None,
                   attached: bool = False, obj_pos=None,
                   gumbel_fn=None, solve_fn=None) -> GoalSet:
    """Full goal-set construction for one target object.  Capacity =
    ``cfg.goal_set_max_num``.  The Gumbel noise comes from ``gen`` unless
    ``gumbel_fn(tag, n)`` supplies it.  ``solve_fn`` (signature of
    :func:`ik_ops.solve_goal_set`) overrides the IK sweep, as in the JAX
    package."""
    dev = start.device
    if gumbel_fn is None:
        if gen is None:
            raise ValueError("build_goal_set needs a generator or gumbel_fn")

        def gumbel_fn(tag, n):
            return gumbel_noise(gen, n, dev)

    lo, hi = model.soft_limits(cfg.soft_joint_limit_padding)
    seeds = torch.cat([
        start[None, :7],
        torch.as_tensor(ANCHOR_SEEDS[: cfg.ik_seed_num, :7],
                        dtype=start.dtype, device=dev)])
    solve = solve_fn if solve_fn is not None else ik_ops.solve_goal_set
    reach, standoff, valid, _ = solve(
        model, cfg, grasp_poses_world, seeds, lo[:7], hi[:7], attached,
        grasp_valid=grasp_valid)

    if cfg.increment_iks:
        # second pass reseeded from up to 10 Gumbel-sampled successful
        # standoff configurations (reference ``increment_iks``,
        # ``omg/planner.py:436-441``); skipped, with zero invalid lanes of
        # the same shape, when the first pass already fills the goal cap
        g = gumbel_fn("increment", valid.shape[0])
        vals, top = top_k(torch.where(valid, g,
                                      torch.full_like(g, -torch.inf)), 10)
        extra = torch.where(torch.isfinite(vals)[:, None],
                            take_rows(standoff, top)[:, :7], seeds[0][None])
        if host_bool(valid.sum() < cfg.goal_set_max_num):
            reach2, standoff2, valid2, _ = solve(
                model, cfg, grasp_poses_world, extra, lo[:7], hi[:7],
                attached, grasp_valid=grasp_valid)
        else:
            k = ik_ops.solve_lanes(cfg, grasp_poses_world.shape[0], 10)
            reach2 = reach.new_zeros((k,) + reach.shape[1:])
            standoff2 = standoff.new_zeros((k,) + standoff.shape[1:])
            valid2 = valid.new_zeros(k)
        reach = torch.cat([reach, reach2])
        standoff = torch.cat([standoff, standoff2])
        valid = torch.cat([valid, valid2])

    if cfg.augment_flip_grasp and not attached:
        flip_standoff, ok1 = flip_wrist(standoff, cfg)
        flip_reach, _ = flip_wrist(reach, cfg)
        reach = torch.cat([reach, flip_reach])
        standoff = torch.cat([standoff, flip_standoff])
        valid = torch.cat([valid, valid & ok1])

    if cfg.remove_flip_grasp and not attached:
        valid = task_space_filter(model, cfg, start, reach, valid)

    if cfg.goal_prune_cap and cfg.goal_prune_cap < reach.shape[0]:
        # compact to valid lanes before the collision prune and the O(C^2)
        # dedupe; sorting the survivors keeps the greedy dedupe's lane
        # order, so below the cap the result does not depend on the draw
        g = gumbel_fn("prune", valid.shape[0])
        scores = torch.where(valid, g, torch.full_like(g, -torch.inf))
        sel = torch.sort(top_k(scores, cfg.goal_prune_cap)[1]).values
        reach = take_rows(reach, sel)
        standoff = take_rows(standoff, sel)
        valid = valid[sel]

    valid, potentials = collision_prune(model, scene, params, cfg, standoff,
                                        valid)
    kept = diversity_dedupe(standoff, valid, mode=cfg.dedupe_mode)
    idx, mask = sample_goals(gumbel_fn("sample", kept.shape[0]), kept,
                             cfg.goal_set_max_num)

    reach_sel = take_rows(reach, idx)
    standoff_sel = take_rows(standoff, idx)
    pot_sel = potentials[idx]
    grasps_sel = reach_sel[:, -1] if cfg.use_standoff else standoff_sel

    if cfg.grasp_optimize:
        hands = panda.hand_pose_batch(model, grasps_sel)
        downness = -hands[:, 2, 2]  # world z of the approach axis
        pot_sel = pot_sel + cfg.base_grasp_weight * (0.5 * (1.0 - downness))

    if cfg.grip_quality_weight and obj_pos is not None:
        com_dist = torch.linalg.norm(
            pinch_centers(model, grasps_sel) - obj_pos[None], dim=-1)
        pot_sel = pot_sel + cfg.grip_quality_weight * com_dist

    zero = torch.zeros((), device=dev)
    return GoalSet(
        grasps=torch.where(mask[:, None], grasps_sel, zero),
        reach_grasps=torch.where(mask[:, None, None], reach_sel, zero),
        mask=mask,
        potentials=torch.where(mask, pot_sel, zero),
    )


def goal_idx_policy(cfg: OMGConfig, goal_set: GoalSet, start):
    """Initial goal choice (``omg/planner.py:201-223``): a 0-d int64."""
    dev = start.device
    proj_dist = torch.linalg.norm(start[None] - goal_set.grasps, dim=-1)
    proj_dist = torch.where(goal_set.mask, proj_dist,
                            torch.full_like(proj_dist, torch.inf))
    if cfg.goal_idx >= 0:
        return torch.tensor(cfg.goal_idx, device=dev)
    if cfg.ol_alg == "Proj":
        return torch.argmin(proj_dist)
    if cfg.goal_idx == -1:
        costs = goal_set.potentials + cfg.dist_eps * proj_dist
        return torch.argmin(torch.where(
            goal_set.mask, costs, torch.full_like(costs, torch.inf)))
    return torch.tensor(0, device=dev)
