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

:func:`build_goal_set_batch` builds the goal sets of a batch of scenes
(JAX's vmapped ``build_goal_set``) with the same per-scene results as
:func:`build_goal_set`, host reads about those of one scene's build.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils._pytree import tree_map

from ..config import OMGConfig
from ..models import api as model_api
from ..models import panda
from ..ops import ik as ik_ops
from ..ops.chomp import CostParams, GoalSet
from ..ops.sdf import sdf_potentials
from ..utils import timing
from ..utils.linalg import take_rows, top_k
from ..utils.pose import rot_y, rot_z
from ..utils.spline import multi_linear_interpolate
from ..utils.sync import host_bool
from ..utils.vmap import vmap_scenes

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
    _, x = model_api.fk_points(model, standoff_goals)
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
    ``configs [..., C, D]``, ``valid [..., C]``: leading dims are
    independent scenes.

    ``"scan"`` replays the sequential greedy pass; ``"rounds"`` resolves
    the same lexicographically-first maximal independent set as a fixed
    point, one host-read condition per round (for a scene batch: while
    any scene has an unresolved lane; a resolved scene no longer changes).
    Unlike the JAX package, which falls back to "scan" for any other
    string, an unknown mode raises."""
    c = configs.shape[-2]
    d2 = torch.sum((configs[..., :, None, :] - configs[..., None, :, :]) ** 2,
                   dim=-1)
    close = d2 < min_dist**2
    ar = torch.arange(c, device=configs.device)

    if mode == "rounds":
        lower_close = close & (ar[None, :] < ar[:, None])
        kept = torch.zeros_like(valid)
        rejected = ~valid
        while host_bool(torch.any(~kept & ~rejected), "goal_set.dedupe"):
            unknown = ~kept & ~rejected
            blocked = torch.any(lower_close & kept[..., None, :], dim=-1)
            ready = ~torch.any(lower_close & ~rejected[..., None, :], dim=-1)
            kept = kept | (unknown & ready & ~blocked)
            rejected = rejected | (unknown & blocked)
        return kept
    if mode != "scan":
        raise ValueError(f"unknown dedupe_mode {mode!r}")

    kept = torch.zeros_like(valid)
    for i in range(c):
        conflict = torch.any(kept & close[..., i, :] & (ar < i), dim=-1)
        kept[..., i] = valid[..., i] & ~conflict
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
    """Full goal-set construction for one target object: the batch of one
    of :func:`build_goal_set_batch`, whose per-scene stages run on the
    scene as it is (no ``vmap``).  Capacity = ``cfg.goal_set_max_num``.
    The Gumbel noise comes from ``gen`` unless ``gumbel_fn(tag, n)``
    supplies it.  ``solve_fn`` (signature of :func:`ik_ops.solve_goal_set`)
    overrides the IK sweep, as in the JAX package."""
    if gumbel_fn is None:
        if gen is None:
            raise ValueError("build_goal_set needs a generator or gumbel_fn")

        def gumbel_fn(tag, n):
            return gumbel_noise(gen, n, "cpu")

    if grasp_valid is None:
        grasp_valid = torch.ones(grasp_poses_world.shape[0],
                                 dtype=torch.bool, device=start.device)
    solve = solve_fn if solve_fn is not None else ik_ops.solve_goal_set

    def solve_one(model, cfg, poses, seeds, lower7, upper7, n_grasps,
                  attached, grasp_valid):
        out = solve(model, cfg, poses[0], seeds[0], lower7, upper7,
                    attached, grasp_valid=grasp_valid[0])
        return tuple(x[None] for x in out) + ([out[0].shape[0]],)

    def per_scene(fn, *rows):
        return tree_map(lambda x: x[None],
                        fn(scene, params, *(r[0] for r in rows)))

    out = _build_goal_sets(
        model, cfg, per_scene, grasp_poses_world[None], grasp_valid[None],
        [grasp_poses_world.shape[0]], start[None],
        lambda i, tag, n: gumbel_fn(tag, n), solve_one, attached,
        None if obj_pos is None else obj_pos[None])
    return GoalSet(*(x[0] for x in out))


def _ragged_cat(a, na, b, nb):
    """Per-scene concatenation of row prefixes: row i of the result holds
    ``a[i, :na[i]]``, then ``b[i, :nb[i]]``, then the padding lanes of
    both.  ``a [S, A, ...]``, ``b [S, B, ...]``; ``na``, ``nb`` host
    lists."""
    cat = torch.cat([a, b], dim=1)
    wa, wb = a.shape[1], b.shape[1]
    if all(x == wa for x in na) and all(x == wb for x in nb):
        return cat
    idx = torch.as_tensor(np.stack([np.concatenate([
        np.arange(x), wa + np.arange(y), np.arange(x, wa),
        wa + np.arange(y, wb)]) for x, y in zip(na, nb)]),
        device=a.device)
    return torch.gather(cat, 1, idx.reshape(
        idx.shape + (1,) * (a.ndim - 2)).expand(cat.shape))


def _take_lanes(a, idx):
    """``a[i, idx[i]]`` for every scene i: ``a [S, C, ...]``, ``idx [S, K]``
    -> ``[S, K, ...]``."""
    return torch.gather(a, 1, idx.reshape(
        idx.shape + (1,) * (a.ndim - 2)).expand(idx.shape + a.shape[2:]))


def build_goal_set_batch(model, cfg: OMGConfig, scene, params: CostParams,
                         grasp_poses_world, grasp_valid, n_grasps, start,
                         gens=None, attached: bool = False, obj_pos=None,
                         gumbel_fn=None, solve_fn=None) -> GoalSet:
    """:func:`build_goal_set` for a batch of S scenes (JAX's vmapped build).

    ``scene`` and ``params`` carry a leading scene axis, objects padded to
    one count (``parallel.batch.pad_scene``); ``grasp_poses_world [S, N,
    4, 4]`` holds each scene's grasps padded to the wave's largest
    database, ``grasp_valid [S, N]`` False on the padding, ``n_grasps``
    the host count of each scene's own grasps, ``start [S, D]``, ``obj_pos
    [S, 3]``.  Returns the stacked goal sets [S, G, ...].

    Every stage is per scene.  The lanes of scene i occupy the first of
    its row in its own build's order, padding after them, so each Gumbel
    draw is made on scene i's generator ``gens[i]``, in its own build's
    order and at its own (unpadded) size, and lands on the same lanes; the
    padding draws -inf.  The ``increment_iks`` second pass runs for the
    scenes whose first pass falls short of the goal cap (one host read),
    the others get zero invalid lanes as in their own build; the prune-cap
    compaction and the sample are top-k within each scene.  So each
    scene's goal set equals its :func:`build_goal_set`.  ``gumbel_fn(i,
    tag, n)`` supplies scene i's noise instead of ``gens``; ``solve_fn``
    (signature of :func:`ik_ops.solve_goal_set_batch`) overrides the IK."""
    if gumbel_fn is None:
        if gens is None:
            raise ValueError("build_goal_set_batch needs generators or "
                             "gumbel_fn")

        def gumbel_fn(i, tag, n):
            return gumbel_noise(gens[i], n, "cpu")

    def per_scene(fn, *rows):
        return vmap_scenes(fn, scene, params, *rows)

    return _build_goal_sets(
        model, cfg, per_scene, grasp_poses_world, grasp_valid, n_grasps,
        start, gumbel_fn,
        solve_fn if solve_fn is not None else ik_ops.solve_goal_set_batch,
        attached, obj_pos)


def _build_goal_sets(model, cfg: OMGConfig, per_scene, grasp_poses_world,
                     grasp_valid, n_grasps, start, gumbel_fn, solve,
                     attached, obj_pos) -> GoalSet:
    """The goal-set stages over S scenes (the body of
    :func:`build_goal_set_batch`, whose arguments it takes).
    ``per_scene(fn, *rows)`` maps ``fn(scene, params, *row)`` over the
    scenes; ``gumbel_fn(i, tag, n)`` draws scene i's noise."""
    n_scenes, dev = start.shape[0], start.device

    def draw(tag, sizes, width, scenes=None):
        """[S, width] noise: scene i's draw on its first sizes[i] lanes."""
        g = torch.full((n_scenes, width), -torch.inf)
        for i, n in enumerate(sizes):
            if scenes is None or scenes[i]:
                g[i, :n] = gumbel_fn(i, tag, n).to("cpu")
        return g.to(dev)

    def neg_inf(x):
        return torch.full_like(x, -torch.inf)

    lo, hi = model.soft_limits(cfg.soft_joint_limit_padding)
    with timing.span("goal_set.ik"):
        anchors = torch.as_tensor(ANCHOR_SEEDS[: cfg.ik_seed_num, :7],
                                  dtype=start.dtype, device=dev)
        seeds = torch.cat([start[:, None, :7],
                           anchors[None].expand(n_scenes, -1, -1)], dim=1)
        reach, standoff, valid, _, sizes = solve(
            model, cfg, grasp_poses_world, seeds, lo[:7], hi[:7], n_grasps,
            attached, grasp_valid=grasp_valid)

        if cfg.increment_iks:
            g = draw("increment", sizes, valid.shape[1])
            vals, top = top_k(torch.where(valid, g, neg_inf(g)), 10)
            extra = torch.where(torch.isfinite(vals)[..., None],
                                _take_lanes(standoff, top)[..., :7],
                                seeds[:, :1])
            need = valid.sum(1) < cfg.goal_set_max_num
            sizes2 = [ik_ops.solve_lanes(cfg, n, 10) for n in n_grasps]
            if host_bool(need.any(), "goal_set.increment"):
                reach2, standoff2, valid2, _, _ = solve(
                    model, cfg, grasp_poses_world, extra, lo[:7], hi[:7],
                    n_grasps, attached,
                    grasp_valid=grasp_valid & need[:, None])
                zero = torch.zeros((), device=dev)
                reach2 = torch.where(need[:, None, None, None], reach2, zero)
                standoff2 = torch.where(need[:, None, None], standoff2, zero)
                valid2 = valid2 & need[:, None]
            else:
                k = ik_ops.solve_lanes(cfg, grasp_poses_world.shape[1], 10)
                reach2 = reach.new_zeros((n_scenes, k) + reach.shape[2:])
                standoff2 = standoff.new_zeros(
                    (n_scenes, k) + standoff.shape[2:])
                valid2 = valid.new_zeros((n_scenes, k))
            reach = _ragged_cat(reach, sizes, reach2, sizes2)
            standoff = _ragged_cat(standoff, sizes, standoff2, sizes2)
            valid = _ragged_cat(valid, sizes, valid2, sizes2)
            sizes = [a + b for a, b in zip(sizes, sizes2)]

    with timing.span("goal_set.filter"):
        if cfg.augment_flip_grasp and not attached:
            flip_standoff, ok1 = flip_wrist(standoff, cfg)
            flip_reach, _ = flip_wrist(reach, cfg)
            reach = _ragged_cat(reach, sizes, flip_reach, sizes)
            standoff = _ragged_cat(standoff, sizes, flip_standoff, sizes)
            valid = _ragged_cat(valid, sizes, valid & ok1, sizes)
            sizes = [2 * n for n in sizes]

        if cfg.remove_flip_grasp and not attached:
            valid = per_scene(
                lambda sc, pa, st, r, v: task_space_filter(model, cfg, st, r,
                                                           v),
                start, reach, valid)

    with timing.span("goal_set.prune"):
        cap = cfg.goal_prune_cap
        if cap and cap < reach.shape[1]:
            # scene i compacts only when its own lanes exceed the cap; the
            # others keep their lanes (and padding) in order
            compact = [cap < n for n in sizes]
            g = draw("prune", sizes, valid.shape[1], compact)
            sel = torch.sort(top_k(torch.where(valid, g, neg_inf(g)),
                                   cap)[1]).values
            if not all(compact):
                keep = torch.arange(cap, device=dev).expand(n_scenes, cap)
                sel = torch.where(
                    torch.as_tensor(compact, device=dev)[:, None], sel, keep)
            reach = _take_lanes(reach, sel)
            standoff = _take_lanes(standoff, sel)
            valid = torch.gather(valid, 1, sel)
            sizes = [cap if c else n for c, n in zip(compact, sizes)]

        valid, potentials = per_scene(
            lambda sc, pa, st, v: collision_prune(model, sc, pa, cfg, st, v),
            standoff, valid)
    with timing.span("goal_set.dedupe"):
        kept = diversity_dedupe(standoff, valid, mode=cfg.dedupe_mode)
    with timing.span("goal_set.sample"):
        idx, mask = sample_goals(draw("sample", sizes, kept.shape[1]), kept,
                                 cfg.goal_set_max_num)

        reach_sel = _take_lanes(reach, idx)
        standoff_sel = _take_lanes(standoff, idx)
        pot_sel = torch.gather(potentials, 1, idx)
        grasps_sel = reach_sel[:, :, -1] if cfg.use_standoff else standoff_sel
        flat = grasps_sel.reshape(-1, grasps_sel.shape[-1])

        if cfg.grasp_optimize:
            hands = panda.hand_pose_batch(model, flat).reshape(
                grasps_sel.shape[:2] + (4, 4))
            downness = -hands[..., 2, 2]  # world z of the approach axis
            pot_sel = pot_sel + cfg.base_grasp_weight * (
                0.5 * (1.0 - downness))

        if cfg.grip_quality_weight and obj_pos is not None:
            com_dist = torch.linalg.norm(
                pinch_centers(model, flat).reshape(grasps_sel.shape[:2] + (3,))
                - obj_pos[:, None], dim=-1)
            pot_sel = pot_sel + cfg.grip_quality_weight * com_dist

        zero = torch.zeros((), device=dev)
        return GoalSet(
            grasps=torch.where(mask[..., None], grasps_sel, zero),
            reach_grasps=torch.where(mask[..., None, None], reach_sel, zero),
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
