"""Online goal-selection learner (FTL / FTC / Proj / Exp / MD), counterpart
of ``omg_planner_tpu/ops/learner.py`` (reference
``omg/online_learner.py``).

The candidate sweep interpolates from the current configuration to every
goal and scores the arc-length-weighted collision potential along the
way; the MD learner mixes five experts, each a Bregman projection onto
the shifted simplex.  The learner's step count ``t`` is a host float (it
only counts updates), so its cadence decisions need no device reads; the
Bregman projection's convergence loop reads its condition on the host.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import DeviceHorizon, OMGConfig
from ..models import api as model_api
from ..utils.diff import get_derivative
from ..utils.linalg import take_rows, top_k
from ..utils.spline import multi_linear_interpolate
from ..utils.sync import host_bool
from ..utils.vmap import vmap_scenes
from . import kernels
from .chomp import CostParams, GoalSet
from .sdf import (AnalyticScene, WorldPotential, sdf_potentials,
                  world_potential_lookup, world_potential_lookup_nearest)

NUM_EXPERTS = 5
_ETA_POWERS = (-2, -1, 0, 2, 4)  # reference online_learner.py:84


class LearnerState(NamedTuple):
    p: torch.Tensor             # [G] goal distribution
    sum_costs: torch.Tensor     # [G]
    experts_p: torch.Tensor     # [E, G]
    experts_costs: torch.Tensor  # [E]
    q: torch.Tensor             # [E] expert mixture
    t: float                    # learner step count (host)
    ti: torch.Tensor            # [G] per-goal selection counts
    active_idx: torch.Tensor    # [K] int64 lanes of the restricted sweep
    last_raw: torch.Tensor      # [G] last observed raw potentials


def sweep_restricted(cfg: OMGConfig, capacity: int) -> bool:
    """Is the per-step sweep restricted to the ``learner_active_goals``
    best-ranked lanes for this goal capacity?"""
    return bool(cfg.learner_active_goals and cfg.ol_alg != "Proj"
                and cfg.learner_active_goals < capacity)


def init_learner_state(goal_set: GoalSet,
                       active_goals: int = 0) -> LearnerState:
    g = goal_set.capacity
    dev = goal_set.grasps.device
    m = goal_set.mask.to(torch.float32)
    n = torch.clamp(m.sum(), min=1.0)
    uniform = m / n
    k = min(active_goals, g) if active_goals else 0
    z = torch.zeros(g, device=dev)
    return LearnerState(
        p=uniform, sum_costs=z,
        experts_p=uniform[None].repeat(NUM_EXPERTS, 1),
        experts_costs=torch.zeros(NUM_EXPERTS, device=dev),
        q=torch.ones(NUM_EXPERTS, device=dev) / NUM_EXPERTS,
        t=0.0, ti=z,
        active_idx=torch.zeros(k, dtype=torch.int64, device=dev),
        last_raw=z)


def find_zero(f, x0, x1, iters: int = 30):
    """Sign-bisection root finder (reference ``online_learner.py:17-29``),
    elementwise over a batch of brackets."""
    x = (x0 + x1) / 2.0
    s = (x1 - x0) / 4.0
    for _ in range(iters):
        x = x - s * torch.sign(f(x))
        s = s / 2.0
    return x


def bregman_projection(x, v, delta, w, mask, max_iters: int = 20,
                       tol: float = 1e-6, uniform_w: bool = True,
                       live=None, passes: bool = False):
    """Weighted/shifted-entropy Bregman projection onto the simplex
    (reference ``bp``, ``online_learner.py:32-58``), masked to valid goals,
    batched over rows: ``x, v [..., E, G]``; ``delta, w, mask [..., G]``
    (leading dims: scenes).

    Each row's fixed-point loop stops on its own alpha convergence (the
    JAX package's vmapped ``while_loop``: converged rows are frozen while
    others iterate); the "any row still running" condition is read on the
    host.  ``live [...]`` (optional) leaves the rows of the scenes it marks
    False out of the loop.  ``uniform_w`` solves the inner root in closed
    form (``el = log target - logsumexp(log shiftx + z)``, clipped to the
    bisection's bracket).  ``passes`` also returns each row's passes of
    the loop ``[..., E]``."""
    m = mask.to(x.dtype)[..., None, :]                        # [..., 1, G]
    delta = delta[..., None, :]
    w = w[..., None, :]
    target = 1.0 + torch.sum(delta * m, dim=-1)               # [..., 1]
    shiftx = (x + delta) * m                                  # [..., E, G]
    upper = torch.where(m > 0, w + v, torch.full_like(v, -torch.inf)
                        ).amax(-1)
    zero = torch.zeros_like(upper)

    def solve_el(alpha):
        z = (alpha - v) / w
        if uniform_w:
            logs = torch.where(m > 0,
                               torch.log(torch.clamp(shiftx, min=1e-30)) + z,
                               torch.full_like(z, -torch.inf))
            s = torch.logsumexp(logs, dim=-1)
            return torch.minimum(torch.maximum(torch.log(target) - s, zero),
                                 upper)

        def f(el):
            return torch.sum(shiftx * torch.exp(torch.clamp(
                el[..., None] / w + z, -60.0, 60.0)), dim=-1) - target

        return find_zero(f, zero, upper)

    rows = x.shape[:-1]
    it = torch.zeros(rows, dtype=torch.int64, device=x.device)
    alpha = torch.zeros_like(x)
    diff = torch.full(rows, torch.inf, device=x.device)
    if live is not None:
        diff = torch.where(live[..., None], diff, torch.zeros_like(diff))
    log_ratio = w * torch.log(delta / torch.clamp(shiftx, min=1e-20))
    while True:
        active = (diff > tol) & (it < max_iters)
        if not host_bool(active.any(), "learner.bregman"):
            break
        el = solve_el(alpha)
        alpha_prime = torch.clamp(v - el[..., None] + log_ratio,
                                  min=0.0) * m
        new_diff = torch.linalg.norm(alpha_prime - alpha, dim=-1)
        alpha = torch.where(active[..., None], alpha_prime, alpha)
        diff = torch.where(active, new_diff, diff)
        it = it + active.to(it.dtype)
    el = solve_el(alpha)
    y = shiftx * torch.exp(torch.clamp((el[..., None] + alpha - v) / w,
                                       -60.0, 60.0)) - delta
    y = torch.clamp(y * m, min=0.0)
    y = y / torch.clamp(torch.sum(y, dim=-1, keepdim=True), min=1e-12)
    return (y, it) if passes else y


def _start_index(cfg: OMGConfig, t: float) -> int:
    """``traj`` row the candidate sweep starts from, in float32 arithmetic
    as the JAX package computes it."""
    f = np.float32(t) / np.float32(cfg.optim_steps) * np.float32(cfg.timesteps)
    clamp = 1
    idx = min(clamp + int(np.int32(f)) - 1, cfg.timesteps - clamp)
    return max(idx, 0)


def cost_vector(model, scene, params: CostParams, cfg: OMGConfig,
                hp: DeviceHorizon, traj, goal_set: GoalSet, t: float,
                world_potential: WorldPotential | None = None):
    """Goal-candidate objective estimates [G] (reference ``:104-160``)."""
    raw = cost_vector_raw(model, scene, params, cfg, hp, traj, goal_set, t,
                          world_potential)
    return finalize_cost_vector(cfg, raw, goal_set.mask)


def _start_index_tensor(cfg: OMGConfig, t):
    """:func:`_start_index` of a float32 tensor of step counts."""
    f = t / np.float32(cfg.optim_steps) * np.float32(cfg.timesteps)
    return torch.clamp(torch.clamp(f.to(torch.int32), max=cfg.timesteps - 1),
                       min=0).long()


def cost_vector_raw(model, scene, params: CostParams, cfg: OMGConfig,
                    hp: DeviceHorizon, traj, goal_set: GoalSet, t: float,
                    world_potential: WorldPotential | None = None,
                    start_idx=None):
    """Unnormalized masked candidate potentials [G] (invalid goals -> 0).
    ``start_idx`` (a 0-d tensor) gives the sweep's start row instead of
    the host step count ``t`` (a scene batch's rows differ; a captured
    sweep reads it from a buffer)."""
    if start_idx is None:
        start_idx = _start_index(cfg, t)
        traj_start = traj[start_idx]
    else:
        # a gather: indexing with a 0-d tensor would read it on the host
        traj_start = traj.index_select(0, start_idx.reshape(1))[0]
    goals = goal_set.grasps  # [G, D]
    g = goals.shape[0]
    if cfg.parity_density:
        # the reference's shrinking sample density (online_learner.py:
        # 109-114): n_t = T - start interior samples, masked at capacity T
        n = cfg.timesteps
        n_t = cfg.timesteps - start_idx
        ks = torch.arange(n, device=traj.device)
        u = (ks + 1.0) / (n_t + 1.0)
        sample_valid = (ks < n_t).to(traj.dtype)
        interp = (traj_start[None, None, :]
                  + u[None, :, None]
                  * (goals[:, None, :] - traj_start[None, None, :]))
    else:
        n = cfg.num_interp
        interp = multi_linear_interpolate(traj_start, goals, n)  # [G,n,D]
    full = torch.cat([traj_start.expand(g, 1, goals.shape[-1]),
                      interp, goals[:, None, :]], dim=1)      # [G, n+2, D]
    flat_q = full.reshape(g * (n + 2), -1)

    score_model = model
    if (cfg.learner_collision_points
            and cfg.learner_collision_points < model.num_collision_points):
        stride = max(model.num_collision_points
                     // cfg.learner_collision_points, 1)
        score_model = model._replace(
            collision_points=model.collision_points[:, ::stride, :]
            [:, :cfg.learner_collision_points, :])
    _, x_full = model_api.fk_points(score_model, flat_q)
    n_links = model_api.num_links(score_model)
    p = x_full.shape[2]
    x_full = x_full.reshape(g, n + 2, n_links, p, 3)
    x = x_full[:, 1:-1]  # interior samples score the potential
    if (cfg.learner_world_potential and world_potential is not None
            and not isinstance(scene, AnalyticScene)):
        lookup = (world_potential_lookup_nearest
                  if cfg.learner_lookup == "nearest"
                  else world_potential_lookup)
        pot = lookup(world_potential, x.reshape(-1, 3))
    else:
        pot, _, _ = sdf_potentials(
            scene, params.inv_poses, x.reshape(-1, 3), params.epsilons,
            params.padding_scales, params.clearances, params.disables)
    pot = pot.reshape(g, n, n_links, p)

    # arc-length weights |dx/dt| along the interpolation axis
    x_start = x_full[:, 0]
    x_goal = x_full[:, -1]
    xs = torch.movedim(x, 1, 3)  # [G, 10, P, n, 3]
    if cfg.parity_density:
        prev = torch.cat([x_start[..., None, :], xs[..., :-1, :]], dim=-2)
        v = (xs - prev) / hp.time_interval
        speed = torch.linalg.norm(v, dim=-1) * sample_valid
    else:
        v = get_derivative(hp, xs, x_start, x_goal, 1)
        speed = torch.linalg.norm(v, dim=-1)
    collision = (torch.movedim(pot, 1, 3) * speed).sum(dim=(1, 2, 3))  # [G]

    # config-space distance term (online_learner.py:149-151)
    diff = torch.diff(traj_start[None, :] - goals, dim=-1)
    smooth = torch.linalg.norm(diff, dim=-1) ** 2
    potentials = (cfg.base_obstacle_weight * collision
                  + cfg.smoothness_base_weight * cfg.dist_eps * smooth)
    if cfg.grasp_optimize or cfg.grip_quality_weight:
        potentials = potentials + goal_set.potentials
    return torch.where(goal_set.mask, potentials,
                       torch.zeros_like(potentials))


def finalize_cost_vector(cfg: OMGConfig, potentials, mask):
    """Normalization + invalid-goal masking of the raw potentials [..., G]
    (leading dims: scenes)."""
    if cfg.normalize_cost:
        potentials = potentials / torch.clamp(
            torch.linalg.norm(potentials, dim=-1, keepdim=True), min=1e-12)
    return torch.where(mask, potentials, torch.full_like(potentials, 1e6))


def _one_hot_arg(fn, x, g):
    return torch.nn.functional.one_hot(fn(x, dim=-1), g).to(torch.float32)


def update_goal_dist(cfg: OMGConfig, state: LearnerState, cv,
                     goal_set: GoalSet, traj_end, live=None) -> LearnerState:
    """One online-learning update of the goal distribution (reference
    ``update_goal_dist`` + per-algorithm methods, ``:162-235``).  Tensors
    may carry leading scene dims (``cv [..., G]``, ``traj_end [..., D]``);
    ``live`` then keeps the Bregman loop to the scenes it marks."""
    mask = goal_set.mask
    alg = cfg.ol_alg
    if alg == "MD":
        # the expert update in one kernel launch (the plain version on the
        # CPU): the five Bregman projections, their costs, the q
        # recurrence and the mixture
        p, experts_p, experts_costs, q = kernels.md_update(
            state.experts_p, cv, mask, state.experts_costs, state.q, live,
            cfg.optim_steps)
        return state._replace(p=p, experts_p=experts_p,
                              experts_costs=experts_costs, q=q)

    mf = mask.to(cv.dtype)
    g = mask.shape[-1]
    n_valid = torch.clamp(mf.sum(-1), min=1.0)
    inf = torch.full_like(cv, torch.inf)

    if alg == "Proj":
        dists = torch.where(
            mask, torch.linalg.norm(traj_end[..., None, :] - goal_set.grasps,
                                    dim=-1), inf)
        return state._replace(p=_one_hot_arg(torch.argmin, dists, g))

    if alg == "FTL":
        sum_costs = state.sum_costs + cv
        p = _one_hot_arg(torch.argmin, torch.where(mask, sum_costs, inf), g)
        return state._replace(p=p, sum_costs=sum_costs)

    if alg == "FTC":
        p = _one_hot_arg(torch.argmin, torch.where(mask, cv, inf), g)
        return state._replace(p=p)

    if alg == "Exp":
        sum_costs = state.sum_costs + cv * mf
        norm_sum = sum_costs / (torch.sum(sum_costs, -1, keepdim=True) + 1e-8)
        eta = torch.sqrt(torch.log(n_valid + 1.0) / cfg.optim_steps)
        p_new = torch.exp(-eta[..., None] * cv) * state.p
        p = (p_new * 0.999 + norm_sum * 0.001) * mf
        p = p / (torch.sum(p, -1, keepdim=True) + 1e-8)
        return state._replace(p=p, sum_costs=sum_costs)

    raise ValueError(f"unknown ol_alg {alg}")


def update_goal(model, scene, params: CostParams, cfg: OMGConfig,
                hp: DeviceHorizon, traj, goal_set: GoalSet,
                state: LearnerState,
                world_potential: WorldPotential | None = None,
                cv_fn=None, start_idx=None):
    """Advance the learner one step and pick the argmax goal (reference
    ``update_goal``, ``:237-249``).  With the active-lane restriction only
    the K active lanes are scored, except every ``learner_refresh_every``
    steps, when a full sweep re-ranks all lanes.

    ``cv_fn(traj, t, mask) -> [G]`` overrides the candidate-cost
    evaluation (the goal-sharded plan of ``parallel/batch.py`` injects a
    local sweep and an all-gather here).  A caller-supplied ``cv_fn`` is
    authoritative: it disables the active-lane restriction.  ``mask`` is
    the current goal validity (the in-plan blacklist narrows it); an
    injected sweep applies it only at the finalize.  ``start_idx`` (a 0-d
    tensor) gives the restricted sweep's start row in place of the one
    the step count makes (a captured step reads it from a buffer).

    Returns (new_state, goal_idx 0-d int64 tensor)."""
    t = state.t + 1.0
    state = state._replace(t=t)
    restrict = (sweep_restricted(cfg, goal_set.capacity)
                and state.active_idx.shape[0] > 0
                and cv_fn is None)
    if cfg.ol_alg == "Proj":
        state = update_goal_dist(cfg, state, torch.zeros_like(goal_set.mask,
                                                              dtype=torch.float32),
                                 goal_set, traj[-1])
    elif restrict:
        k = min(cfg.learner_active_goals, goal_set.capacity)
        if cfg.learner_refresh_every and t % cfg.learner_refresh_every == 0:
            raw_full = cost_vector_raw(model, scene, params, cfg, hp, traj,
                                       goal_set, t, world_potential)
            cvn = finalize_cost_vector(cfg, raw_full, goal_set.mask)
            active = top_k(-cvn, k)[1]
        else:
            active = state.active_idx
            gs_small = GoalSet(*(take_rows(a, active) for a in goal_set))
            raw_small = cost_vector_raw(model, scene, params, cfg, hp, traj,
                                        gs_small, t, world_potential,
                                        start_idx=start_idx)
            raw_full = state.last_raw.index_copy(0, active, raw_small)
        cv = finalize_cost_vector(cfg, raw_full, goal_set.mask)
        state = state._replace(last_raw=raw_full, active_idx=active)
        state = update_goal_dist(cfg, state, cv, goal_set, traj[-1])
    else:
        cv = (cv_fn(traj, t, goal_set.mask) if cv_fn is not None else
              cost_vector(model, scene, params, cfg, hp, traj, goal_set, t,
                          world_potential))
        state = update_goal_dist(cfg, state, cv, goal_set, traj[-1])
    goal_idx = torch.argmax(torch.where(
        goal_set.mask, state.p, torch.full_like(state.p, -torch.inf)))
    ti = state.ti.index_add(0, goal_idx[None],
                            torch.ones(1, device=state.ti.device))
    return state._replace(ti=ti), goal_idx


def update_goal_batch(model, scene, params: CostParams, cfg: OMGConfig,
                      hp: DeviceHorizon, traj, goal_set: GoalSet,
                      state: LearnerState, t_host, live,
                      world_potential: WorldPotential | None = None):
    """:func:`update_goal` for S scenes in lockstep: ``scene``, ``params``,
    ``goal_set``, ``world_potential``, ``traj [S, T, D]`` and ``state``
    carry a leading scene axis; ``state.t`` is a float32 tensor [S] and
    ``t_host`` the same counts on the host (a blacklist restart resets one
    scene's, so each scene's sweep starts from its own row and refreshes
    on its own cadence).  ``live [S]`` keeps frozen scenes out of the
    Bregman loop; the caller discards their results.  The sweeps run under
    ``torch.func.vmap``: one set of operations for all S scenes.  Returns
    (state, goal_idx [S], t_host)."""
    t_host = [t + 1.0 for t in t_host]
    t = state.t + 1.0
    state = state._replace(t=t)
    start_idx = _start_index_tensor(cfg, t)
    mask = goal_set.mask
    cap = mask.shape[-1]

    def sweep(gs):
        return vmap_scenes(lambda sc, pa, tr, g, wp, si: cost_vector_raw(
            model, sc, pa, cfg, hp, tr, g, 0.0, wp, start_idx=si),
            scene, params, traj, gs, world_potential, start_idx)

    if cfg.ol_alg == "Proj":
        state = update_goal_dist(cfg, state, torch.zeros_like(
            mask, dtype=torch.float32), goal_set, traj[:, -1])
    elif sweep_restricted(cfg, cap) and state.active_idx.shape[-1] > 0:
        k = min(cfg.learner_active_goals, cap)
        every = cfg.learner_refresh_every
        refresh = [bool(every) and x % every == 0 for x in t_host]
        if any(refresh):
            raw_r = sweep(goal_set)
            active_r = top_k(-finalize_cost_vector(cfg, raw_r, mask), k)[1]
        if not all(refresh):
            active_s = state.active_idx
            small = GoalSet(*(torch.gather(a, 1, active_s.reshape(
                active_s.shape + (1,) * (a.ndim - 2)).expand(
                    active_s.shape + a.shape[2:])) for a in goal_set))
            raw_s = state.last_raw.scatter(-1, active_s, sweep(small))
        if all(refresh):
            raw_full, active = raw_r, active_r
        elif not any(refresh):
            raw_full, active = raw_s, active_s
        else:
            due = (t % every == 0)[:, None]
            raw_full = torch.where(due, raw_r, raw_s)
            active = torch.where(due, active_r, active_s)
        cv = finalize_cost_vector(cfg, raw_full, mask)
        state = state._replace(last_raw=raw_full, active_idx=active)
        state = update_goal_dist(cfg, state, cv, goal_set, traj[:, -1],
                                 live=live)
    else:
        cv = finalize_cost_vector(cfg, sweep(goal_set), mask)
        state = update_goal_dist(cfg, state, cv, goal_set, traj[:, -1],
                                 live=live)
    goal_idx = torch.argmax(torch.where(
        mask, state.p, torch.full_like(state.p, -torch.inf)), dim=-1)
    ti = state.ti.scatter_add(-1, goal_idx[:, None],
                              torch.ones_like(state.ti[:, :1]))
    return state._replace(ti=ti), goal_idx, t_host
