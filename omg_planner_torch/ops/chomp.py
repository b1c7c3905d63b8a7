"""CHOMP costs, functional gradients and the per-step optimizer update
(counterpart of ``omg_planner_tpu/ops/chomp.py``):

  FK -> body points -> SDF hinge potentials -> point Jacobians ->
  functional gradient (top-k masked) -> smoothness -> goal-set projection
  -> finger clamp -> joint-limit smoothing -> termination predicates.

The deviations from the reference's numerics that the JAX package
documents (top-k scatter accumulates; per-(timestep, link) cost report)
are kept, so both packages compute the same function.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DIFF_RULES, DIFF_RULE_LENGTH, DeviceHorizon, OMGConfig
from ..models import api as model_api
from ..utils.diff import get_derivative
from ..utils.linalg import top_k
from ..utils.sync import host_bool
from .sdf import WorldField, sdf_potentials, world_field_query


class CostParams(NamedTuple):
    """Per-scene collision parameters (``omg/cost.py:299-335``)."""

    inv_poses: torch.Tensor       # [O, 4, 4] world -> object
    epsilons: torch.Tensor        # [O]
    padding_scales: torch.Tensor  # [O]
    clearances: torch.Tensor      # [O]
    disables: torch.Tensor        # [O]
    target_idx: torch.Tensor      # scalar int


class GoalSet(NamedTuple):
    """Fixed-capacity goal set (masked)."""

    grasps: torch.Tensor        # [G, D] final grasp configs
    reach_grasps: torch.Tensor  # [G, tail, D] standoff tails (last == grasp)
    mask: torch.Tensor          # [G] bool valid
    potentials: torch.Tensor    # [G] collision potential at goal

    @property
    def capacity(self) -> int:
        return self.grasps.shape[0]

    @property
    def num_valid(self) -> torch.Tensor:
        """The number of valid goals, a 0-d tensor on the set's device."""
        return self.mask.sum()


class CostInfo(NamedTuple):
    """Per-step diagnostics (the reference's ``info`` dict,
    ``omg/cost.py:509-530``), as 0-d tensors (``cost_traj`` [T])."""

    cost: torch.Tensor
    obs: torch.Tensor
    smooth: torch.Tensor
    weighted_obs: torch.Tensor
    weighted_smooth: torch.Tensor
    grad_norm: torch.Tensor
    smooth_grad_norm: torch.Tensor
    obs_grad_norm: torch.Tensor
    collide: torch.Tensor
    reach: torch.Tensor
    terminate: torch.Tensor
    failure_terminate: torch.Tensor
    execute: torch.Tensor
    violate_limit: torch.Tensor
    cost_traj: torch.Tensor


def smooth_loss(hp: DeviceHorizon, cfg: OMGConfig, xi, start, end):
    """Finite-difference velocity-norm smoothness (``omg/cost.py:425-449``).
    Returns (loss [T+1], grad [T, dof])."""
    d1 = hp.diff_matrices[0]
    mid = DIFF_RULE_LENGTH // 2
    # built out of place, so torch.func.vmap can batch it over scenes
    first = float(DIFF_RULES[0][mid - 1]) * start / hp.time_interval
    last = (torch.zeros_like(end) if cfg.goal_set_proj
            else float(DIFF_RULES[0][mid]) * end / hp.time_interval)
    ed = torch.cat([first[None], xi.new_zeros((xi.shape[0] - 1,
                                               xi.shape[1])), last[None]])
    velocity = d1 @ xi
    vel_norm = torch.linalg.norm(velocity + ed, dim=1)
    loss = 0.5 * vel_norm**2
    grad = hp.A @ xi + d1.T @ ed
    return loss, grad


def forward_kinematics_obstacle(model, scene, params: CostParams,
                                cfg: OMGConfig, hp: DeviceHorizon, xi,
                                start, end,
                                world_field: WorldField | None = None):
    """FK + SDF + derivatives for the whole trajectory
    (``omg/cost.py:112-190``).  With ``world_field`` (``cfg.sdf_fused``)
    one 5-channel read of the fused field replaces the per-object query.
    Returns (x, v, a_ws, jac, potentials, grads, collide_count) with
    x/v/a_ws [T, L, P, 3], jac [T, L, P, D, 3], potentials [T, L, P]."""
    t_dim = xi.shape[0]
    _, origins_w, axes_w, x = model_api.fk_points(model, xi,
                                                  joint_info=True)
    p = x.shape[2]
    if world_field is not None:
        pot, grad, collide = world_field_query(world_field, x.reshape(-1, 3))
    else:
        pot, grad, collide = sdf_potentials(
            scene, params.inv_poses, x.reshape(-1, 3), params.epsilons,
            params.padding_scales, params.clearances, params.disables)
    n_links = model_api.num_links(model)
    pot = pot.reshape(t_dim, n_links, p)
    grad = grad.reshape(t_dim, n_links, p, 3)
    collide = collide.reshape(t_dim, n_links, p)

    if cfg.uncheck_finger_collision == -1:
        # soften finger potentials (omg/cost.py:350-353)
        fmask = torch.as_tensor(model_api.finger_link_mask(model),
                                dtype=pot.dtype, device=pot.device)
        scale = 1.0 - 0.9 * fmask
        pot = pot * scale[None, :, None]
        grad = grad * scale[None, :, None, None]
        collide = collide * (1.0 - fmask)[None, :, None]

    jac = model_api.point_jacobians(model, origins_w, axes_w, x)
    x_start, x_end = model_api.end_points(model, start, end)
    xs = torch.movedim(x, 0, 2)  # [10, P, T, 3]
    v = get_derivative(hp, xs, x_start, x_end, 1)
    a_ws = get_derivative(hp, xs, x_start, x_end, 2)
    v = torch.movedim(v, 2, 0)
    a_ws = torch.movedim(a_ws, 2, 0)
    return x, v, a_ws, jac, pot, grad, collide.sum()


def _functional_grad_terms(v, a_ws, pot, grad):
    """CHOMP workspace functional gradient terms (``omg/cost.py:24-43``)::

        cost = pot * |v|
        dir  = |v| P g - pot P a / |v|^2,   P = I - v_hat v_hat^T
    """
    vel_norm = torch.linalg.norm(v, dim=-1, keepdim=True)
    cost = pot * vel_norm[..., 0]
    v_hat = v / (vel_norm + 1e-8)

    def proj(w):
        return w - v_hat * torch.sum(v_hat * w, dim=-1, keepdim=True)

    curv = pot[..., None] * proj(a_ws) / (vel_norm**2 + 1e-8)
    direction = vel_norm * proj(grad) - curv
    return cost, direction


def compute_collision_loss(model, scene, params: CostParams, cfg: OMGConfig,
                           hp: DeviceHorizon, xi, start, end,
                           world_field: WorldField | None = None):
    """Obstacle loss + config-space gradient (``omg/cost.py:362-423``),
    top-k sparsified as a mask: points at or above the k-th largest
    potential contribute.  Returns (obs_cost [T, L], obs_grad [T, D],
    collide_count)."""
    t_dim = xi.shape[0]
    x, v, a_ws, jac, pot, grad, collide = forward_kinematics_obstacle(
        model, scene, params, cfg, hp, xi, start, end, world_field)
    p = pot.shape[-1]
    cost_pt, direction = _functional_grad_terms(v, a_ws, pot, grad)

    total = t_dim * model_api.num_links(model) * p
    k = cfg.top_k_collision
    if k and k < total:
        kth = top_k(pot.reshape(-1), k)[0][-1]
        sel = (pot >= kth).to(pot.dtype)
    else:
        sel = torch.ones_like(pot)

    if not cfg.consider_finger and k:
        # finger links are excluded in the top-k branch (omg/cost.py:401-402)
        link_mask = 1.0 - torch.as_tensor(
            model_api.finger_link_mask(model), dtype=pot.dtype,
            device=pot.device)
        sel = sel * link_mask[None, :, None]

    if cfg.ref_topk_quirks and k:
        # the reference's top-k quirks (omg/cost.py:404-421): one gradient
        # point per (timestep, link), per-link cost broadcast over time
        score = torch.where(sel > 0, pot, torch.full_like(pot, -torch.inf))
        best = torch.argmax(score, dim=-1)
        onehot = torch.nn.functional.one_hot(best, p).to(pot.dtype)
        any_sel = (sel.sum(-1, keepdim=True) > 0).to(pot.dtype)
        gsel = onehot * any_sel
        obs_cost = (cost_pt * sel).sum((0, -1))[None, :].expand(
            cost_pt.shape[:2])
        obs_grad = torch.einsum("tjpdc,tjpc->td", jac,
                                direction * gsel[..., None])
        return obs_cost, obs_grad, collide

    obs_cost = (cost_pt * sel).sum(-1)  # [T, 10]
    obs_grad = torch.einsum("tjpdc,tjpc->td", jac, direction * sel[..., None])
    return obs_cost, obs_grad, collide


def compute_total_loss(model, scene, params: CostParams, cfg: OMGConfig,
                       hp: DeviceHorizon, xi, start, end, goal,
                       obstacle_weight, smoothness_weight,
                       world_field: WorldField | None = None):
    """Total cost/gradient/termination info (``omg/cost.py:451-532``)."""
    s_loss, s_grad = smooth_loss(hp, cfg, xi, start, end)
    o_cost, o_grad, collide = compute_collision_loss(
        model, scene, params, cfg, hp, xi, start, end, world_field)

    s_sum = s_loss.sum()
    o_sum = o_cost.sum()
    w_obs = obstacle_weight * o_sum
    w_smooth = smoothness_weight * s_sum
    w_obs_grad = torch.clamp(obstacle_weight * o_grad,
                             -cfg.clip_grad_scale, cfg.clip_grad_scale)
    w_smooth_grad = smoothness_weight * s_grad
    cost = w_obs + w_smooth
    grad = w_obs_grad + w_smooth_grad
    cost_traj = (obstacle_weight * o_cost.sum(-1)
                 + smoothness_weight * s_loss[:-1])

    goal_dist = (torch.linalg.norm(xi[-1] - goal) if cfg.goal_set_proj
                 else torch.zeros((), dtype=xi.dtype, device=xi.device))
    if cfg.pre_terminate:
        terminate = ((collide <= cfg.allow_collision_point)
                     & (goal_dist < 0.01)
                     & (s_sum < cfg.terminate_smooth_loss))
    else:
        terminate = torch.zeros((), dtype=torch.bool, device=xi.device)
    failure = ((collide >= cfg.allow_collision_point * 10)
               | (s_sum >= cfg.terminate_smooth_loss * 2.5))
    execute = ((collide <= cfg.allow_collision_point)
               & (s_sum < cfg.terminate_smooth_loss))

    info = CostInfo(
        cost=cost, obs=o_sum, smooth=s_sum,
        weighted_obs=w_obs, weighted_smooth=w_smooth,
        grad_norm=torch.linalg.norm(grad),
        smooth_grad_norm=torch.linalg.norm(w_smooth_grad),
        obs_grad_norm=torch.linalg.norm(w_obs_grad),
        collide=collide, reach=goal_dist,
        terminate=terminate, failure_terminate=failure, execute=execute,
        violate_limit=torch.zeros((), dtype=torch.bool, device=xi.device),
        cost_traj=cost_traj,
    )
    return cost, grad, info


def goal_set_projection_update(hp: DeviceHorizon, cfg: OMGConfig, xi, grad,
                               chosen_tail, step_size):
    """Projected CHOMP step (``omg/optimizer.py:88-113``) with the
    precomputed ``P_k``/``M_k`` operators."""
    k = cfg.reach_tail_length if cfg.use_standoff else 1
    m_k, p_k = hp.proj[k]
    b = xi[-k:] - chosen_tail
    return -step_size * (p_k @ grad) - m_k @ b


def unconstrained_update(hp: DeviceHorizon, grad, step_size):
    """``-eta * Ainv @ grad`` (``omg/optimizer.py:132``)."""
    return -step_size * (hp.Ainv @ grad)


def apply_update(model, cfg: OMGConfig, xi, update):
    """Trajectory update + gripper clamp (``omg/core.py:43-51``); gripper
    dofs are frozen unless ``cfg.consider_finger``."""
    if cfg.consider_finger:
        xi = xi + update
    else:
        arm = torch.as_tensor(model_api.arm_dof_mask(model), dtype=xi.dtype,
                              device=xi.device)
        xi = xi + update * arm[None, :]
    return model_api.gripper_clamp(model, xi)


def _limit_violation(xi, lower, upper):
    return (lower - xi) * (xi < lower) + (upper - xi) * (xi > upper)


def _limit_step(hp: DeviceHorizon, xi, tv):
    """One smoothing pass: ``xi + scale * Ainv @ tv``."""
    tvs = hp.Ainv @ tv
    flat_idx = torch.argmax(torch.abs(tv))
    scale = (torch.abs(tv).max()
             / (torch.abs(tvs.reshape(-1)[flat_idx]) + 1e-8))
    return xi + scale * tvs


def handle_joint_limit(hp: DeviceHorizon, cfg: OMGConfig, xi, lower, upper):
    """Smoothed joint-limit projection (``omg/optimizer.py:148-164``):
    repeatedly add ``scale * Ainv @ violation`` while the violation norm
    exceeds 1e-2, at most ``joint_limit_max_steps`` times.  Each check is a
    host read."""
    tv = _limit_violation(xi, lower, upper)
    cnt = 0
    while (cnt < cfg.joint_limit_max_steps
           and host_bool(torch.linalg.norm(tv) > 1e-2)):
        xi = _limit_step(hp, xi, tv)
        cnt += 1
        tv = _limit_violation(xi, lower, upper)
    return xi


def handle_joint_limit_batch(hp: DeviceHorizon, cfg: OMGConfig, xi, lower,
                             upper, live):
    """:func:`handle_joint_limit` for S scenes in lockstep: ``xi [S, T,
    D]``, ``lower``/``upper [S, D]``.  Each scene's loop runs while its own
    violation norm (over its whole trajectory) exceeds 1e-2, and only while
    ``live [S]``; a scene whose loop has ended keeps its trajectory.  One
    host read ("any scene still running") per pass."""
    vmap = torch.func.vmap
    lo, hi = lower[:, None, :], upper[:, None, :]
    tv = _limit_violation(xi, lo, hi)

    def over(tv):
        return vmap(torch.linalg.norm)(tv) > 1e-2

    run = live & over(tv)
    cnt = 0
    while cnt < cfg.joint_limit_max_steps and host_bool(run.any()):
        step = vmap(lambda x, t: _limit_step(hp, x, t))(xi, tv)
        xi = torch.where(run[:, None, None], step, xi)
        cnt += 1
        tv = _limit_violation(xi, lo, hi)
        run = run & over(tv)
    return xi


def check_joint_limit(xi, lower, upper):
    """Reference ``check_joint_limit`` (``omg/optimizer.py:166-174``) —
    including its quirk of ANDing the low/high masks elementwise."""
    low = (xi < lower - 5e-3).any()
    high = xi > upper + 5e-3
    return (low * high).any()
