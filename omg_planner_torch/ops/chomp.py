"""CHOMP costs, functional gradients and the per-step optimizer update
(counterpart of ``omg_planner_tpu/ops/chomp.py``):

  FK -> body points -> SDF hinge potentials -> point Jacobians ->
  functional gradient (top-k masked) -> smoothness -> goal-set projection
  -> finger clamp -> joint-limit smoothing -> termination predicates.

The deviations from the reference's numerics that the JAX package
documents (top-k scatter accumulates; per-(timestep, link) cost report)
are kept, so both packages compute the same function.

A plan step is FK and the query, then two kernels (``ops/kernels.py``):
``chomp_obstacle`` (:func:`compute_collision_loss`) and ``chomp_step``
(:func:`chomp_step`), before the ``joint_limit`` projection.  The other
functions here (:func:`forward_kinematics_obstacle`,
:func:`smooth_loss`, :func:`compute_total_loss`, the update pieces) are
the plain versions' pieces, which the tests hold against the JAX
package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import DeviceHorizon, OMGConfig
from ..models import api as model_api
from . import kernels
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


def info_from(floats, flags) -> CostInfo:
    """The :class:`CostInfo` of ``chomp_step``'s packed outputs: views of
    ``floats [..., 10 + T]`` and ``flags [..., 4]``."""
    n = len(kernels.INFO_SCALARS)
    return CostInfo(*floats[..., :n].unbind(-1), *flags.unbind(-1),
                    floats[..., n:])


def smooth_loss(hp: DeviceHorizon, cfg: OMGConfig, xi, start, end):
    """Finite-difference velocity-norm smoothness (``omg/cost.py:425-449``).
    Returns (loss [T+1], grad [T, dof])."""
    return kernels.smooth_terms(hp.diff_matrices[0], hp.A, hp.time_interval,
                                xi, start, end, cfg.goal_set_proj)


def _fk_query(model, scene, params: CostParams, xi,
              world_field: WorldField | None):
    """FK of the trajectory and the collision query of its body points:
    (x [T, L, P, 3], joint origins and axes [T, J, 3], pot [T, L, P], grad
    [T, L, P, 3], collide [T, L, P])."""
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
    return (x, origins_w, axes_w, pot.reshape(t_dim, n_links, p),
            grad.reshape(t_dim, n_links, p, 3),
            collide.reshape(t_dim, n_links, p))


def forward_kinematics_obstacle(model, scene, params: CostParams,
                                cfg: OMGConfig, hp: DeviceHorizon, xi,
                                start, end,
                                world_field: WorldField | None = None):
    """FK + SDF + derivatives for the whole trajectory
    (``omg/cost.py:112-190``): the per-point terms of the plain
    ``chomp_obstacle``.  With ``world_field`` (``cfg.sdf_fused``) one
    5-channel read of the fused field replaces the per-object query.
    Returns (x, v, a_ws, jac, potentials, grads, collide_count) with
    x/v/a_ws [T, L, P, 3], jac [T, L, P, D, 3], potentials [T, L, P]."""
    x, og, ax, pot, grad, collide = _fk_query(model, scene, params, xi,
                                              world_field)
    x_start, x_end = model_api.end_points(model, start, end)
    return (x,) + kernels.obstacle_point_terms(
        x, og, ax, x_start, x_end, pot, grad, collide, hp.diff_matrices,
        model_api.jacobian_tables(model), hp.time_interval,
        cfg.uncheck_finger_collision == -1)


def compute_collision_loss(model, scene, params: CostParams, cfg: OMGConfig,
                           hp: DeviceHorizon, xi, start, end,
                           world_field: WorldField | None = None):
    """Obstacle loss + config-space gradient (``omg/cost.py:362-423``),
    top-k sparsified as a mask: points at or above the k-th largest
    potential contribute.  FK and the query, then one ``chomp_obstacle``
    call.  Returns (obs_cost [T, L], obs_grad [T, D], collide_count)."""
    x, og, ax, pot, grad, collide = _fk_query(model, scene, params, xi,
                                              world_field)
    x_start, x_end = model_api.end_points(model, start, end)
    return kernels.chomp_obstacle(
        x, og, ax, x_start, x_end, pot, grad, collide, hp.diff_matrices,
        model_api.jacobian_tables(model), hp.time_interval,
        cfg.top_k_collision, cfg.consider_finger,
        cfg.uncheck_finger_collision == -1, cfg.ref_topk_quirks)


def compute_total_loss(model, scene, params: CostParams, cfg: OMGConfig,
                       hp: DeviceHorizon, xi, start, end, goal,
                       obstacle_weight, smoothness_weight,
                       world_field: WorldField | None = None):
    """Total cost/gradient/termination info (``omg/cost.py:451-532``), on
    the plain ``chomp_step``'s terms (``violate_limit`` false)."""
    s_loss, s_grad = smooth_loss(hp, cfg, xi, start, end)
    o_cost, o_grad, collide = compute_collision_loss(
        model, scene, params, cfg, hp, xi, start, end, world_field)
    grad, floats, flags = kernels.loss_terms(
        s_loss, s_grad, o_cost, o_grad, collide, xi, goal, obstacle_weight,
        smoothness_weight, cfg.clip_grad_scale,
        float(cfg.allow_collision_point), cfg.terminate_smooth_loss,
        cfg.goal_set_proj, cfg.pre_terminate)
    info = info_from(floats, torch.stack(
        flags + (torch.zeros((), dtype=torch.bool, device=xi.device),)))
    return info.cost, grad, info


def _update_operators(hp: DeviceHorizon, cfg: OMGConfig):
    """(P, M) of the CHOMP update: ``P_k`` and ``M_k`` of the goal-set
    projection, or Ainv and None."""
    if not cfg.goal_set_proj:
        return hp.Ainv, None
    k = cfg.reach_tail_length if cfg.use_standoff else 1
    m_k, p_k = hp.proj[k]
    return p_k, m_k


def chomp_step(model, cfg: OMGConfig, hp: DeviceHorizon, xi, start, goal,
               tail, obs, weights, lower, upper):
    """One CHOMP step after the obstacle terms ``obs`` = (obs_cost,
    obs_grad, collide) of :func:`compute_collision_loss`: smoothness, the
    weighted cost and gradient, the termination flags, the joint-limit
    check and the update (``omg/optimizer.py:88-135``), before the
    joint-limit projection; ``weights`` = (obstacle, smoothness, step
    size).  One ``chomp_step`` call.  Returns (trajectory, info)."""
    new_xi, floats, flags = chomp_step_packed(model, cfg, hp, xi, start, goal,
                                              tail, obs, weights, lower,
                                              upper)
    return new_xi, info_from(floats, flags)


def chomp_step_packed(model, cfg: OMGConfig, hp: DeviceHorizon, xi, start,
                      goal, tail, obs, weights, lower, upper):
    """:func:`chomp_step` with the info as the kernel packs it: (trajectory,
    floats [10 + T], flags [4]), of which :func:`info_from` makes the
    :class:`CostInfo`."""
    pmat, mmat = _update_operators(hp, cfg)
    return kernels.chomp_step(
        xi, start, goal, tail, *obs, *weights, lower, upper,
        hp.diff_matrices[0], hp.A, pmat, mmat, model_api.dof_tables(model),
        hp.time_interval, cfg.clip_grad_scale,
        float(cfg.allow_collision_point), cfg.terminate_smooth_loss,
        cfg.goal_set_proj, cfg.pre_terminate, cfg.consider_finger)


def goal_set_projection_update(hp: DeviceHorizon, cfg: OMGConfig, xi, grad,
                               chosen_tail, step_size):
    """Projected CHOMP step (``omg/optimizer.py:88-113``) with the
    precomputed ``P_k``/``M_k`` operators."""
    p_k, m_k = _update_operators(hp, cfg)
    return kernels.projected_update(p_k, m_k, xi, grad, chosen_tail,
                                    step_size)


def unconstrained_update(hp: DeviceHorizon, grad, step_size):
    """``-eta * Ainv @ grad`` (``omg/optimizer.py:132``)."""
    return -step_size * (hp.Ainv @ grad)


def apply_update(model, cfg: OMGConfig, xi, update):
    """Trajectory update + gripper clamp (``omg/core.py:43-51``); gripper
    dofs are frozen unless ``cfg.consider_finger``."""
    return kernels.dof_update(model_api.dof_tables(model),
                              cfg.consider_finger, xi, update)


def handle_joint_limit(hp: DeviceHorizon, cfg: OMGConfig, xi, lower, upper):
    """Smoothed joint-limit projection (``omg/optimizer.py:148-164``):
    repeatedly add ``scale * Ainv @ violation`` while the violation norm
    exceeds 1e-2, at most ``joint_limit_max_steps`` times.  One launch of
    the ``joint_limit`` kernel on the card; on the CPU its plain version,
    where each check is a host read."""
    return kernels.joint_limit(xi, lower, upper, hp.Ainv, None,
                               cfg.joint_limit_max_steps)


def handle_joint_limit_batch(hp: DeviceHorizon, cfg: OMGConfig, xi, lower,
                             upper, live):
    """:func:`handle_joint_limit` for S scenes in lockstep: ``xi [S, T,
    D]``, ``lower``/``upper [S, D]``.  Each scene's loop runs while its own
    violation norm (over its whole trajectory) exceeds 1e-2, and only while
    ``live [S]``; a scene whose loop has ended keeps its trajectory.  One
    launch for every scene on the card; on the CPU one host read ("any
    scene still running") a pass."""
    return kernels.joint_limit(xi, lower, upper, hp.Ainv, live,
                               cfg.joint_limit_max_steps)


def check_joint_limit(xi, lower, upper):
    """Reference ``check_joint_limit`` (``omg/optimizer.py:166-174``) —
    including its quirk of ANDing the low/high masks elementwise."""
    return kernels.limit_violated(xi, lower, upper)
