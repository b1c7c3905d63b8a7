"""Articulated rigid-body dynamics of the Panda arm (counterpart of
``omg_planner_tpu/physics/dynamics.py``).

A closed-form Lagrangian over the FK chain: every link's world Jacobian
from one FK call (``models/panda.py::forward_kinematics(apply_offset=False,
return_joint_info=True)``), the mass matrix ``M = sum_l m_l J_v^T J_v +
i_l J_w^T J_w`` (every URDF link inertia is isotropic), the Coriolis and
centrifugal bias from ``torch.func.jvp``/``torch.func.grad`` of the mass
matrix's quadratic form, and Cholesky solves for the forward dynamics.
Inertial constants are the reference URDF's
(``bullet/models/panda/panda_gripper.urdf``); gravity is -9.81
(``bullet/panda_scene.py:208``).  Joint vectors use the 9-DOF layout
(7 arm revolute + 2 finger prismatic); functions take one configuration.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jvp

from ..models import panda

# link inertial data of the reference URDF, link1..link7, hand, fingers
LINK_MASSES = np.asarray(
    [2.34, 2.36, 2.38, 2.43, 3.5, 1.47, 0.45, 0.68, 0.01, 0.01])
# ixx = iyy = izz per link: the world inertia is that scalar times I
LINK_INERTIAS = np.asarray(
    [0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.3, 0.1, 0.1, 0.1])
GRAVITY = 9.81
# per-joint effort limits of the URDF <limit effort=...> tags (the
# reference's Panda class overrides them with a uniform 250 N m)
JOINT_EFFORT_LIMITS = np.asarray(
    [87.0, 87.0, 87.0, 87.0, 12.0, 12.0, 12.0, 20.0, 20.0])


def _const(a, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def link_jacobians(model: panda.PandaModel, q9: torch.Tensor):
    """World-frame link Jacobians at ``q9 [9]``: ``(J_v [10, 3, 9],
    J_w [10, 3, 9], p [10, 3])``; COMs sit at the link-frame origins."""
    poses, origins, axes = panda.forward_kinematics(
        model, q9, apply_offset=False, return_joint_info=True)
    p = poses[:, :3, 3]                                   # [10, 3]
    # revolute columns: joint j moves link l iff j <= l (every joint moves
    # the hand and finger links)
    link_idx = torch.arange(10, device=q9.device)
    active = (torch.arange(7, device=q9.device)[None, :]
              <= torch.clamp(link_idx, max=6)[:, None])
    actf = active[..., None].to(q9.dtype)                 # [10, 7, 1]
    lever = p[:, None, :] - origins[None, :7, :]          # [10, 7, 3]
    jv_rev = torch.linalg.cross(axes[None, :7, :].expand_as(lever), lever,
                                dim=-1) * actf
    jw_rev = axes[None, :7, :].expand(10, 7, 3) * actf
    # prismatic finger columns: q[7] moves link 8 along axes[8], q[8] moves
    # link 9 along axes[9]
    sel = torch.zeros(10, 2, 1, dtype=q9.dtype, device=q9.device)
    sel[8, 0] = 1.0
    sel[9, 1] = 1.0
    jv_fing = sel * torch.stack([axes[8], axes[9]])[None]  # [10, 2, 3]
    jw_fing = torch.zeros_like(jv_fing)
    j_v = torch.cat([jv_rev, jv_fing], dim=1)             # [10, 9, 3]
    j_w = torch.cat([jw_rev, jw_fing], dim=1)
    return j_v.transpose(1, 2), j_w.transpose(1, 2), p


def mass_matrix(model: panda.PandaModel, q9: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia matrix ``M(q) [9, 9]`` (symmetric PD)."""
    j_v, j_w, _ = link_jacobians(model, q9)
    m = _const(LINK_MASSES, q9)
    i = _const(LINK_INERTIAS, q9)
    return (torch.einsum("l,lai,laj->ij", m, j_v, j_v)
            + torch.einsum("l,lai,laj->ij", i, j_w, j_w))


def potential_energy(model: panda.PandaModel,
                     q9: torch.Tensor) -> torch.Tensor:
    """Gravitational potential ``V(q)`` (zero level: world z = 0)."""
    poses = panda.forward_kinematics(model, q9, apply_offset=False)
    return GRAVITY * torch.sum(_const(LINK_MASSES, q9) * poses[:, 2, 3])


def kinetic_energy(model: panda.PandaModel, q9: torch.Tensor,
                   qd9: torch.Tensor) -> torch.Tensor:
    return 0.5 * qd9 @ mass_matrix(model, q9) @ qd9


def gravity_torque(model: panda.PandaModel, q9: torch.Tensor) -> torch.Tensor:
    """``g(q) = dV/dq``: a static hold needs ``+g(q)``."""
    return grad(lambda q: potential_energy(model, q))(q9)


def bias_torque(model: panda.PandaModel, q9: torch.Tensor,
                qd9: torch.Tensor) -> torch.Tensor:
    """Coriolis/centrifugal + gravity bias ``c(q, qd) + g(q)``: ``Mdot qd``
    from a jvp of ``q -> M(q) qd`` along ``qd``, minus the gradient of the
    quadratic form ``1/2 qd^T M(q) qd``."""
    mdot_qd = jvp(lambda q: mass_matrix(model, q) @ qd9, (q9,), (qd9,))[1]
    quad = grad(lambda q: 0.5 * qd9 @ mass_matrix(model, q) @ qd9)(q9)
    return mdot_qd - quad + gravity_torque(model, q9)


def inverse_dynamics(model: panda.PandaModel, q9: torch.Tensor,
                     qd9: torch.Tensor, qdd9: torch.Tensor) -> torch.Tensor:
    """``tau = M(q) qdd + c(q, qd) + g(q)`` (the reference's
    ``calculateInverseDynamics``, ``panda_gripper.py:191-192``)."""
    return mass_matrix(model, q9) @ qdd9 + bias_torque(model, q9, qd9)


def forward_dynamics(model: panda.PandaModel, q9: torch.Tensor,
                     qd9: torch.Tensor, tau9: torch.Tensor) -> torch.Tensor:
    """``qdd = M(q)^-1 (tau - c - g)`` by Cholesky (M is SPD)."""
    m = mass_matrix(model, q9)
    rhs = tau9 - bias_torque(model, q9, qd9)
    chol = torch.linalg.cholesky(m)
    return torch.cholesky_solve(rhs[:, None], chol)[:, 0]
