"""The robot-model protocol the planner consumes (counterpart of
``omg_planner_tpu/models/api.py``).  The CHOMP/plan stack calls these
functions, never ``panda.*`` or ``chain.*`` directly, so any model of the
protocol plans: :class:`~.panda.PandaModel` (the Panda's own FK tables)
and :class:`~.chain.ChainModel` (any URDF serial chain).  Dispatch is
``isinstance`` on the host.

Shapes: L links, P points per link, D dofs (9 for the Panda).  Goal-set
construction stays Panda specific (it encodes the ``panda_hand`` grasp
frame); a chain plans with ``goal_set_proj=False`` or an external goal
set.

A :class:`~.panda.PandaModel`'s FK runs through the ``panda_fk`` kernel
(``ops/kernels.py``): on the card one launch a call, on the CPU its plain
version (``panda.fk_batch_tables``).  :func:`fk_points` and
:func:`end_points` are the fused forms that also return the body points.
``fk_one`` and ``end_points`` keep the single-configuration FK
(``panda.forward_kinematics``) on the CPU, as the JAX package computes
it.  Nothing differentiates through these functions (the kernel has no
gradient); ``physics/dynamics.py`` and the IK call ``panda`` directly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from . import chain as chain_mod
from . import panda as panda_mod
from .chain import FIXED, PRISMATIC, ChainModel
from .panda import PandaModel


def num_links(model) -> int:
    return model.collision_points.shape[0]


def dof(model) -> int:
    if isinstance(model, PandaModel):
        return panda_mod.DOF
    return model.num_dof


def _chain_tables(model: ChainModel):
    """(dof -> joint-row index, affect [L, D], prismatic [D]) on the host."""
    jt = np.asarray(model.jtype)
    moving = np.where(jt != FIXED)[0]
    links = np.arange(len(jt))
    affect = (links[:, None] >= moving[None, :]).astype(np.float32)
    prismatic = (jt[moving] == PRISMATIC).astype(np.float32)
    return moving, affect, prismatic


def _panda_fk(model: PandaModel, q: torch.Tensor, with_points: bool):
    return kernels.panda_fk(q, model.pose_0, model.chain_post,
                            model.center_offset, model.collision_points,
                            True, with_points)


def fk_with_joint_info_batch(model, q: torch.Tensor):
    if isinstance(model, PandaModel):
        return _panda_fk(model, q, False)[:3]
    return chain_mod.chain_fk_with_joint_info_batch(model, q)


def fk_one(model, q: torch.Tensor):
    if isinstance(model, PandaModel):
        if q.device.type == "cuda":
            return _panda_fk(model, q[None], False)[0][0]
        return panda_mod.forward_kinematics(model, q)
    return chain_mod.chain_fk(model, q)


def fk_batch(model, q: torch.Tensor):
    if isinstance(model, PandaModel):
        return _panda_fk(model, q, False)[0]
    return chain_mod.chain_fk_batch(model, q)


def fk_points(model, q: torch.Tensor, joint_info: bool = False):
    """FK and body points of configurations ``q [n, D]``: (poses [n, L, 4,
    4], x [n, L, P, 3]), or (poses, origins, axes, x) with
    ``joint_info``."""
    if isinstance(model, PandaModel):
        poses, og, ax, x = _panda_fk(model, q, True)
    else:
        poses, og, ax = chain_mod.chain_fk_with_joint_info_batch(model, q)
        x = point_positions(model, poses)
    return (poses, og, ax, x) if joint_info else (poses, x)


def end_points(model, start: torch.Tensor, end: torch.Tensor):
    """Body points ``[L, P, 3]`` of the two configurations ``start`` and
    ``end`` ``[D]``; one FK launch for both on the card."""
    if isinstance(model, PandaModel) and start.device.type == "cuda":
        x = _panda_fk(model, torch.stack([start, end]), True)[3]
        return x[0], x[1]
    return (point_positions(model, fk_one(model, start)),
            point_positions(model, fk_one(model, end)))


def point_positions(model, poses: torch.Tensor):
    # the broadcast multiply-add form reads only model.collision_points
    return panda_mod.collision_point_positions(model, poses)


def point_jacobians(model, origins_w, axes_w, x):
    """[n, L, P, D, 3] linear point Jacobians: the formula of
    ``panda.point_jacobians`` driven by the chain's host tables."""
    if isinstance(model, PandaModel):
        return panda_mod.point_jacobians(model, origins_w, axes_w, x)
    d2j, affect, prismatic = _chain_tables(model)
    dev, dt = x.device, x.dtype
    d2j = torch.as_tensor(d2j, device=dev)
    ax = axes_w[:, d2j, :]
    og = origins_w[:, d2j, :]
    rel = x[:, :, :, None, :] - og[:, None, None, :, :]   # [n, L, P, D, 3]
    axb = ax[:, None, None].expand(rel.shape)
    rev = torch.linalg.cross(axb, rel, dim=-1)
    p_mask = torch.as_tensor(prismatic, dtype=dt,
                             device=dev)[None, None, None, :, None]
    jac = rev * (1.0 - p_mask) + axb * p_mask
    return jac * torch.as_tensor(affect, dtype=dt,
                                 device=dev)[None, :, None, :, None]


def tip_pose(model, q: torch.Tensor):
    """The tool frame at ``q``: ``panda_hand`` for the Panda, the last link
    of a chain."""
    if isinstance(model, PandaModel):
        return panda_mod.hand_pose(model, q)
    return chain_mod.chain_fk(model, q)[-1]


def soft_limits(model, padding: float):
    return model.soft_limits(padding)


# -- gripper conventions ----------------------------------------------------

def finger_link_mask(model) -> np.ndarray:
    """[L] host float mask: 1 for finger links (Panda: the last two)."""
    m = np.zeros(num_links(model), np.float32)
    if isinstance(model, PandaModel):
        m[-2:] = 1.0
    return m


def arm_dof_mask(model) -> np.ndarray:
    """[D] host float mask: 1 for non-gripper dofs."""
    m = np.ones(dof(model), np.float32)
    if isinstance(model, PandaModel):
        m[-2:] = 0.0
    return m


def gripper_clamp(model, xi: torch.Tensor) -> torch.Tensor:
    """Clamp the Panda fingers to [0, 0.04] (``omg/core.py:43-51``); the
    identity for a gripperless chain."""
    if isinstance(model, PandaModel):
        return torch.cat([xi[..., :-2], torch.clamp(xi[..., -2:], 0.0, 0.04)],
                         dim=-1)
    return xi
