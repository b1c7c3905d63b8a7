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

import functools

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
    return _chain_tables_of(model.jtype)


def _chain_tables_of(jtype: tuple):
    jt = np.asarray(jtype)
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
    return panda_mod.point_jacobians_tables(
        origins_w, axes_w, x, torch.as_tensor(d2j, device=dev),
        torch.as_tensor(prismatic, dtype=dt, device=dev),
        torch.as_tensor(affect, dtype=dt, device=dev))


def jacobian_tables(model) -> torch.Tensor:
    """The model's point-Jacobian and finger tables as the
    ``chomp_obstacle`` kernel reads them, one float32 buffer on the model's
    device (cached per model kind, as ``kernels._fk_tables`` caches the
    FK's): the joint row of each dof [D], prismatic [D], affect [L, D],
    the finger links [L] (:func:`finger_link_mask`)."""
    jtype = None if isinstance(model, PandaModel) else model.jtype
    return _jacobian_tables(jtype, tuple(finger_link_mask(model)),
                            str(model.device))


@functools.lru_cache(maxsize=32)
def _jacobian_tables(jtype, finger: tuple, device: str) -> torch.Tensor:
    if jtype is None:
        d2j, affect, prismatic = (panda_mod._DOF_TO_AXIS, panda_mod._AFFECT,
                                  panda_mod._PRISMATIC)
    else:
        d2j, affect, prismatic = _chain_tables_of(jtype)
    flat = np.concatenate([np.asarray(d2j, np.float32), prismatic,
                           affect.reshape(-1), finger]).astype(np.float32)
    return torch.as_tensor(flat, device=device)


def dof_tables(model) -> torch.Tensor:
    """[2, D] float32 on the model's device (cached per model kind), as the
    ``chomp_step`` kernel reads them: the arm dofs (:func:`arm_dof_mask`)
    and the others, the gripper dofs that :func:`gripper_clamp` clamps to
    [0, 0.04]."""
    return _dof_tables(tuple(arm_dof_mask(model)), str(model.device))


@functools.lru_cache(maxsize=32)
def _dof_tables(arm: tuple, device: str) -> torch.Tensor:
    arm = np.asarray(arm, np.float32)
    return torch.as_tensor(np.stack([arm, 1.0 - arm]), device=device)


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
