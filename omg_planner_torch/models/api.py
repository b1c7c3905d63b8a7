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
version (``panda.fk_batch_tables``).  What the kernels read of a model
(:func:`kernel_tables`) is made once for the model object and held by it,
so it lives exactly as long as the model: a model made by ``_replace``
gets tables of its own fields.  :func:`fk_points` and
:func:`end_points` are the fused forms that also return the body points.
``fk_one`` and ``end_points`` keep the single-configuration FK
(``panda.forward_kinematics``) on the CPU, as the JAX package computes
it.  Nothing differentiates through these functions (the kernel has no
gradient); ``physics/dynamics.py`` and the IK call ``panda`` directly.
"""

from __future__ import annotations

from typing import NamedTuple

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


class KernelTables(NamedTuple):
    """What the kernels read of one model, laid out once for it."""

    fk: torch.Tensor | None   # ``kernels.fk_tables``' buffer (Panda)
    pqr: torch.Tensor | None  # its head, [7, 3, 4, 4] (Panda)
    jacobian: torch.Tensor    # ``chomp_obstacle``'s (:func:`jacobian_tables`)
    dofs: torch.Tensor        # ``chomp_step``'s (:func:`dof_tables`)


def _held(model, key, make):
    """``make()``, made on the first call for ``model`` and kept in the
    model's ``__dict__``: it lives exactly as long as the model object (a
    copy by ``_replace`` starts with none)."""
    held = vars(model)
    got = held.get(key)
    if got is None:
        got = held[key] = make()
    return got


def kernel_tables(model) -> KernelTables:
    """The model's :class:`KernelTables`, all made on its first call (outside
    any CUDA-graph capture: a plan's first steps run eagerly), then held by
    the model.  A captured graph that reads them is kept with the model
    (``planner/plan.py::_Kept``), and so with them."""
    return _held(model, "_kernel_tables", lambda: _tables_of(model))


def _tables_of(model) -> KernelTables:
    dev = model.device
    if isinstance(model, PandaModel):
        d2j, affect, prismatic = (panda_mod._DOF_TO_AXIS, panda_mod._AFFECT,
                                  panda_mod._PRISMATIC)
        fk = kernels.fk_tables(
            panda_mod.pqr_table(model.pose_0, model.chain_post),
            model.pose_0, model.center_offset, model.collision_points)
        pqr = kernels.fk_table_parts(fk)[0]
    else:
        d2j, affect, prismatic = _chain_tables(model)
        fk = pqr = None
    jac = np.concatenate([np.asarray(d2j, np.float32), prismatic,
                          affect.reshape(-1), finger_link_mask(model)])
    arm = arm_dof_mask(model)
    return KernelTables(
        fk=fk, pqr=pqr,
        jacobian=torch.as_tensor(jac.astype(np.float32), device=dev),
        dofs=torch.as_tensor(np.stack([arm, 1.0 - arm]), device=dev))


def thinned(model, n: int):
    """``model`` on ``n`` of its body points a link, every
    ``P // n``-th (the learner's ``learner_collision_points``; ``model``
    itself where ``n`` is 0 or not below P).  Made once per model and
    ``n`` and held by the model, so its tables are made once too."""
    p = model.num_collision_points
    if not n or n >= p:
        return model
    return _held(model, ("thinned", n), lambda: model._replace(
        collision_points=model.collision_points[:, ::max(p // n, 1), :]
        [:, :n, :]))


def _panda_fk(model: PandaModel, q: torch.Tensor, with_points: bool):
    return kernels.panda_fk(q, kernel_tables(model).fk, True, with_points)


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
    device (held by the model, :func:`kernel_tables`): the joint row of
    each dof [D], prismatic [D], affect [L, D], the finger links [L]
    (:func:`finger_link_mask`)."""
    return kernel_tables(model).jacobian


def dof_tables(model) -> torch.Tensor:
    """[2, D] float32 on the model's device (held by the model,
    :func:`kernel_tables`), as the ``chomp_step`` kernel reads them: the
    arm dofs (:func:`arm_dof_mask`) and the others, the gripper dofs that
    :func:`gripper_clamp` clamps to [0, 0.04]."""
    return kernel_tables(model).dofs


def hand_poses(model: PandaModel, q: torch.Tensor) -> torch.Tensor:
    """``panda_hand`` poses ``[N, 4, 4]`` of configurations ``q [N, 9]``:
    ``panda.hand_pose_batch`` on the model's own ``pqr`` table."""
    return panda_mod.fk_batch_tables(kernel_tables(model).pqr, model.pose_0,
                                     model.center_offset, q,
                                     apply_offset=False)[:, 7]


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
