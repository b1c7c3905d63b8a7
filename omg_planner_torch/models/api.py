"""The robot-model protocol the planner consumes (counterpart of
``omg_planner_tpu/models/api.py``).  The CHOMP/plan stack calls these
functions, never ``panda.*`` directly.  This slice of the port carries the
Panda branch only; the generic URDF chain (``models/chain.py``) is queued.
"""

from __future__ import annotations

import numpy as np
import torch

from . import panda as panda_mod
from .panda import PandaModel


def _check(model):
    if not isinstance(model, PandaModel):
        raise NotImplementedError(
            "omg_planner_torch models the Panda only; the generic chain "
            "model is not ported yet")


def num_links(model) -> int:
    return model.collision_points.shape[0]


def dof(model) -> int:
    _check(model)
    return panda_mod.DOF


def fk_with_joint_info_batch(model, q: torch.Tensor):
    _check(model)
    return panda_mod.fk_with_joint_info_batch(model, q)


def fk_one(model, q: torch.Tensor):
    _check(model)
    return panda_mod.forward_kinematics(model, q)


def fk_batch(model, q: torch.Tensor):
    _check(model)
    return panda_mod.forward_kinematics_batch(model, q)


def point_positions(model, poses: torch.Tensor):
    return panda_mod.collision_point_positions(model, poses)


def point_jacobians(model, origins_w, axes_w, x):
    _check(model)
    return panda_mod.point_jacobians(model, origins_w, axes_w, x)


def tip_pose(model, q: torch.Tensor):
    """The tool frame (Panda: ``panda_hand``) at configuration ``q``."""
    _check(model)
    return panda_mod.hand_pose(model, q)


def soft_limits(model, padding: float):
    return model.soft_limits(padding)


# -- gripper conventions ----------------------------------------------------

def finger_link_mask(model) -> np.ndarray:
    """[L] host float mask: 1 for finger links (Panda: the last two)."""
    _check(model)
    m = np.zeros(num_links(model), np.float32)
    m[-2:] = 1.0
    return m


def arm_dof_mask(model) -> np.ndarray:
    """[D] host float mask: 1 for non-gripper dofs."""
    m = np.ones(dof(model), np.float32)
    m[-2:] = 0.0
    return m


def gripper_clamp(model, xi: torch.Tensor) -> torch.Tensor:
    """Clamp the Panda fingers to [0, 0.04] (``omg/core.py:43-51``)."""
    _check(model)
    return torch.cat([xi[..., :-2], torch.clamp(xi[..., -2:], 0.0, 0.04)],
                     dim=-1)
