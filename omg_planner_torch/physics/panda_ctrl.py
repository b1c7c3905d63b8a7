"""The reference's Bullet ``Panda`` robot surface
(``bullet/panda_gripper.py``) over the package's own dynamics
(counterpart of ``omg_planner_tpu/physics/panda_ctrl.py``).

Same observable API: ``reset`` / ``step`` / ``setControlMode`` /
``setTargetPositions`` / ``setTargetTorques`` / ``resetController`` /
``getJointStates`` / ``solveInverseDynamics`` / ``solveInverseKinematics``,
with the reference's conventions: torque is the primary mode, the last
``setTarget*`` call picks the motor, ``resetController`` frees the joints,
joint vectors take the 9-DOF layout or the reference's 10-slot Bullet
layout (a zero at index 7 for the fixed ``panda_joint8``), the two fingers
stay mirrored, joint damping is zero, and limits clamp with a velocity
kill.  The position motor is a critically damped computed-torque servo
``tau = M(q)(kp e - kd qd) + c + g`` clamped at ``max_torque``; the stepper
integrates semi-implicit Euler at ``stepsize``.

It runs on ``device`` (``cuda`` unless named; raises without a GPU).  The
substep loop is eager PyTorch: the motor mode is known on the host, so the
JAX package's ``lax.switch`` is a Python branch and its ``fori_loop`` a
Python loop of substeps.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import resolve_device
from ..models import panda
from ..ops import ik as ik_ops
from ..utils.pose import quat_to_mat
from . import dynamics

# reference class constants (panda_gripper.py:43-55, 116)
MAX_TORQUE = 250.0
HOME_POSE = np.asarray(
    [0.0, -1.285, 0.0, -2.356, 0.0, 1.571, 0.785, 0.04, 0.04])
# position-servo gains (see the module docstring): ~0.2 s settle
_KP = 400.0
_KD = 2.0 * np.sqrt(_KP)

_FREE, _POSITION, _TORQUE = 0, 1, 2


def _as9(joints: Sequence[float] | np.ndarray) -> np.ndarray:
    """Accept 9-DOF or the reference's 10-slot layout (zero at index 7 for
    the fixed panda_joint8, ``panda_gripper.py:154-162``)."""
    j = np.asarray(joints, np.float32).reshape(-1)
    if j.shape[0] == 10:
        j = np.delete(j, 7)
    if j.shape[0] != 9:
        raise ValueError(f"expected 9 or 10 joint values, got {j.shape[0]}")
    return j


def run_substeps(model, stepsize: float, q, qd, motor: int, target_pos,
                 target_tau, n: int):
    """``n`` semi-implicit Euler substeps of the arm under ``motor``."""
    lo, hi = model.joint_lower, model.joint_upper
    for _ in range(n):
        # M(q) and c + g once a substep: the position servo and the forward
        # dynamics share them (the JAX package evaluates each twice)
        m = dynamics.mass_matrix(model, q)
        bias = dynamics.bias_torque(model, q, qd)
        if motor == _FREE:
            tau = torch.zeros_like(q)
        elif motor == _POSITION:
            acc = _KP * (target_pos - q) - _KD * qd
            tau = torch.clamp(m @ acc + bias, -MAX_TORQUE, MAX_TORQUE)
        else:
            tau = torch.clamp(target_tau, -MAX_TORQUE, MAX_TORQUE)
        qdd = torch.cholesky_solve((tau - bias)[:, None],
                                   torch.linalg.cholesky(m))[:, 0]
        qd = qd + stepsize * qdd
        q = q + stepsize * qd
        # limits clamp with a velocity kill (Bullet enforces them as
        # unilateral constraints)
        q_cl = torch.minimum(torch.maximum(q, lo), hi)
        qd = torch.where(q == q_cl, qd, torch.zeros_like(qd))
        q = q_cl
        # finger gear constraint: mirror the prismatic pair
        fm = 0.5 * (q[7] + q[8])
        fv = 0.5 * (qd[7] + qd[8])
        q = torch.cat([q[:7], fm.expand(2)])
        qd = torch.cat([qd[:7], fv.expand(2)])
    return q, qd


class NativePanda:
    """The port's analogue of the reference's ``Panda`` class."""

    def __init__(self, stepsize: float = 1e-3, realtime: int = 0,
                 init_joints=None, base_shift=(0.0, 0.0, 0.0), device=None):
        del realtime  # the reference hands it to Bullet's real-time clock
        self.device = resolve_device(device)
        self.stepsize = float(stepsize)
        self.t = 0.0
        self.base_position = (-0.05 - base_shift[0], -base_shift[1],
                              -0.65 - base_shift[2])
        self.max_torque = [MAX_TORQUE] * 9
        self.model = panda.load_panda(device=self.device)
        self.reset(init_joints)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    # -- reference surface ------------------------------------------------

    def reset(self, joints=None):
        self.t = 0.0
        self.control_mode = "torque"
        self.q = _as9(HOME_POSE if joints is None else joints)
        self.qd = np.zeros(9, np.float32)
        self.target_torque = np.zeros(9, np.float32)
        self.resetController()
        # the reference's reset arms the position motors at the reset pose
        # (panda_gripper.py:130): the robot holds until setTargetTorques
        self.setTargetPositions(self.q)

    def resetController(self):
        """Free the joints (VELOCITY_CONTROL, zero force, ``:136-142``)."""
        self._motor = _FREE

    def setControlMode(self, mode: str):
        if mode == "position":
            self.control_mode = "position"
        elif mode == "torque":
            if self.control_mode != "torque":
                self.resetController()
            self.control_mode = "torque"
        else:
            raise Exception("wrong control mode")

    def setTargetPositions(self, target_pos):
        self.target_pos = _as9(target_pos)
        self._motor = _POSITION

    def setTargetTorques(self, target_torque):
        self.target_torque = _as9(target_torque)
        self._motor = _TORQUE

    def step(self, n: int = 1):
        q, qd = run_substeps(
            self.model, self.stepsize, self._t(self.q), self._t(self.qd),
            self._motor, self._t(getattr(self, "target_pos", self.q)),
            self._t(self.target_torque), int(n))
        self.q = q.cpu().numpy()
        self.qd = qd.cpu().numpy()
        self.t += n * self.stepsize

    def getJointStates(self):
        return list(self.q.astype(float)), list(self.qd.astype(float))

    def solveInverseDynamics(self, pos, vel, acc):
        tau = dynamics.inverse_dynamics(
            self.model, self._t(_as9(pos)), self._t(_as9(vel)),
            self._t(_as9(acc)))
        return list(tau.cpu().numpy().astype(float))

    def solveInverseKinematics(self, pos, orn):
        """Hand-frame IK (reference ``:194-195``; Bullet quaternion order
        x, y, z, w).  ``pos`` is in the robot-base frame.  Returns the 9-DOF
        configuration with the current finger opening."""
        from ..config import OMGConfig

        target = torch.eye(4, device=self.device)
        target[:3, :3] = quat_to_mat(self._t([orn[3], orn[0], orn[1],
                                              orn[2]]))
        target[:3, 3] = self._t(pos)
        lo, hi = self.model.soft_limits(0.0)
        res = ik_ops.ik_single(self.model, target, self._t(self.q[:7]),
                               OMGConfig(), lo[:7], hi[:7])
        return list(res.q.cpu().numpy().astype(float)) + list(
            self.q[7:].astype(float))

    # -- convenience ------------------------------------------------------

    def gravityTorques(self, pos=None):
        """Static-hold torques ``g(q)`` (beyond the reference)."""
        q = self.q if pos is None else _as9(pos)
        g = dynamics.gravity_torque(self.model, self._t(q))
        return list(g.cpu().numpy().astype(float))
