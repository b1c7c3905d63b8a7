"""Franka Panda kinematics on tensors (counterpart of
``omg_planner_tpu/models/panda.py``).

The chain, per arm joint i = 0..6::

    b_i = pose_0[i] @ Rz(q_i) @ Rx(offset_i)     (column flip for i > 0)
    link_i = link_{i-1} @ b_i

then the fixed hand and the two prismatic fingers.  Configurations are
radians ``[q1..q7, f_left, f_right]``.  The batched form keeps the JAX
package's lane-last layout and left-associated 4x4 products, so both
packages round the same way.  The tables are read from the JAX package's
``assets/*.npz`` data files with numpy.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device

_ASSET_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                          "..", "omg_planner_tpu", "assets")
_ASSET = os.path.join(_ASSET_DIR, "panda_kinematics.npz")
_COLLISION_ASSET = os.path.join(_ASSET_DIR, "panda_collision_points.npz")

NUM_LINKS = 10  # link1..link7, hand, leftfinger, rightfinger
DOF = 9

# dof -> joint-axis-table index (index 7 of the table is the fixed hand)
_DOF_TO_AXIS = np.array([0, 1, 2, 3, 4, 5, 6, 8, 9])

# affect[j, d]: does dof d move link j?  (reference wrap_index/wrap_joint,
# omg/util.py:205-220)
_AFFECT = np.zeros((NUM_LINKS, DOF), dtype=np.float32)
for _j in range(NUM_LINKS):
    for _d in range(7):
        _AFFECT[_j, _d] = 1.0 if (_j >= 7 or _d <= _j) else 0.0
_AFFECT[8, 7] = 1.0  # left finger prismatic
_AFFECT[9, 8] = 1.0  # right finger prismatic
_PRISMATIC = np.zeros(DOF, dtype=np.float32)
_PRISMATIC[7:] = 1.0

_E1 = np.diag([1.0, 1.0, 0.0, 0.0])
_E2 = np.zeros((4, 4))
_E2[1, 0] = 1.0
_E2[0, 1] = -1.0
_E3 = np.diag([0.0, 0.0, 1.0, 1.0])


class PandaModel(NamedTuple):
    """Constant kinematic tables (float32 tensors on one device)."""

    pose_0: torch.Tensor        # [10, 4, 4] rest poses
    chain_post: torch.Tensor    # [7, 4, 4]  Rx(offset_i) (+ column flip)
    tip2joint: torch.Tensor     # [10, 4, 4]
    center_offset: torch.Tensor  # [10, 4, 4] link frame -> mesh center
    joint_axis: torch.Tensor    # [10, 3] local joint axes
    joint_lower: torch.Tensor   # [9] hard limits
    joint_upper: torch.Tensor   # [9]
    collision_points: torch.Tensor  # [10, P, 3] body points

    @property
    def num_collision_points(self) -> int:
        return self.collision_points.shape[1]

    @property
    def device(self) -> torch.device:
        return self.pose_0.device

    def soft_limits(self, padding: float):
        """Joint limits shrunk by ``padding`` on the 7 arm joints."""
        pad = torch.zeros_like(self.joint_lower)
        pad[:7] = padding
        return self.joint_lower + pad, self.joint_upper - pad


def _rot_x_mat(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]])


def load_panda(collision_point_num: int = 15, device=None,
               asset_path: str = _ASSET,
               collision_asset_path: str = _COLLISION_ASSET) -> PandaModel:
    """Build the model from the npz assets on ``device`` (``cuda`` unless
    the caller names another; raises without a GPU, as every entry point
    does).

    ``collision_point_num`` points per link are taken evenly strided from
    the stored per-link point sets, as the JAX package does."""
    return _load_panda(collision_point_num, resolve_device(device),
                       asset_path, collision_asset_path)


@functools.lru_cache(maxsize=8)
def _load_panda(collision_point_num: int, device: torch.device,
                asset_path: str, collision_asset_path: str) -> PandaModel:
    t = dict(np.load(asset_path, allow_pickle=True))
    offsets = t["dh_offsets"]
    post = []
    flip = np.diag([1.0, -1.0, -1.0, 1.0])
    for i in range(7):
        m = _rot_x_mat(float(offsets[i]))
        if i > 0:
            m = m @ flip
        post.append(m)
    pts = np.load(collision_asset_path)["points"]  # [10, P, 3]
    stride = max(pts.shape[1] // collision_point_num, 1)
    pts = pts[:, ::stride, :][:, :collision_point_num, :]

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return PandaModel(
        pose_0=f32(t["pose_0"]), chain_post=f32(np.stack(post)),
        tip2joint=f32(t["tip2joint"]), center_offset=f32(t["center_offset"]),
        joint_axis=f32(t["joint_axis"]), joint_lower=f32(t["joint_lower"]),
        joint_upper=f32(t["joint_upper"]), collision_points=f32(pts))


def _rotz_mat(q: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(q), torch.sin(q)
    z, o = torch.zeros_like(q), torch.ones_like(q)
    return torch.stack([
        torch.stack([c, -s, z, z], -1),
        torch.stack([s, c, z, z], -1),
        torch.stack([z, z, o, z], -1),
        torch.stack([z, z, z, o], -1),
    ], -2)


def forward_kinematics(model: PandaModel, q: torch.Tensor,
                       apply_offset: bool = True,
                       return_joint_info: bool = False):
    """FK for one configuration ``q [9]``: link poses ``[10, 4, 4]`` (mesh
    center frame when ``apply_offset``), plus world joint origins/axes
    ``[10, 3]`` when ``return_joint_info``."""
    cur = torch.eye(4, dtype=q.dtype, device=q.device)
    links, origins, axes = [], [], []
    for i in range(7):
        pre = cur @ model.pose_0[i]
        origins.append(pre[:3, 3])
        axes.append(pre[:3, 2])
        cur = pre @ _rotz_mat(q[i]) @ model.chain_post[i]
        links.append(cur)
    hand = links[6] @ model.pose_0[7]
    # the finger offsets as out-of-place sums, so torch.func transforms
    # (physics/dynamics.py) can differentiate through them
    e13 = torch.zeros(4, 4, dtype=q.dtype, device=q.device)
    e13[1, 3] = 1.0
    lf = model.pose_0[8] + q[7] * e13
    rf = model.pose_0[9] - q[8] * e13
    links += [hand, hand @ lf, hand @ rf]
    out = torch.stack(links)
    if return_joint_info:
        hand_rot = hand[:3, :3]
        origins += [hand[:3, 3], links[8][:3, 3], links[9][:3, 3]]
        axes += [torch.zeros(3, dtype=q.dtype, device=q.device),
                 hand_rot[:, 1], -hand_rot[:, 1]]
    if apply_offset:
        out = out @ model.center_offset
    if return_joint_info:
        return out, torch.stack(origins), torch.stack(axes)
    return out


def _mm4_lanes(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """4x4 product in lane-last layout: a, b [4, 4, N] -> [4, 4, N], with
    the JAX package's left-associated sum ((a0b0 + a1b1) + a2b2) + a3b3."""
    p = a[:, :, None, :] * b[None, :, :, :]
    return ((p[:, 0] + p[:, 1]) + p[:, 2]) + p[:, 3]


def _mm4_const_lanes(a: torch.Tensor, b_const: torch.Tensor) -> torch.Tensor:
    """[4, 4, N] @ constant [4, 4] -> [4, 4, N]."""
    p = a[:, :, None, :] * b_const[None, :, :, None]
    return ((p[:, 0] + p[:, 1]) + p[:, 2]) + p[:, 3]


@functools.lru_cache(maxsize=16)
def pqr_table(pose_0, chain_post) -> torch.Tensor:
    """Per-joint constants ``[7, 3, 4, 4]``: ``(P_i, Q_i, R_i)`` with
    ``A Rz(q) C = cos(q) P + sin(q) Q + R`` (cached per model; the table
    the ``panda_fk`` kernel reads)."""
    dt, dev = pose_0.dtype, pose_0.device
    e1, e2, e3 = (torch.as_tensor(e, dtype=dt, device=dev)
                  for e in (_E1, _E2, _E3))
    return torch.stack([
        torch.stack([a @ e1 @ c, a @ e2 @ c, a @ e3 @ c])
        for a, c in zip(pose_0[:7], chain_post)])


def forward_kinematics_batch(model: PandaModel, q: torch.Tensor,
                             return_joint_info: bool = False,
                             apply_offset: bool = True):
    """Batched FK: q [N, 9] -> poses [N, 10, 4, 4] (+ origins/axes
    [N, 10, 3] with ``return_joint_info``)."""
    return fk_batch_tables(pqr_table(model.pose_0, model.chain_post),
                           model.pose_0, model.center_offset, q,
                           return_joint_info, apply_offset)


def fk_batch_tables(pqr: torch.Tensor, pose_0: torch.Tensor,
                    center_offset: torch.Tensor, q: torch.Tensor,
                    return_joint_info: bool = False,
                    apply_offset: bool = True):
    """:func:`forward_kinematics_batch` on the model's tables (``pqr``
    from :func:`pqr_table`): the plain version of the ``panda_fk``
    kernel."""
    n = q.shape[0]
    cos_q = torch.cos(q[:, :7])
    sin_q = torch.sin(q[:, :7])
    cur = None  # [4, 4, N]
    links, origins, axes = [], [], []
    for i in range(7):
        a = pose_0[i]
        p_i, q_i, r_i = pqr[i]
        b = (p_i[:, :, None] * cos_q[None, None, :, i]
             + q_i[:, :, None] * sin_q[None, None, :, i]
             + r_i[:, :, None])
        if cur is None:
            if return_joint_info:
                pre = a[:, :, None].expand(4, 4, n)
                origins.append(pre[:3, 3])
                axes.append(pre[:3, 2])
            cur = b
        else:
            if return_joint_info:
                pre = _mm4_const_lanes(cur, a)
                origins.append(pre[:3, 3])
                axes.append(pre[:3, 2])
            cur = _mm4_lanes(cur, b)
        links.append(cur)

    hand = _mm4_const_lanes(links[6], pose_0[7])
    # the finger offsets out of place (exact: the other entries add 0), so
    # torch.func.vmap can batch the FK over scenes
    e13 = torch.zeros(4, 4, 1, dtype=q.dtype, device=q.device)
    e13[1, 3] = 1.0
    lf = pose_0[8][:, :, None] + e13 * q[None, None, :, 7]
    rf = pose_0[9][:, :, None] + e13 * -q[None, None, :, 8]
    links += [hand, _mm4_lanes(hand, lf), _mm4_lanes(hand, rf)]

    if return_joint_info:
        hand_rot_y = torch.stack([hand[0, 1], hand[1, 1], hand[2, 1]])
        origins += [hand[:3, 3], links[8][:3, 3], links[9][:3, 3]]
        axes += [torch.zeros_like(hand_rot_y), hand_rot_y, -hand_rot_y]

    if apply_offset:
        links = [_mm4_const_lanes(links[j], center_offset[j])
                 for j in range(NUM_LINKS)]
    out = torch.stack(links).permute(3, 0, 1, 2)     # [N, 10, 4, 4]
    if return_joint_info:
        og = torch.stack(origins).permute(2, 0, 1)    # [N, 10, 3]
        ax = torch.stack(axes).permute(2, 0, 1)
        return out, og, ax
    return out


def fk_with_joint_info_batch(model: PandaModel, q: torch.Tensor):
    """q [n, 9] -> ([n,10,4,4], [n,10,3], [n,10,3])."""
    return forward_kinematics_batch(model, q, return_joint_info=True)


def hand_pose(model: PandaModel, q: torch.Tensor) -> torch.Tensor:
    """World pose of panda_hand (link 7) without mesh offset — the IK tip."""
    return forward_kinematics(model, q, apply_offset=False)[7]


def hand_pose_batch(model: PandaModel, q: torch.Tensor) -> torch.Tensor:
    """panda_hand poses for a batch ``[N, 9] -> [N, 4, 4]``."""
    return forward_kinematics_batch(model, q, apply_offset=False)[:, 7]


def collision_point_positions(model: PandaModel,
                              poses: torch.Tensor) -> torch.Tensor:
    """Transform body points by link poses: [.., 10, 4, 4] -> [.., 10, P, 3]
    (three broadcast multiply-adds, summed in the JAX package's order)."""
    return points_at(model.collision_points, poses)


def points_at(pts: torch.Tensor, poses: torch.Tensor) -> torch.Tensor:
    """Body points ``pts [10, P, 3]`` moved by link poses ``[.., 10, 4,
    4]``: the body-point half of the ``panda_fk`` kernel's plain
    version."""
    r = poses[..., :3, :3]
    t = poses[..., None, :3, 3]
    x = 0
    for c in range(3):
        x = x + r[..., c][..., :, None, :] * pts[..., c][:, :, None]
    return x + t


def point_jacobians(model: PandaModel, origins_w: torch.Tensor,
                    axes_w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Linear-velocity Jacobians of every body point: [n, 10, P, 9, 3].

    Revolute columns are ``axis x (x - origin)``; the two prismatic finger
    columns are the axis itself; link/dof gating as ``_AFFECT``."""
    dev, dt = x.device, x.dtype
    d2a = torch.as_tensor(_DOF_TO_AXIS, device=dev)
    ax = axes_w[:, d2a, :]                                 # [n, 9, 3]
    og = origins_w[:, d2a, :]
    rel = x[:, :, :, None, :] - og[:, None, None, :, :]    # [n,10,P,9,3]
    axb = ax[:, None, None].expand(rel.shape)
    rev = torch.linalg.cross(axb, rel, dim=-1)
    p_mask = torch.as_tensor(_PRISMATIC, dtype=dt,
                             device=dev)[None, None, None, :, None]
    jac = rev * (1.0 - p_mask) + axb * p_mask
    return jac * torch.as_tensor(_AFFECT, dtype=dt,
                                 device=dev)[None, :, None, :, None]
