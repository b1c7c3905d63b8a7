"""SE(3)/SO(3) pose utilities on tensors (counterpart of
``omg_planner_tpu/utils/pose.py``).  Quaternions are wxyz; every function
works on trailing dimensions with any leading batch shape."""

from __future__ import annotations

import torch


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """wxyz quaternion -> 3x3 rotation. Supports leading batch dims."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation -> wxyz quaternion (Shepperd's method, branch-free)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def ss(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    a0, a1 = ss(1 + tr), ss(1 + m00 - m11 - m22)
    a2, a3 = ss(1 - m00 + m11 - m22), ss(1 - m00 - m11 + m22)
    q0 = torch.stack([a0 / 2, (m21 - m12) / (2 * a0),
                      (m02 - m20) / (2 * a0), (m10 - m01) / (2 * a0)], -1)
    q1 = torch.stack([(m21 - m12) / (2 * a1), a1 / 2,
                      (m01 + m10) / (2 * a1), (m02 + m20) / (2 * a1)], -1)
    q2 = torch.stack([(m02 - m20) / (2 * a2), (m01 + m10) / (2 * a2),
                      a2 / 2, (m12 + m21) / (2 * a2)], -1)
    q3 = torch.stack([(m10 - m01) / (2 * a3), (m02 + m20) / (2 * a3),
                      (m12 + m21) / (2 * a3), a3 / 2], -1)
    cand = torch.stack([q0, q1, q2, q3], dim=-2)  # [..., 4, 4]
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                          m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    q = torch.take_along_dim(
        cand, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)
    q = q[..., 0, :]
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + 1e-12)
    # canonical sign: w >= 0
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def unpack_pose(pose7: torch.Tensor) -> torch.Tensor:
    """[x,y,z,qw,qx,qy,qz] -> 4x4 (reference ``omg/util.py:115-119``)."""
    mat = torch.zeros(pose7.shape[:-1] + (4, 4), dtype=pose7.dtype,
                      device=pose7.device)
    mat[..., :3, :3] = quat_to_mat(pose7[..., 3:])
    mat[..., :3, 3] = pose7[..., :3]
    mat[..., 3, 3] = 1.0
    return mat


def pack_pose(mat: torch.Tensor) -> torch.Tensor:
    """4x4 -> [x,y,z,qw,qx,qy,qz] (reference ``omg/util.py:122-126``)."""
    return torch.cat([mat[..., :3, 3], mat_to_quat(mat[..., :3, :3])], -1)


def se3_inverse(mat: torch.Tensor) -> torch.Tensor:
    """Rigid-transform inverse (reference ``omg/util.py:129-135``)."""
    r = mat[..., :3, :3]
    t = mat[..., :3, 3:]
    rt = r.transpose(-1, -2)
    out = torch.zeros_like(mat)
    out[..., :3, :3] = rt
    out[..., :3, 3:] = -rt @ t
    out[..., 3, 3] = 1.0
    return out


def _rot4(angle, rows_fn) -> torch.Tensor:
    angle = torch.as_tensor(angle, dtype=torch.float32)
    c, s = torch.cos(angle), torch.sin(angle)
    one, zero = torch.ones_like(c), torch.zeros_like(c)
    return torch.stack(rows_fn(c, s, one, zero), -1).reshape(
        angle.shape + (4, 4))


def rot_z(angle) -> torch.Tensor:
    """4x4 rotation about world z (reference ``omg/util.py:38-47``)."""
    return _rot4(angle, lambda c, s, one, zero: [
        c, -s, zero, zero, s, c, zero, zero,
        zero, zero, one, zero, zero, zero, zero, one])


def rot_y(angle) -> torch.Tensor:
    """4x4 rotation about world y (reference ``omg/util.py:50-59``)."""
    return _rot4(angle, lambda c, s, one, zero: [
        c, zero, s, zero, zero, one, zero, zero,
        -s, zero, c, zero, zero, zero, zero, one])


def rot_x(angle) -> torch.Tensor:
    return _rot4(angle, lambda c, s, one, zero: [
        one, zero, zero, zero, zero, c, -s, zero,
        zero, s, c, zero, zero, zero, zero, one])


def _trace(r: torch.Tensor) -> torch.Tensor:
    return r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> axis-angle vector (used by the damped-Newton IK).

    Degenerate at rotation angle exactly pi; see :func:`so3_angle`."""
    cos_theta = torch.clamp((_trace(r) - 1) / 2, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w = torch.stack(
        [r[..., 2, 1] - r[..., 1, 2],
         r[..., 0, 2] - r[..., 2, 0],
         r[..., 1, 0] - r[..., 0, 1]], dim=-1)
    # sin(theta) ~ theta near 0; scale = theta / (2 sin theta) -> 1/2
    scale = torch.where(theta < 1e-6, 0.5,
                        theta / (2.0 * torch.sin(theta) + 1e-12))
    return w * scale[..., None]


def so3_angle(r: torch.Tensor) -> torch.Tensor:
    """Rotation angle in [0, pi] from the trace (robust at pi)."""
    return torch.arccos(torch.clamp((_trace(r) - 1) / 2, -1.0, 1.0))


def transform_points(mat: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to [..., P, 3] -> [..., P, 3]."""
    return pts @ mat[..., :3, :3].transpose(-1, -2) + mat[..., None, :3, 3]
