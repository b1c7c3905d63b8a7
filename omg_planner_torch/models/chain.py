"""General serial-chain kinematics from URDF (counterpart of
``omg_planner_tpu/models/chain.py``).

A :class:`ChainModel` holds per-joint fixed origin transforms, axes, types
and limits parsed from a URDF with the standard library's ``xml.etree``,
plus per-link collision points, as tensors on one device.  FK composes
the joint transforms link by link, batched over configurations; the
planner reaches it through ``models/api.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device

REVOLUTE = 0
PRISMATIC = 1
FIXED = 2


@dataclasses.dataclass(frozen=True)
class ChainModel:
    """A fixed-base serial chain.

    ``origin[j]`` is the constant transform from link j-1's frame to the
    joint-j frame; joint motion applies about/along ``axis[j]`` in that
    frame.  ``jtype`` is a Python tuple (REVOLUTE/PRISMATIC/FIXED per
    joint): the structure is host metadata, the tables are tensors."""

    origin: torch.Tensor            # [J, 4, 4]
    axis: torch.Tensor              # [J, 3]
    lower: torch.Tensor             # [J] (0 for fixed joints)
    upper: torch.Tensor             # [J]
    collision_points: torch.Tensor  # [J, P, 3] body points per link
    jtype: tuple                    # [J] ints

    def _replace(self, **kw) -> "ChainModel":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.origin.device

    @property
    def num_joints(self) -> int:
        return self.origin.shape[0]

    @property
    def num_dof(self) -> int:
        return sum(t != FIXED for t in self.jtype)

    @property
    def num_collision_points(self) -> int:
        return self.collision_points.shape[1]

    def soft_limits(self, padding: float):
        """Limits of the moving joints, each padded by ``padding`` (a plain
        chain has no gripper convention)."""
        moving = [j for j, t in enumerate(self.jtype) if t != FIXED]
        return self.lower[moving] + padding, self.upper[moving] - padding


def _chain_fk_batch(model: ChainModel, q: torch.Tensor):
    """FK for configurations ``q [n, dof]``: link poses [n, J, 4, 4] and
    the world origin and axis of every joint [n, J, 3]."""
    n = q.shape[0]
    dt, dev = q.dtype, q.device
    eye = torch.eye(4, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    bottom = eye[3:].expand(n, 1, 4)

    def homogeneous(rot, trans):      # [n, 3, 3], [n, 3] -> [n, 4, 4]
        return torch.cat([torch.cat([rot, trans[:, :, None]], -1), bottom],
                         1)

    cur = eye.expand(n, 4, 4)
    poses, origins, axes = [], [], []
    qi = 0
    for j, jt in enumerate(model.jtype):
        pre = cur @ model.origin[j]
        origins.append(pre[:, :3, 3])
        axes.append(pre[:, :3, :3] @ model.axis[j])
        if jt == REVOLUTE:
            x, y, z = model.axis[j]
            k = torch.stack([torch.stack([zero, -z, y]),
                             torch.stack([z, zero, -x]),
                             torch.stack([-y, x, zero])])
            c = torch.cos(q[:, qi])[:, None, None]
            s = torch.sin(q[:, qi])[:, None, None]
            rot = eye[:3, :3] + s * k + (1 - c) * (k @ k)      # Rodrigues
            cur = pre @ homogeneous(rot, zero.expand(n, 3))
            qi += 1
        elif jt == PRISMATIC:
            cur = pre @ homogeneous(eye[:3, :3].expand(n, 3, 3),
                                    model.axis[j] * q[:, qi, None])
            qi += 1
        else:
            cur = pre
        poses.append(cur)
    return (torch.stack(poses, 1), torch.stack(origins, 1),
            torch.stack(axes, 1))


def chain_fk(model: ChainModel, q: torch.Tensor,
             return_joint_info: bool = False):
    """FK for one configuration ``q [num_dof]`` -> link poses [J, 4, 4]
    (plus joint origins and axes [J, 3] with ``return_joint_info``).
    Fixed joints consume no entry of ``q``."""
    poses, origins, axes = _chain_fk_batch(model, q[None])
    if return_joint_info:
        return poses[0], origins[0], axes[0]
    return poses[0]


def chain_fk_batch(model: ChainModel, q: torch.Tensor) -> torch.Tensor:
    """q [n, dof] -> link poses [n, J, 4, 4]."""
    return _chain_fk_batch(model, q)[0]


def chain_fk_with_joint_info_batch(model: ChainModel, q: torch.Tensor):
    """q [n, dof] -> ([n, J, 4, 4], [n, J, 3], [n, J, 3])."""
    return _chain_fk_batch(model, q)


def chain_point_jacobians(model: ChainModel, q: torch.Tensor):
    """Linear Jacobians of every collision point at ``q [dof]``:
    ([J, P, dof, 3], point positions [J, P, 3])."""
    poses, origins, axes = chain_fk(model, q, return_joint_info=True)
    x = (torch.einsum("jab,jpb->jpa", poses[:, :3, :3],
                      model.collision_points) + poses[:, None, :3, 3])
    links = torch.arange(model.num_joints, device=q.device)
    jac = []
    for j, jt in enumerate(model.jtype):
        if jt == FIXED:
            continue
        rel = x - origins[j]
        ax = axes[j].expand(rel.shape)
        col = torch.linalg.cross(ax, rel, dim=-1) if jt == REVOLUTE else ax
        # joint j moves its child link and everything after it
        jac.append(col * (links >= j).to(col.dtype)[:, None, None])
    return torch.stack(jac, dim=2), x


def _rpy_mat(r, p, y):
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    return np.array([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr]])


def load_urdf_chain(path_or_xml: str, base_link: str, tip_link: str,
                    collision_points_per_link: int = 15,
                    point_extent: float = 0.05, device=None) -> ChainModel:
    """Parse a URDF (a path or the XML itself) and extract the base->tip
    chain on ``device`` (``cuda`` unless the caller names another; raises
    without a GPU).  Collision points default to a small synthetic cloud
    per link (seeded as in the JAX package); pass real per-link clouds via
    :func:`with_collision_points`."""
    import xml.etree.ElementTree as ET

    device = resolve_device(device)
    root = (ET.fromstring(path_or_xml) if path_or_xml.lstrip().startswith("<")
            else ET.parse(path_or_xml).getroot())

    def floats(el, attr, default):
        return [float(v) for v in (el.get(attr, default) if el is not None
                                   else default).split()]

    joints = {}
    for j in root.findall("joint"):
        origin_el = j.find("origin")
        limit_el = j.find("limit")
        joints[j.find("child").get("link")] = dict(
            parent=j.find("parent").get("link"),
            xyz=floats(origin_el, "xyz", "0 0 0"),
            rpy=floats(origin_el, "rpy", "0 0 0"),
            axis=floats(j.find("axis"), "xyz", "1 0 0"),
            type=j.get("type", "fixed"),
            lower=float(limit_el.get("lower", 0.0))
            if limit_el is not None else 0.0,
            upper=float(limit_el.get("upper", 0.0))
            if limit_el is not None else 0.0)

    # walk tip -> base
    chain = []
    link = tip_link
    while link != base_link:
        if link not in joints:
            raise ValueError(f"no joint chain from {base_link} to {tip_link}")
        chain.append(joints[link])
        link = joints[link]["parent"]
    chain.reverse()

    n = len(chain)
    origin = np.tile(np.eye(4), (n, 1, 1))
    axis = np.zeros((n, 3))
    jtype = np.full(n, FIXED)
    lower = np.zeros(n)
    upper = np.zeros(n)
    for i, j in enumerate(chain):
        origin[i, :3, :3] = _rpy_mat(*j["rpy"])
        origin[i, :3, 3] = j["xyz"]
        a = np.asarray(j["axis"], float)
        axis[i] = a / (np.linalg.norm(a) + 1e-12)
        if j["type"] in ("revolute", "continuous"):
            jtype[i] = REVOLUTE
        elif j["type"] == "prismatic":
            jtype[i] = PRISMATIC
        lower[i], upper[i] = j["lower"], j["upper"]

    rng = np.random.default_rng(0)
    pts = rng.normal(scale=point_extent / 2,
                     size=(n, collision_points_per_link, 3))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return ChainModel(origin=f32(origin), axis=f32(axis), lower=f32(lower),
                      upper=f32(upper), collision_points=f32(pts),
                      jtype=tuple(int(t) for t in jtype))


def with_collision_points(model: ChainModel, points) -> ChainModel:
    return model._replace(collision_points=torch.as_tensor(
        np.asarray(points, np.float32), device=model.device))
