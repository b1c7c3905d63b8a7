"""Synthetic scene assets: primitive objects, grasp databases, scenes.

Numpy copy of ``omg_planner_tpu/io/assets.py`` (the port imports nothing
of the JAX package, so it carries its own host-side assets).

The reference depends on a ~600 MB asset download (object meshes + SDF
volumes, simulated grasp databases, 100 scene ``.mat`` files;
``download_data.sh``, ``README.md:157-186``).  This module synthesizes
equivalent assets from primitives — analytic SDFs
(:meth:`SignedDensityField.from_analytic`) and procedurally generated
antipodal grasp sets — so the framework is testable and benchmarkable
self-contained.  Loaders for the reference's real data formats live in
``io/scene_io.py``.
"""

from __future__ import annotations

import numpy as np

from ..ops.sdf import SignedDensityField

# Distance from the panda_hand origin to the grasp center between the
# fingertips (hand depth 0.058 + finger reach ~ 0.045).
HAND_TO_GRASP = 0.103


def synthetic_grasp_db(kind: str, extents, n_yaw: int = 8) -> np.ndarray:
    """Generate hand poses (object frame) approaching the object center.

    Returns [N, 4, 4] panda_hand poses: +z is the approach direction, +y the
    finger-closing axis.  Plays the role of the reference's simulated grasp
    databases (``data/grasps/simulated/<obj>.npy``,
    ``omg/planner.py:466-490``).
    """
    extents = np.asarray(extents, np.float64)
    if kind == "box":
        half = float(np.max(extents) / 2)
    elif kind == "sphere":
        half = float(extents[0])
    else:  # cylinder
        half = float(max(extents[0], extents[1] / 2))
    d = HAND_TO_GRASP  # grasp center at the object center

    poses = []
    # side grasps around z + tilted + top-down
    for pitch in (0.0, np.pi / 4, np.pi / 2):
        for k in range(n_yaw):
            yaw = 2 * np.pi * k / n_yaw
            # approach unit vector pointing AT the center
            a = -np.array([
                np.cos(pitch) * np.cos(yaw),
                np.cos(pitch) * np.sin(yaw),
                np.sin(pitch),
            ])
            z = a / np.linalg.norm(a)
            up = np.array([0.0, 0.0, 1.0])
            if abs(z @ up) > 0.95:
                up = np.array([1.0, 0.0, 0.0])
            y = np.cross(z, up)
            y /= np.linalg.norm(y)
            x = np.cross(y, z)
            m = np.eye(4)
            m[:3, 0], m[:3, 1], m[:3, 2] = x, y, z
            m[:3, 3] = -d * z
            poses.append(m)
            # a second roll about the approach axis
            m2 = m.copy()
            m2[:3, 0], m2[:3, 1] = -x, -y
            poses.append(m2)
    return np.stack(poses)


class SceneObject:
    """An object/obstacle in the planning scene (reference ``Model``,
    ``omg/core.py:81-137``)."""

    def __init__(self, name: str, sdf: SignedDensityField,
                 pose_mat: np.ndarray, target: bool = False,
                 compute_grasp: bool = True,
                 grasps_poses: np.ndarray | None = None,
                 extents: np.ndarray | None = None,
                 points: np.ndarray | None = None):
        self.name = name
        self.sdf = sdf
        self.pose_mat = np.asarray(pose_mat, np.float64)
        self.target = target
        self.compute_grasp = compute_grasp
        self.grasps_poses = grasps_poses if grasps_poses is not None else \
            np.zeros((0, 4, 4))
        self.extents = extents
        self.attached = False
        self.rel_hand_pose = None
        self.points = points  # [K, 3] surface points (camera splats)
        # optional true triangle mesh (verts [V, 3], faces [F, 3]) for
        # mesh-backed objects; viz/raster renders it instead of the
        # primitive proxy when present
        self.mesh: tuple | None = None
        # optional appearance for the textured raster path (reference
        # ycb_renderer textured draw, ycb_renderer.py:1242-1491):
        # per-corner UVs [F, 3, 2] + texture image [th, tw, 3] in [0, 1]
        self.mesh_uv = None
        self.texture = None

    def update_pose(self, pose_mat: np.ndarray):
        self.pose_mat = np.asarray(pose_mat, np.float64)


def make_primitive(name: str, kind: str, extents, pose_mat,
                   target=False, compute_grasp=True,
                   penalize_constant: float = 5.0,
                   delta: float = 0.0075) -> SceneObject:
    sdf = SignedDensityField.from_analytic(kind, extents, delta=delta)
    sdf.penalize_inside(penalize_constant)
    grasps = synthetic_grasp_db(kind, extents) if compute_grasp else None
    extents = np.asarray(extents, np.float64)
    pts = _surface_points(kind, extents)
    obj = SceneObject(name, sdf, pose_mat, target=target,
                      compute_grasp=compute_grasp, grasps_poses=grasps,
                      extents=extents, points=pts)
    obj.kind = kind
    return obj


def _surface_points(kind, extents, n=500, seed=7):
    rng = np.random.default_rng(seed)
    if kind == "sphere":
        v = rng.normal(size=(n, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return v * extents[0]
    if kind == "box":
        half = np.asarray(extents) / 2
        pts = rng.uniform(-half, half, (n, 3))
        axis = rng.integers(0, 3, n)
        sign = rng.choice([-1.0, 1.0], n)
        pts[np.arange(n), axis] = half[axis] * sign
        return pts
    # cylinder
    r, h = extents[0], extents[1]
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-h / 2, h / 2, n)
    return np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)


def pose_at(xyz, yaw: float = 0.0) -> np.ndarray:
    m = np.eye(4)
    c, s = np.cos(yaw), np.sin(yaw)
    m[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    m[:3, 3] = xyz
    return m


# standard start configuration (reference ``omg/core.py:38``)
DEFAULT_START = np.array(
    [0.0, -1.285, 0.0, -2.356, 0.0, 1.571, 0.785, 0.04, 0.04])
DEFAULT_END = np.array(
    [-0.99, -1.74, -0.61, -3.04, 0.88, 1.21, -1.12, 0.04, 0.04])

TABLE_TOP = 0.18
# graspable dimensions stay under the Panda's 0.08 m max gripper opening
_OBJ_KINDS = [
    ("mug", "cylinder", [0.032, 0.10]),
    ("can", "cylinder", [0.030, 0.12]),
    ("cracker_box", "box", [0.055, 0.05, 0.10]),
    ("sugar_box", "box", [0.045, 0.045, 0.14]),
    ("ball", "sphere", [0.032]),
    ("bottle", "cylinder", [0.030, 0.15]),
]


def synthetic_tabletop_scene(scene_id: int, n_obstacles: int = 2):
    """Deterministic synthetic table-top scene (plays the role of
    ``data/scenes/scene_<i>.mat``).

    Returns (objects list with the target first, target_name) — the
    reference's scene layout convention (``omg/core.py:258-278``).
    """
    rng = np.random.default_rng(1000 + scene_id)
    objects = []

    # target on the table in front of the robot
    tkind = _OBJ_KINDS[scene_id % len(_OBJ_KINDS)]
    r = rng.uniform(0.45, 0.62)
    th = rng.uniform(-0.5, 0.5)
    tx, ty = r * np.cos(th), r * np.sin(th)
    tz = TABLE_TOP + _object_half_height(tkind[1], tkind[2])
    objects.append(make_primitive(
        tkind[0], tkind[1], tkind[2],
        pose_at([tx, ty, tz], rng.uniform(0, 2 * np.pi)), target=True))

    # obstacles: the first ones sit on the approach corridor toward the
    # target (so the straight-line initialization collides and the
    # optimizer has real work); the rest scatter as clutter
    placed = [(tx, ty)]
    for i in range(n_obstacles):
        if i < 2:
            # corridor blockers are tall so low approaches must deviate
            okind = ("pitcher", "cylinder", [0.045, 0.24])
        else:
            okind = _OBJ_KINDS[(scene_id + i + 1) % len(_OBJ_KINDS)]
        ox = oy = None
        for attempt in range(30):
            if i < 2:
                # along the base->target chord, slightly offset
                f = rng.uniform(0.55, 0.8)
                perp = rng.uniform(-0.06, 0.06)
                ox = f * tx - perp * np.sin(th)
                oy = f * ty + perp * np.cos(th)
            else:
                ro = rng.uniform(0.4, 0.68)
                tho = rng.uniform(-0.7, 0.7)
                ox, oy = ro * np.cos(tho), ro * np.sin(tho)
            if all((ox - px) ** 2 + (oy - py) ** 2 > 0.11**2
                   for px, py in placed):
                break
        placed.append((ox, oy))
        oz = TABLE_TOP + _object_half_height(okind[1], okind[2])
        objects.append(make_primitive(
            f"{okind[0]}_{i}", okind[1], okind[2],
            pose_at([ox, oy, oz], rng.uniform(0, 2 * np.pi)),
            compute_grasp=False))

    # table: a box under everything (coarser grid, it is large); kept clear
    # of the robot base at the origin
    objects.append(make_primitive(
        "table", "box", [1.0, 1.6, 2 * TABLE_TOP],
        pose_at([0.68, 0.0, 0.0]), compute_grasp=False, delta=0.02))
    return objects, objects[0].name


def _object_half_height(kind, extents):
    if kind == "box":
        return extents[2] / 2
    if kind == "sphere":
        return extents[0]
    return extents[1] / 2
