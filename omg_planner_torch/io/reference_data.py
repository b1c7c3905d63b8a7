"""Loaders for the reference's original data formats.

For users who have the OMG-Planner data download (``download_data.sh``):
simulated grasp databases (``data/grasps/simulated/<obj>.npy``), object
assets (``model_normalized_chomp.pth`` SDFs, ``.xyz`` point clouds,
``.extent.txt``), and scene ``.mat`` files.  The synthetic asset pipeline
(``io/assets.py``) is the self-contained default; this module makes real
YCB data a drop-in.

A copy of ``omg_planner_tpu/io/reference_data.py``; the Env it builds
stages on the device the caller names.
"""

from __future__ import annotations

import os

import numpy as np

from ..ops.sdf import SignedDensityField
from .assets import SceneObject


def load_grasp_db(path: str, object_name: str) -> np.ndarray:
    """Simulated grasp database -> hand poses in the object frame.

    Reproduces ``load_grasp_set`` (``omg/planner.py:466-490``): the stored
    ``transforms`` are post-multiplied by rotZ(pi/2) and filtered through
    the per-object YCB special cases.
    """
    raw = np.load(path, allow_pickle=True, fix_imports=True,
                  encoding="bytes").item()
    transforms = raw.get("transforms", raw.get(b"transforms"))
    pose_grasp = np.asarray(transforms)
    rot_z90 = np.array([[0.0, -1.0, 0, 0], [1.0, 0.0, 0, 0],
                        [0, 0, 1.0, 0], [0, 0, 0, 1.0]])
    pose_grasp = pose_grasp @ rot_z90
    return ycb_special_case(pose_grasp, object_name)


def ycb_special_case(pose_grasp: np.ndarray, name: str) -> np.ndarray:
    """Per-object grasp constraints (reference ``omg/util.py:335-365``)."""
    def eulers_y(poses):
        # y euler angle of each rotation (sxyz convention middle angle)
        return np.arcsin(-np.clip(poses[:, 2, 0], -1.0, 1.0))

    if name in ("037_scissors", "061_foam_brick"):
        keep = ((np.abs(pose_grasp[:, 2, 3]) > 0.09)
                & (np.abs(pose_grasp[:, 1, 3]) > 0.02)
                & (np.abs(pose_grasp[:, 0, 3]) < 0.05))
        pose_grasp = pose_grasp[keep]
        pose_grasp = pose_grasp[np.abs(eulers_y(pose_grasp)) > 0.06]
    elif name in ("024_bowl", "025_mug", "010_potted_meat_can"):
        angle = 50.0 if name == "024_bowl" else 30.0
        keep = np.abs(eulers_y(pose_grasp)) > angle * np.pi / 180
        pose_grasp = pose_grasp[keep]
        fwd = np.eye(4)
        fwd[2, 3] = 0.02
        pose_grasp = pose_grasp @ fwd
    return pose_grasp


def load_reference_object(data_root: str, rel_path: str, pose_mat,
                          target: bool = False, name: str | None = None,
                          cfg=None, penalize: bool = True) -> SceneObject:
    """Build a SceneObject from a reference object directory
    (``Model.__init__``, ``omg/core.py:86-126``).

    ``penalize=False`` reproduces the reference's EFFECTIVE runtime grids:
    its x5 inside-penalty mutates only the numpy ``sdf.data``
    (``core.py:110``) while ``combine_sdfs`` stacks the pre-penalty
    ``data_torch`` (``core.py:379``; ``resize`` scales both but never
    rebuilds, ``sdf_tools.py:37-45``) — so the CUDA kernel never sees the
    penalty.  Our default keeps the penalty (it is strictly protective);
    parity runs must switch it off."""
    base = os.path.join(data_root, rel_path)
    sdf = SignedDensityField.from_pth(
        os.path.join(base, "model_normalized_chomp.pth"))
    if cfg is not None:
        sdf.resize(cfg.target_size if target else cfg.obstacle_size)
        if penalize:
            sdf.penalize_inside(cfg.penalize_constant)
    elif penalize:
        sdf.penalize_inside(5.0)
    model_name = rel_path.rstrip("/").split("/")[-1]
    name = name or model_name
    extents = None
    ext_file = os.path.join(base, "model_normalized.extent.txt")
    if os.path.exists(ext_file):
        extents = np.loadtxt(ext_file)
    points = None
    xyz_file = os.path.join(base, "model_normalized.xyz")
    if os.path.exists(xyz_file):
        pts = np.loadtxt(xyz_file)[:, :3]
        stride = max(len(pts) // 500, 1)
        points = pts[::stride][:500]
    grasps = None
    grasp_file = os.path.join(data_root, "data/grasps/simulated",
                              model_name + ".npy")
    if os.path.exists(grasp_file):
        grasps = load_grasp_db(grasp_file, model_name)
    return SceneObject(name, sdf, pose_mat, target=target,
                       compute_grasp=grasps is not None,
                       grasps_poses=grasps, extents=extents, points=points)


def env_from_mat_scene(cfg, mat_path: str, data_root: str, model=None,
                       penalize: bool = True, device=None):
    """Reference scene ``.mat`` -> Env (``Env.__init__``,
    ``omg/core.py:258-278``) on ``device`` (``cuda`` unless named): first
    object is the target unless ``target_name`` overrides."""
    from ..io.scene_io import load_mat_scene
    from ..planner.scene import Env

    scene = load_mat_scene(mat_path)
    env = Env(cfg, model=model, device=device)
    for i, (rel, pose) in enumerate(zip(scene["path"], scene["pose"])):
        env.add_object(load_reference_object(
            data_root, rel, pose, target=(i == 0), cfg=cfg,
            penalize=penalize))
    if "target_name" in scene:
        env.set_target(scene["target_name"])
    else:
        env.set_target(env.objects[0].name)
    return env, scene
