"""Reference-format fixture writer: the EXACT on-disk formats of the
OMG-Planner data download, with synthetic content.

The reference consumes (``omg/core.py:86-126``, ``omg/planner.py:466-490``):

  * ``<obj>/model_normalized_chomp.pth`` — torch dict with
    ``sdf_torch [1, 1, X, Y, Z]``, ``min_coords``, ``max_coords``,
    ``delta`` (written by ``real_world/convert_sdf.py:66-78``; the loader
    permutes the first two volume axes, ``sdf_tools.py:191``).
  * ``<obj>/model_normalized.xyz`` — whitespace point cloud.
  * ``<obj>/model_normalized.extent.txt`` — 3 floats.
  * ``data/grasps/simulated/<obj>.npy`` — pickled dict with
    ``transforms [N, 4, 4]`` hand poses which the loader post-multiplies
    by rotZ(pi/2) (``omg/planner.py:485``).
  * ``data/scenes/<scene>.mat`` — ``pose [O, 4, 4]``, ``path`` (object
    dir names), optional ``target_name``.

These fixtures give ``io/reference_data.py`` a real-format consumer:
anyone with the actual YCB download can point the same loaders at it
unchanged.

A copy of ``omg_planner_tpu/io/ref_fixtures.py``.
"""

from __future__ import annotations

import os

import numpy as np

from .assets import synthetic_grasp_db
from ..ops.sdf import SignedDensityField

_ROT_Z90 = np.array([[0.0, -1.0, 0, 0], [1.0, 0.0, 0, 0],
                     [0, 0, 1.0, 0], [0, 0, 0, 1.0]])


def write_chomp_pth(path: str, sdf: SignedDensityField) -> None:
    """Store an SDF in the ``*_chomp.pth`` layout.  The reference loader
    reads ``sdf_torch[0, 0].permute(1, 0, 2)``, so we store the volume
    with its first two axes swapped (the permute is an involution)."""
    import torch

    stored = np.ascontiguousarray(sdf.data.transpose(1, 0, 2))
    mn = np.asarray(sdf.origin, np.float64)
    dims = np.asarray(sdf.data.shape, np.float64)
    # min/max_coords MUST be torch tensors and delta a plain float — the
    # reference loader calls ``.numpy()`` on them (sdf_tools.py:189-193)
    # and convert_sdf.py:69-76 writes exactly this
    torch.save(
        {
            "sdf_torch": torch.from_numpy(stored[None, None]),
            "min_coords": torch.from_numpy(mn),
            "max_coords": torch.from_numpy(mn + dims * sdf.delta),
            "delta": float(sdf.delta),
        },
        path,
    )


def write_grasp_db(path: str, hand_poses_obj: np.ndarray) -> None:
    """Store hand poses (object frame) as the simulated-grasp ``.npy``
    format.  ``load_grasp_set`` post-multiplies the stored transforms by
    rotZ(pi/2), so we store ``poses @ rotZ(-pi/2)`` and the loader
    round-trips to exactly ``hand_poses_obj``."""
    transforms = hand_poses_obj @ np.linalg.inv(_ROT_Z90)
    np.save(path, {"transforms": transforms, "successes": np.ones(
        len(transforms))}, allow_pickle=True)


def write_object_dir(base: str, kind: str, extents, delta: float = 0.0075,
                     n_points: int = 400) -> None:
    """One reference object directory: chomp.pth + xyz + extent.txt."""
    os.makedirs(base, exist_ok=True)
    sdf = SignedDensityField.from_analytic(kind, extents, delta=delta)
    # NOTE: no penalize_inside here — the reference stores the raw SDF and
    # applies the inside penalty at load (core.py:111; our
    # load_reference_object does the same)
    write_chomp_pth(os.path.join(base, "model_normalized_chomp.pth"), sdf)
    extents = np.resize(np.asarray(extents, np.float64), 3)
    np.savetxt(os.path.join(base, "model_normalized.extent.txt"),
               extents[None])
    rng = np.random.default_rng(11)
    if kind == "box":
        half = extents / 2
        pts = rng.uniform(-half, half, (n_points, 3))
        ax = rng.integers(0, 3, n_points)
        sign = rng.choice([-1.0, 1.0], n_points)
        pts[np.arange(n_points), ax] = half[ax] * sign
    else:
        v = rng.normal(size=(n_points, 3))
        pts = v / np.linalg.norm(v, axis=1, keepdims=True) * extents[0] / 2
    np.savetxt(os.path.join(base, "model_normalized.xyz"), pts)


def write_mat_scene(path: str, object_rel_paths, poses,
                    target_name: str | None = None) -> None:
    """Reference scene ``.mat``."""
    import scipy.io as sio

    data = {
        "pose": np.asarray(poses, np.float64),
        "path": np.array([p.ljust(64) for p in object_rel_paths]),
    }
    if target_name is not None:
        data["target_name"] = np.array([target_name])
    sio.savemat(path, data)


def make_parity_tree(root: str, n_scenes: int = 8) -> list:
    """A multi-scene reference-format tree for trajectory-parity runs.
    Returns the scene ``.mat`` paths; goals are NOT
    baked here — ``scripts/parity_run.py prepare`` adds per-scene
    precomputed goal sets (the ``load_goal_from_scene`` format,
    ``omg/planner.py:155-174``).

    Scene difficulty is deliberate and spans the planner's regimes
    (measured with the parity config; the straight joint-space spline from
    the home config arcs DOWN onto the target from z~0.7, so only overhead
    "shelf" geometry actually contests it — walls and posts between base
    and target are simply flown over):

      s%4==0  trivial     obstacles clear of every approach (2-step
                          pre-terminate; pins the trivial-verdict path)
      s%4==1  mild        shelf at z=0.30 over the target (3-6 steps)
      s%4==2  contested   lower shelf + side wall: the optimizer must
                          re-route under the shelf (10-30 steps, learner
                          goal switches)
      s%4==3  hard        full low shelf: expected honest FAIL verdicts
                          on both planners (full budget)
    """
    from .assets import pose_at

    objs = os.path.join(root, "data", "objects")
    grasps = os.path.join(root, "data", "grasps", "simulated")
    scenes = os.path.join(root, "data", "scenes")
    for d in (objs, grasps, scenes):
        os.makedirs(d, exist_ok=True)

    write_object_dir(os.path.join(objs, "parity_box"),
                     "box", [0.05, 0.05, 0.14])
    write_grasp_db(os.path.join(grasps, "parity_box.npy"),
                   synthetic_grasp_db("box", [0.05, 0.05, 0.14]))
    write_object_dir(os.path.join(objs, "parity_can"),
                     "cylinder", [0.033, 0.12])
    write_grasp_db(os.path.join(grasps, "parity_can.npy"),
                   synthetic_grasp_db("cylinder", [0.033, 0.12]))
    write_object_dir(os.path.join(objs, "parity_block"),
                     "box", [0.09, 0.06, 0.07])
    write_object_dir(os.path.join(objs, "parity_shelf"),
                     "box", [0.42, 0.50, 0.05], delta=0.014)
    write_object_dir(os.path.join(objs, "parity_sidewall"),
                     "box", [0.45, 0.05, 0.24], delta=0.014)

    rng = np.random.default_rng(42)
    paths = []
    for s in range(n_scenes):
        target_kind = ["parity_box", "parity_can"][s % 2]
        tx = 0.48 + 0.06 * rng.random()
        ty = -0.08 + 0.16 * rng.random()
        tpos = [tx, ty, 0.07 if target_kind == "parity_box" else 0.06]
        rels = [f"data/objects/{target_kind}"]
        poses = [pose_at(tpos)]
        kind = s % 4
        if kind == 1:
            rels.append("data/objects/parity_shelf")
            poses.append(pose_at([tx + 0.02, ty, 0.30]))
        elif kind == 2:
            side = 1.0 if (s // 4) % 2 else -1.0
            rels.append("data/objects/parity_shelf")
            poses.append(pose_at([tx + 0.01, ty, 0.26]))
            rels.append("data/objects/parity_sidewall")
            poses.append(pose_at([tx, ty + side * 0.20, 0.12]))
        elif kind == 3:
            rels.append("data/objects/parity_shelf")
            poses.append(pose_at([tx, ty, 0.22]))
        else:
            # trivial: a distant block
            rels.append("data/objects/parity_block")
            poses.append(pose_at([0.32, ty - 0.25, 0.045]))
        mat = os.path.join(scenes, f"parity_scene_{s}.mat")
        write_mat_scene(mat, rels, np.stack(poses), target_name=target_kind)
        paths.append(mat)
    return paths


def make_fixture_tree(root: str) -> str:
    """A minimal reference-format data tree: two objects (a graspable box
    target + a cylinder obstacle) and one tabletop scene.  Returns the
    scene ``.mat`` path.  Layout mirrors the download
    (``data/objects/...``, ``data/grasps/simulated/...``,
    ``data/scenes/...``)."""
    objs = os.path.join(root, "data", "objects")
    grasps = os.path.join(root, "data", "grasps", "simulated")
    scenes = os.path.join(root, "data", "scenes")
    for d in (objs, grasps, scenes):
        os.makedirs(d, exist_ok=True)

    write_object_dir(os.path.join(objs, "fixture_box"),
                     "box", [0.05, 0.05, 0.14])
    write_grasp_db(os.path.join(grasps, "fixture_box.npy"),
                   synthetic_grasp_db("box", [0.05, 0.05, 0.14]))
    write_object_dir(os.path.join(objs, "fixture_cyl"),
                     "cylinder", [0.04, 0.12])

    from .assets import pose_at

    poses = np.stack([
        pose_at([0.52, 0.08, 0.07]),    # target box on the table
        pose_at([0.48, -0.18, 0.06]),   # cylinder obstacle
    ])
    mat_path = os.path.join(scenes, "fixture_scene.mat")
    write_mat_scene(
        mat_path,
        ["data/objects/fixture_box", "data/objects/fixture_cyl"],
        poses, target_name="fixture_box")
    return mat_path
