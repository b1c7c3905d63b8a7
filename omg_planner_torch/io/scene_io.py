"""Scene/result persistence: reference ``.mat`` compatibility + native npz
(numpy copy of ``omg_planner_tpu/io/scene_io.py``).

The reference's scene files (``data/scenes/*.mat``) hold object mesh paths +
4x4 poses, optionally precomputed ``goals``/``reach_grasps``/``grasp_iks``
(``omg/core.py:258-278``, ``omg/planner.py:155-174``).  We read that format
with scipy, and define a self-contained ``.npz`` equivalent for scenes
built from primitives (the committed suite, ``data/suite_v2/``).  Result
shards (per-scene trajectories + diagnostics) mirror the demonstration
saver (``bullet/gen_data.py:21-49``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def load_mat_scene(path: str) -> dict:
    """Load a reference scene ``.mat``: returns dict with ``pose [O,4,4]``,
    ``path`` (mesh dir names), optional ``goals``, ``reach_grasps``,
    ``grasp_iks``, ``target_name``."""
    import scipy.io as sio

    scene = sio.loadmat(path)
    out = {
        "pose": np.asarray(scene["pose"]),
        "path": [p.strip() for p in scene["path"]],
    }
    for k in ("goals", "reach_grasps", "grasp_iks"):
        if k in scene:
            out[k] = np.asarray(scene[k])
    if "target_name" in scene:
        out["target_name"] = str(scene["target_name"][0])
    return out


def save_npz_scene(path: str, objects, target_name: str,
                   goals: Optional[np.ndarray] = None,
                   reach_grasps: Optional[np.ndarray] = None):
    """Persist a primitive scene: object kinds/extents/poses + optional
    precomputed goal sets."""
    kinds, extents, poses, names, deltas = [], [], [], [], []
    for o in objects:
        kinds.append(getattr(o, "kind", "box"))
        extents.append(np.resize(np.asarray(o.extents, np.float64), 3)
                       if o.extents is not None else np.zeros(3))
        poses.append(o.pose_mat)
        names.append(o.name)
        deltas.append(o.sdf.delta)
    data = dict(
        kinds=np.array(kinds), extents=np.array(extents),
        poses=np.array(poses), names=np.array(names),
        deltas=np.array(deltas),
        target_name=np.array(target_name))
    if goals is not None:
        data["goals"] = goals
    if reach_grasps is not None:
        data["reach_grasps"] = reach_grasps
    np.savez_compressed(path, **data)


def load_npz_scene(path: str) -> dict:
    d = dict(np.load(path, allow_pickle=True))
    d["target_name"] = str(d["target_name"])
    return d


def objects_from_npz(d: dict):
    """Rebuild primitive SceneObjects from a loaded scene dict.

    Returns (objects, target_name); only the target gets a grasp DB.
    """
    from .assets import make_primitive

    objects = []
    deltas = d.get("deltas")
    for i, (kind, ext, pose, nm) in enumerate(
            zip(d["kinds"], d["extents"], d["poses"], d["names"])):
        is_target = str(nm) == d["target_name"]
        kw = {"delta": float(deltas[i])} if deltas is not None else {}
        objects.append(make_primitive(
            str(nm), str(kind), np.trim_zeros(np.asarray(ext), "b"),
            pose, target=is_target, compute_grasp=is_target, **kw))
    return objects, d["target_name"]


def save_result_shard(path: str, scene_id: int, traj: np.ndarray,
                      info: dict):
    """Per-scene result record (trajectory + diagnostics)."""
    np.savez_compressed(
        path, scene_id=scene_id, traj=traj,
        **{k: np.asarray(v) for k, v in info.items()})


def save_demonstration(path: str, traj: np.ndarray, goals: np.ndarray,
                       scene_meta: dict, observations: dict | None = None):
    """Demonstration record (reference ``bullet/gen_data.py:21-44``):
    successful trajectory + goal set + scene layout (+ optional frames)."""
    data = {"traj": traj, "goals": goals}
    data.update({f"scene_{k}": np.asarray(v) for k, v in scene_meta.items()})
    if observations:
        data.update(
            {f"obs_{k}": np.asarray(v) for k, v in observations.items()})
    np.savez_compressed(path, **data)
