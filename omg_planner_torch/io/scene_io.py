"""Scene persistence: the self-contained ``.npz`` scene format of the
committed benchmark suite (``data/suite_v2/``).

Numpy copy of the loaders and the result shard of
``omg_planner_tpu/io/scene_io.py`` (``.mat`` loading and demonstration
records are queued).
"""

from __future__ import annotations

import numpy as np


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
