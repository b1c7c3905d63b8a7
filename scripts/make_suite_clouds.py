"""Freeze the observed clouds of the suite's scenes for the benchmark's
perception cell: ``benchmark/data/suite_v2_clouds/scene_<k>.npz`` and its
``manifest.json``.

    python3 scripts/make_suite_clouds.py [--cpu]

Each scene of ``benchmark/data/suite_v2`` is seen by the point-splat
camera (``viz/camera.py``) at 640 x 480 with fx = fy = 525, from the
reference CLI's view (``DEFAULT_VIEW``).  The segmentation drops the
target's points and the rest are subsampled to 3072 with a fixed seed
(``__main__.observe_obstacles``).  Where a view shows fewer than 3072
obstacle points, the splat's ``densify`` is raised (4, 6, 8, ...), never
the cap.  Each file holds ``points`` [3072, 3] and ``grasps`` [48, 4, 4]
(the target's grasp database in the world frame,
``Env.grasp_poses_world()``, standing in for a grasp detector), float32
as the service holds them.  The manifest records for each scene the
obstacle points seen and kept, the densify, the grid's dims and cells at
0.02 m with a 0.24 m margin, and the steps and verdict of the scene's
plan through ``/plan_cloud`` at the full ``OMGConfig()`` (the benchmark's
strata rank the scenes by those steps).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE = os.path.join(ROOT, "benchmark", "data", "suite_v2")
OUT = os.path.join(ROOT, "benchmark", "data", "suite_v2_clouds")
START = [0.0, -1.285, 0.0, -2.356, 0.0, 1.571, 0.785, 0.04, 0.04]
POINTS = 3072
CAMERA = dict(width=640, height=480, fx=525.0, fy=525.0)


def observe(scene) -> tuple:
    """(points kept, obstacle points seen, densify) of a scene's view."""
    from omg_planner_torch.__main__ import observe_obstacles

    densify = 4
    while True:
        seen = len(observe_obstacles(scene, sys.maxsize, densify=densify,
                                     **CAMERA))
        if seen >= POINTS:
            break
        densify += 2
    kept = observe_obstacles(scene, POINTS, densify=densify, **CAMERA)
    return kept.astype(np.float32), seen, densify


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from omg_planner_torch.apps import serve
    from omg_planner_torch.config import OMGConfig
    from omg_planner_torch.ops.pointsdf import grid_layout
    from omg_planner_torch.planner.scene import PlanningScene

    torch.set_num_threads(4)
    device = "cpu" if args.cpu else "cuda"
    cfg = OMGConfig(silent=True, sdf_analytic=False, use_point_sdf=True)
    os.makedirs(OUT, exist_ok=True)
    scenes = []
    for k in range(len(glob.glob(os.path.join(SUITE, "scene_*.npz")))):
        scene = PlanningScene.from_npz(
            cfg, os.path.join(SUITE, f"scene_{k}.npz"), device="cpu")
        points, seen, densify = observe(scene)
        grasps = scene.env.grasp_poses_world().astype(np.float32)
        np.savez_compressed(os.path.join(OUT, f"scene_{k}.npz"),
                            points=points, grasps=grasps)
        _, dims, _ = grid_layout(points, 0.02, 0.24)
        body = {"points": points.tolist(),
                "grasps": grasps.reshape(-1, 16).tolist(), "start": START}
        code, out = serve.plan_cloud_request(body, cfg, device)
        if code != 200:
            raise RuntimeError(f"scene {k}: /plan_cloud answered {code}: "
                               f"{out}")
        row = {"scene": k, "steps": out["steps_used"],
               "success": out["flag"], "n_goals": out["n_goals"],
               "points_seen": seen, "points": len(points),
               "densify": densify, "grid_dims": list(dims),
               "grid_cells": int(np.prod(dims))}
        scenes.append(row)
        print(json.dumps(row), flush=True)
    cells = [s["grid_cells"] for s in scenes]
    manifest = {
        "n": len(scenes), "source": "benchmark/data/suite_v2",
        "camera": dict(CAMERA, view="viz/camera.py::DEFAULT_VIEW"),
        "points": POINTS, "resolution": 0.02, "margin": 0.24,
        "start": START, "device": device,
        "grid_cells": {"min": min(cells), "median": float(np.median(cells)),
                       "max": max(cells)},
        "success_rate": float(np.mean([s["success"] for s in scenes])),
        "scenes": scenes}
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
