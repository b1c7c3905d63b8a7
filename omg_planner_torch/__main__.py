"""Command-line entry point (counterpart of
``omg_planner_tpu/__main__.py``; reference ``python -m omg.core``,
``omg/core.py:782-885``).

Modes:
  python -m omg_planner_torch -f 0              one synthetic scene by id
  python -m omg_planner_torch -f scene.npz      scene from an .npz file
  python -m omg_planner_torch -p -f 0           perception mode: plan against
                                                a point-cloud SDF of the scene
  python -m omg_planner_torch -exp              plan the pinned suite
                                                (data/suite_v2) through the
                                                suite runner into output_suite/
  add --fast for the history-free plan, --cpu to run on the CPU
  (the default device is cuda; without a GPU the CLI raises)
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np


def _load_scene(cfg, name: str, n_obstacles: int, traj_init: str = "grasp",
                device=None):
    from .planner.scene import PlanningScene

    if name.endswith(".npz") and os.path.exists(name):
        scene = PlanningScene.from_npz(cfg, name, device=device)
        if traj_init == "scene":
            from .io.scene_io import load_npz_scene
            d = load_npz_scene(name)
            if "goals" in d:
                # precomputed goals from the scene file (planner.py:155-174)
                scene.set_precomputed_goals(d["goals"], d.get("reach_grasps"))
        return scene
    return PlanningScene.synthetic(cfg, scene_id=int(name),
                                   n_obstacles=n_obstacles, device=device)


def observe_obstacles(full, max_points: int = 3072) -> np.ndarray:
    """The perception cloud of a scene: the point-splat camera's partial
    view, split by segmentation into target vs obstacles, obstacles kept
    (subsampled to ``max_points`` with a fixed seed)."""
    from .viz.camera import render_point_observation

    pts, labels, _depth, _seg = render_point_observation(full.env.objects)
    nontarget = pts[labels != full.env.target_idx].astype(np.float32)
    if len(nontarget) > max_points:
        nontarget = nontarget[
            np.random.default_rng(0).choice(len(nontarget), max_points,
                                            replace=False)]
    return nontarget


def perception_plan(cfg, scene_id: int, n_obstacles: int, device=None):
    """Plan from observed points (reference ``-p`` flow,
    ``omg/core.py:826-867``): build the full scene's goal set, observe the
    obstacles as a point cloud, rebuild a PointEnv from it, and reuse the
    goal set's hand poses as external grasps.  Returns the PlanningScene,
    or None when the full scene has no grasps."""
    import torch

    from .models import panda
    from .planner.scene import PlanningScene, PointEnv

    full = PlanningScene.synthetic(cfg, scene_id=scene_id,
                                   n_obstacles=n_obstacles, device=device)
    goal_set = full.build_goal_set()
    mask = goal_set.mask.cpu().numpy()
    grasp_configs = goal_set.grasps.cpu().numpy()[mask]
    if len(grasp_configs) == 0:
        print("no grasps found for perception mode")
        return None
    hands = panda.hand_pose_batch(
        full.model, torch.as_tensor(grasp_configs, device=full.device))
    env = PointEnv(cfg, device=full.device)
    env.compute_sdf_from_points(observe_obstacles(full))
    scene = PlanningScene(cfg, env)
    scene.external_grasps = hands.cpu().numpy()
    return scene


def main(argv=None):
    ap = argparse.ArgumentParser(prog="omg_planner_torch")
    ap.add_argument("-f", "--file", default="0",
                    help="scene id (int) or scene .npz path")
    ap.add_argument("-exp", "--experiment", action="store_true",
                    help="plan the pinned suite with execution validation")
    ap.add_argument("-p", "--perception", action="store_true")
    ap.add_argument("-g", "--grasp", default="grasp",
                    choices=["grasp", "scene"],
                    help="goal init: grasp DB IK, or precomputed scene goals")
    ap.add_argument("--obstacles", type=int, default=2)
    ap.add_argument("--fast", action="store_true",
                    help="history-free plan")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of cuda")
    args = ap.parse_args(argv)

    from .config import OMGConfig

    device = "cpu" if args.cpu else None
    cfg = OMGConfig()
    if args.grasp == "scene":
        cfg = cfg.replace(use_standoff=False)  # planner.py:160-161
    if args.experiment:
        from .planner.runner import SuiteRunner

        suite = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data", "suite_v2")
        t0 = time.time()
        runner = SuiteRunner(
            "output_suite", cfg.replace(use_standoff=False, silent=True),
            scene_source="npz", suite_dir=suite, device=device)
        out = runner.run(range(100))
        print(f"total: {out['success']}/{out['total']} planned, "
              f"{out['exec_valid']} execution-valid in "
              f"{time.time() - t0:.1f}s")
        return
    if args.perception:
        scene = perception_plan(cfg, int(args.file), args.obstacles, device)
    else:
        scene = _load_scene(cfg, args.file, args.obstacles, args.grasp,
                            device)
    if scene is not None:
        scene.step(fast=args.fast)


if __name__ == "__main__":
    main()
