"""Demonstration generation: plan random scenes, keep executed successes
(counterpart of ``omg_planner_tpu/apps/gen_demos.py``).

Reference ``bullet/gen_data.py:52-167`` loops random scenes, plans,
executes in PyBullet, and saves only trajectories whose lift reward is
positive (``:153`` — ``if rew > 0``).  This mirrors that exactly: each
planned grasp is replayed in the rigid-body stepper
(:mod:`omg_planner_torch.physics`, on the scene's device: one launch of
the ``rigid_rollout`` kernel per planned scene on the card) and kept only
if the simulated lift scores reward 1; the reward and lifted height ride
along in the saved demo.  ``sim_verify=False`` falls back to the planner's
``execute`` criterion alone (collision-free + smooth,
``omg/cost.py:501-503``).

Usage:  python -m omg_planner_torch.apps.gen_demos -n 20 -o data/demos
[--cpu] [--obs] [--no-sim] [--exec-retries N]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import OMGConfig
from ..io import scene_io
from ..planner.scene import PlanningScene


def generate(n_scenes: int, out_dir: str, cfg: OMGConfig | None = None,
             n_obstacles: int = 3, fast: bool = True,
             observations: bool = False, sim_verify: bool = True,
             exec_retries: int = 0, device=None) -> int:
    """Plan synthetic scenes ``0..n_scenes-1`` on ``device`` (``cuda``
    unless the caller names another) and save the kept demonstrations to
    ``out_dir/demo_<id>.npz``; returns how many were kept.

    ``observations=True`` records the RGB/depth/segmentation frame of
    each kept scene (the reference stores rendered observations with its
    demonstrations, ``bullet/gen_data.py:30-43``; RGB from
    ``viz/raster.py``).  ``sim_verify=True`` (default) keeps only demos
    whose grasp lifts in the physics stepper, the reference's ``rew > 0``
    filter (``gen_data.py:153``)."""
    cfg = cfg or OMGConfig(silent=True)
    os.makedirs(out_dir, exist_ok=True)
    kept = 0
    for sid in range(n_scenes):
        scene = PlanningScene.synthetic(cfg, scene_id=sid,
                                        n_obstacles=n_obstacles,
                                        device=device)
        res = scene.step(fast=fast)
        if res is None or not bool(res.info.execute):
            continue
        rep = None
        if sim_verify:
            from ..physics import NoMassModelError, execute_plan

            try:
                rep = execute_plan(scene, np.asarray(res.traj))
            except NoMassModelError:  # no mass model: planner verdict only
                rep = None
            if rep is not None and rep.reward != 1:
                # the reference drops failed rollouts (gen_data.py:153);
                # exec_retries > 0 salvages the scene instead — steer to
                # a goal whose lift verifies (planner/exec_verify.py)
                if exec_retries > 0:
                    from ..planner.exec_verify import plan_execute_verified

                    # seed with the failure just observed: the loop
                    # starts from its blacklist instead of re-planning
                    # and re-rolling the known-bad attempt
                    out = plan_execute_verified(
                        scene, exec_retries=exec_retries,
                        seed=(res, rep))
                    if out is None or not out.verified:
                        continue
                    res, rep = out.result, out.report
                else:
                    continue        # planned fine but does not lift: drop
        mask = scene.goal_set.mask.cpu().numpy()
        goals = scene.goal_set.grasps.cpu().numpy()[mask]
        meta = {
            "poses": np.stack([o.pose_mat for o in scene.env.objects]),
            "names": np.array([o.name for o in scene.env.objects]),
            "target": np.array(scene.env.target.name),
        }
        if rep is not None:
            meta["sim_reward"] = np.array(rep.reward)
            meta["sim_lifted_m"] = np.array(rep.lifted_m)
        obs = None
        if observations:
            from ..viz.raster import render_rgb

            rgb, depth, seg = render_rgb(scene.env.objects)
            obs = {"rgb": rgb,
                   "depth": np.where(np.isfinite(depth), depth, 0.0),
                   "seg": seg}
        scene_io.save_demonstration(
            os.path.join(out_dir, f"demo_{sid}.npz"),
            res.traj, goals, meta, observations=obs)
        kept += 1
    return kept


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=20)
    ap.add_argument("-o", "--out", default="data/demonstrations")
    ap.add_argument("--cpu", action="store_true",
                    help="plan and execute on the CPU instead of cuda")
    ap.add_argument("--obs", action="store_true",
                    help="record RGB/depth/seg observation frames")
    ap.add_argument("--no-sim", action="store_true",
                    help="skip physics verification (keep on the "
                         "planner's execute verdict alone)")
    ap.add_argument("--exec-retries", type=int, default=0,
                    help="salvage failed lifts by re-planning with the "
                         "failed goal blacklisted (instead of the "
                         "reference's drop-the-demo filter)")
    args = ap.parse_args(argv)
    from .. import resolve_device

    kept = generate(args.n, args.out, observations=args.obs,
                    sim_verify=not args.no_sim,
                    exec_retries=args.exec_retries,
                    device=resolve_device("cpu" if args.cpu else None))
    print(f"saved {kept}/{args.n} successful demonstrations to {args.out}")
    return kept


if __name__ == "__main__":
    main()
