"""Multi-process sharded planning demo (counterpart of
``scripts/multihost_demo.py``): runs ``parallel/multihost.py`` with more
than one process.

The parent spawns ``--world`` ranks (``parallel/launch.py``: rendezvous
through a ``FileStore`` in a temporary directory, never a fixed TCP port)
on a (scene x goal) mesh of ``--world / --goal-parallel`` scene rows.
Each rank:

  1. stages its row's scenes (``my_scene_ids``) and stacks them
     (``host_local_batch``);
  2. runs the goal-sharded pipeline (sharded IK goal-set build, then the
     goal-sharded plan; ``parallel/batch.py::make_sharded_pipeline``);
  3. runs the same pipeline in one process on the same inputs and checks
     that the results agree (goal, verdict, steps; trajectory within
     1e-6 rad), and prints ``[child i] ok``.

The parent prints each rank's last lines and ``MULTIHOST DEMO: PASS`` or
``FAIL``, and exits non-zero on a failure or a rank's time-out.

    python -m omg_planner_torch.apps.multihost_demo --cpu   # 4 gloo ranks
    python -m omg_planner_torch.apps.multihost_demo         # NCCL, a card
                                                # for each of the 4 ranks
    python -m omg_planner_torch.apps.multihost_demo --world 2 \\
        --goal-parallel 2 --backend gloo   # two ranks on one card
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch

from ..config import OMGConfig
from ..parallel import launch

SCENES_PER_ROW = 2
# the JAX demo's configuration (``__graft_entry__._small_cfg`` with its
# demo overrides)
DEMO_CFG = OMGConfig(
    optim_steps=3, extra_smooth_steps=1, timesteps=12, goal_set_max_num=8,
    ik_seed_num=2, ik_max_iters=20, learner_interp_steps=6,
    ik_two_stage=False, increment_iks=False, silent=True)
TRAJ_ATOL = 1e-6


def child(mesh):
    """One rank: stage, plan sharded and unsharded, compare, report."""
    from ..parallel.batch import make_sharded_pipeline, scene_pipeline_input
    from ..parallel.multihost import host_local_batch, my_scene_ids
    from ..planner.scene import PlanningScene

    cfg = DEMO_CFG
    ids = my_scene_ids(SCENES_PER_ROW * mesh.rows, mesh)
    scenes = [PlanningScene.synthetic(cfg, scene_id=sid % 2, n_obstacles=1,
                                      device=mesh.device) for sid in ids]
    n_obj = max(len(s.env.objects) for s in scenes)
    n_grasp = max(len(s.env.grasp_poses_world()) for s in scenes)
    batch = host_local_batch(mesh, [
        scene_pipeline_input(s, seed=sid, num_objects=n_obj,
                             num_grasps=n_grasp)
        for sid, s in zip(ids, scenes)])
    model = scenes[0].model
    res = make_sharded_pipeline(mesh, model, cfg)(batch)
    ref = make_sharded_pipeline(None, model, cfg)(batch)
    traj = res.traj.cpu().numpy()
    if traj.shape != (len(ids), cfg.timesteps, 9) or \
            not np.isfinite(traj).all():
        raise AssertionError(f"bad trajectories {traj.shape}")
    for name in ("goal_idx", "flag", "steps_used"):
        if not torch.equal(getattr(res, name), getattr(ref, name)):
            raise AssertionError(f"{name} differs from one process")
    gap = float(np.abs(traj - ref.traj.cpu().numpy()).max())
    if gap > TRAJ_ATOL:
        raise AssertionError(f"trajectory {gap:.3g} from one process")
    print(f"[child {mesh.rank}] ok: scene row {mesh.scene_row}, goal column "
          f"{mesh.goal_col}, scenes {ids}, traj {traj.shape}, goal_idx "
          f"{res.goal_idx.tolist()}, flag {res.flag.tolist()}, steps "
          f"{res.steps_used.tolist()}, max gap to one process {gap:.3g}",
          flush=True)
    return dict(ids=ids, goal_idx=res.goal_idx.tolist())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--goal-parallel", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (default: the card)")
    ap.add_argument("--backend", default=None,
                    help="override: nccl (cuda default) or gloo")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    if args.world % args.goal_parallel:
        ap.error("--world must be divisible by --goal-parallel")
    device = "cpu" if args.cpu else "cuda"
    if device == "cuda" and not torch.cuda.is_available():
        print("multihost_demo: no CUDA device (pass --cpu)", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="omg_multihost_") as work:
        runs = launch.spawn(
            "omg_planner_torch.apps.multihost_demo:child", args.world, work,
            goal_parallel=args.goal_parallel, device=device,
            backend=args.backend, timeout=args.timeout)
    ok = True
    for r in runs:
        tail = "\n".join(r.log.strip().splitlines()[-3:])
        state = "timed out" if r.timed_out else f"rc={r.returncode}"
        print(f"--- rank {r.rank} ({state}) ---\n{tail}")
        ok &= r.returncode == 0 and f"[child {r.rank}] ok" in r.log
    print("MULTIHOST DEMO:", "PASS" if ok else "FAIL", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
