"""Smoke run of the PyTorch/H100 port (``omg_planner_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is skipped):

1. environment: the card's name and power limit, torch/CUDA versions, the
   TF32 flags (must be off);
2. build: compiles every CUDA kernel of the package from ``csrc/``;
3. kernels against their plain versions, on the card, at the shapes the
   main path gives them plus d = 0, cap and ragged cases, and against a
   float64 oracle; the launch layout; timings (a kernel: the median over
   5 runs of 50 back-to-back launches between one pair of CUDA events,
   with the SM clock sampled under that load);
3b. plan kernels: ``panda_fk`` against its plain version at N = 2, 30,
   544 and 1,700 (the CHOMP step's start and end, its trajectory, the
   restricted and the refresh learner sweeps; bar 1e-5) and ``sdf_query``
   at P = 4,500, 72,000 and 225,000 points of suite scene 1 (O = 10;
   4,500 and 8 x 4,500 run its spread layout, the others its loop),
   analytic and baked, B = 1 and, through the vmap rule, B = 8 (suite
   scenes 0-7 padded to one object count; the baked stack shared by 8
   rows) against its plain version and the plain version in float64 (bar:
   no farther from float64 than max(1e-4, 2 x the plain version's own
   error), collision counts differing at no more than 1e-4 of the
   points); rows of a batch bit for bit their single launches; each
   kernel's device time (50 launches in one CUDA graph, median of 5
   replays), its time through the wrapper (5 runs of 50 back-to-back
   calls), the plain version's, the wrapper's host time a call and the
   bound; a fresh process's first ``panda_fk`` and ``sdf_query`` calls
   (walls), failing if they import ``torch._dynamo``,
   ``torch.distributed.tensor`` or ``sympy``;
3c. learner kernels, the plan step's two loops: ``md_update`` (the MD
   learner's expert update) and ``joint_limit`` (the joint-limit
   projection) against their plain versions on the card, on every call
   suite scene 1's plan makes (the inputs captured as the learner and
   the CHOMP step pass them) and on seeded inputs at S = 1 and 8 rows
   (G = 100 goals; T = 30, D = 9 trajectories with one to four joints
   pushed up to 1.2 rad past the limits, ``limit_cases.seeded`` of
   :data:`JL_SEEDS`; the last row not live); bars: ``md_update`` p and
   experts_p within 1e-6, experts_costs and q within 1e-5 of their size
   (1e-12 where q underflows), ``joint_limit`` no farther from the
   float64 plain version than max(1e-6, 2 x the plain version's own
   error); rows of a batch bit for bit their single launches; each
   kernel's device time (50 launches in one CUDA graph, median of 5
   replays) beside the floor (an empty kernel at the same grid, timed the
   same way), its time through the wrapper (5 runs of 50 back-to-back
   calls), the plain version's, the wrapper's host time a call split into
   dispatch, checks, allocation and launch, and the bound from this
   data's work (the Bregman passes of each expert, the joint-limit passes
   of each row);
3d. IK kernels, the goal-set build's two loops: ``ik_prefilter`` (the
   two-stage prefilter) and ``ik_chain`` (the fused standoff chain)
   against their plain versions on the card, on every call that suite
   scenes 0-7's builds and a batched build of scenes 0-3 (a wave of 4)
   make, captured as ``ops/ik.py`` passes them (B = 624 and 2,496
   prefilter lanes, 256 and 1,024 chain lanes); bars: the prefilter's
   lanes beyond each of 1e-6 ... 1e-2 from the float64 plain version at
   most 2 x + 3 as many as the float32 plain version's (about 1% of its
   lanes are chaotic) and its flags (twist norm under
   ``ik_prefilter_tol``) the plain version's; the chain's ``ok`` equal on
   all but one lane in 256 (each difference logged with its acceptance
   ratios) and ``qs`` within 1e-4 rad on the lanes ok in both; rows alone
   bit for bit their rows of the launch; each kernel's registers, stack
   frame and spill stores from ptxas (fails on a spill, or a stack frame
   beyond libdevice's 32 bytes); each kernel's device time (50 launches
   in one CUDA graph) beside the floor, its time through the wrapper, the
   plain version's, the wrapper's host time a call and the bound from the
   lane-iterations this data runs;
3e. CHOMP kernels, the plan step after FK and the query:
   ``chomp_obstacle`` (the obstacle cost and gradient, the top-k mask)
   and ``chomp_step`` (smoothness, the total loss, the flags and the
   update) against their plain versions on the card, on every call suite
   scene 1's plan makes (captured as ``ops/chomp.py`` passes them) and on
   seeded rows at S = 1 and 8 (trajectories of suite scene 1, two pushed
   past the joint limits); bars: the kernel's k-th value and selection
   mask (read through the packer) equal to the plain version's, the
   collision counts equal, every other output (each ``CostInfo`` field
   and ``cost_traj`` on its own) no farther from the float64 plain
   version than max(1e-5 of its own size, 2 x the float32 plain version's
   own distance), the flags equal; rows of a batch bit for bit their
   single launches; each kernel's registers, stack and spill stores from
   ptxas (fails on a spill); each kernel's device time (50 launches in
   one CUDA graph) beside the floor (an empty kernel at the launch shape
   of ``ops/kernels.py``'s ``chomp_obstacle_threads`` and
   ``chomp_step_threads``), its time through the wrapper, the plain
   version's, the wrapper's host time a call split into dispatch, checks,
   allocation and launch, and the bound from this data's points, the
   non-zero entries of its matrices and its dofs;
4. reference: a small plan staged on the CPU, planned on the CPU and on
   the card — same goal, same verdict, trajectories within 2e-3;
5. the standard plan at the full ``OMGConfig()`` width on three
   ``data/suite_v2`` scenes (each must launch ``panda_fk``, ``sdf_query``,
   ``md_update``, ``joint_limit``, ``chomp_obstacle`` and ``chomp_step``
   and, once each in its goal-set build, ``ik_prefilter`` and
   ``ik_chain``, and no other kernel; the build kernels' counts go into
   the kernels line), with wall time and host syncs per staging (at most
   9) and per plan;
6. a ``torch.profiler`` trace of one standard plan: the device's busy
   share, its operations per plan and per plan step (fails if it records
   none), and the operations by the port's function that launched them
   (``record_function`` ranges this script puts around the FK, the
   collision query, the CHOMP kernels and the rest of the step, and the
   learner; fails unless ``chomp_obstacle``'s range holds one operation
   a CHOMP evaluation and ``chomp_step``'s one an eager evaluation: a
   graphed step launches it from its CUDA graph), and the plan's sort
   kernels; the device launches of each plan kernel, counted by its
   device function's name (fails unless ``chomp_obstacle`` and
   ``chomp_step`` ran once a CHOMP evaluation, graph replays included,
   and every plan kernel as often as in the same plan run eagerly, where
   each launch is a wrapper call, plus the graphed plan's eager re-run of
   its terminating step; these counts go into the kernels line); then the
   same
   scene's goal-set build, warm, its device operations by function (the
   prefilter, the chain, the rest of the IK, flip and filter, prune,
   dedupe, sampling; fails unless the prefilter's and the chain's ranges
   hold one operation each, the launch);
7. the perception-mode plan (``python -m omg_planner_torch -p -f 0``) at
   full width, which must launch ``min_dist_grid``;
8. the suite runner: ``SuiteRunner`` plans ``data/suite_v2`` scenes 0-7
   through the pipelined runner with execution validation at full width
   (verdict, steps, validation, wall and host syncs per scene); a second
   runner on the same directory finds nothing pending and plans nothing;
   fails on a missing shard, a bad trajectory or any retry;
9. the benchmark: ``bench_torch.py --scenes 8`` (analytic backend, every
   phase, the cascade included), ``--backend exact --scenes 2
   --skip-cascade`` (the grid backend on the card) and ``--backend fused
   --scenes 2 --skip-cascade`` (the fused world field) as subprocesses,
   each JSON line relayed and checked for ``bench.py``'s keys plus
   ``host_syncs_per_plan``;
10. the fused world field at full width: suite scenes 0-2 with
    ``sdf_analytic=False, sdf_fused=True`` (a 0.01 m field of 150 x 180 x
    140 cells), bake ms, verdict, steps, plan wall and host syncs per
    scene; ``world_field_query`` against the exact grid query at 10,000
    points (the scene and bars of ``tests/test_world_field.py``); the
    nearest-cell bake from the baked stack against the snapped analytic
    bake;
11. the UR-like 6-DOF URDF chain, planned at the full ``OMGConfig()`` step
    budget with ``goal_set_proj=False`` on the card and on the CPU, its
    pillar's grid read by the exact query and by the baked one
    (``sdf_query``): same verdict and steps, trajectories within 2e-3;
12. the task layer on synthetic scene 0 at full width: a grasp plan
    (``plan_to_target``), then ``place_target`` (flag, steps, achieved
    pose);
13. physics execution on suite scene 0 at full width: its plan executed
    by ``execute_plan`` (one ``rigid_rollout`` launch; ``panda_fk`` for
    its tracks; no query);
    the kernel against ``rollout_plain`` on the same inputs (same reward,
    final position within 5 mm, the settle phase within 1e-5 m); a B = 2
    launch bit for bit equal to two B = 1 launches; the pick rollout timed
    as runs of back-to-back launches with the SM clock sampled, the plain
    version timed once, one placement rollout (923 substeps) timed, and
    the profile build's cycles by phase; ``NativePanda.step(200)``; and
    ``python -m omg_planner_torch.apps.phys_exec`` (its 30 scenes) as a
    subprocess: the reward rate on the scenes the port plans at least
    0.893 (the low end of ``docs/phys_sensitivity_r05.json``), and on the
    scenes whose JAX execution is stable (``STABLE_SCENES``) the reward of
    ``docs/phys_exec_r04.json``;
14. the planning service (``apps/serve.py``) in a thread on a free port:
    ``/health``, ``/plan`` twice (fresh, then warm: ``stage_s``,
    ``plan_s`` and host syncs per request; the warm one builds no goal
    set), ``/plan_batch`` of two scenes at depth 2 and ``/execute``
    (200 with ``execution.reward``); any other status fails;
15. scale-out: a world-size-1 NCCL group on the card (``FileStore``
    under ``build/``) as a 1 x 1 (scene x goal) mesh;
    ``make_sharded_pipeline`` (goal-set build with the sharded IK, then
    the goal-sharded plan) over ``data/suite_v2`` scenes 0-3 at the full
    ``OMGConfig()`` width, each scene against the same pipeline without a
    group (the plain IK and ``plan_fast``) from the same seed: the same
    ``goal_idx``, ``flag`` and ``steps_used`` and the trajectory bit for
    bit, with wall time and host syncs per scene; the stacked four-scene
    batch in one call equal to the per-scene results; ``make_sharded_plan``
    with ``learner_active_goals=0`` on scene 0 (the per-step all-gather on
    the card) under the same bar against ``plan_fast``; then
    ``python -m omg_planner_torch.apps.multihost_demo --world 2
    --goal-parallel 2 --backend gloo`` as a subprocess: two gloo ranks on
    the one card, which must print ``MULTIHOST DEMO: PASS``;
16. viz and apps, on the card, writing into a temporary directory: whether
    matplotlib and cv2 are importable here; the CLI with ``-f 0 -vc -vg
    --fast`` at full width (the frames written, one every second
    waypoint, and the file), the collision probe's ms per frame, and the
    probe on the card against the CPU over the same trajectory (points
    within 1e-5 m, potentials and gradients within 1e-4); without
    matplotlib the probe runs over the planned trajectory alone and no
    frame is drawn; ``apps.gen_demos.generate(2, ..., observations=True)``
    (kept demos: a finite [T, 9] trajectory, simulated reward 1, lifted
    above 0.05 m; at least one ``rigid_rollout`` launch);
    ``apps.kitchen.run_script`` on the default script with
    ``execute=True`` (two launches: the pick and the place);
    ``apps.phys_exec --scenes 1 --video`` (one launch, the replay's frames
    counted; without matplotlib the execution alone); the inspector on an
    ephemeral port (``/state``, ``/plan`` pick then place,
    ``/render.png``), with each request's wall;
17. scene batches at the full ``OMGConfig()`` width on ``data/suite_v2``
    scenes 0-7 (scene 2 ends at step 2 while scene 4 runs all 70): each
    scene's own goal-set build, then waves of 4 in one batched build each
    (``prebuild_goal_sets``), with walls and host syncs per scene and per
    wave and the goal sets equal (masks, grasps within 1e-5);
    ``plan_pipelined(build_batch=4)`` against ``build_batch=0``: the same
    goal-set masks, grasps within 1e-5, goal, verdict and steps per scene;
    ``plan_batch_vmap`` over the 8 staged problems against 8 ``plan_fast``
    calls, at 50+20 and at 10+1 steps: the same goal, verdict and steps,
    the trajectory within 1e-5 (or, on a scene whose own ``plan_fast``
    moves by ``own`` when its start moves by +-1e-7 rad, the goal, verdict
    and steps of ``plan_fast`` or a nudged plan and within min(1e-2, 10 x
    ``own``) of it), a reversed batch giving the same rows, walls and host
    syncs a step, and device operations a step from ``torch.profiler``
    against ``plan_fast`` on scene 1.

Phases 5, 7, 8 and each phase from 10 on run with the launch counts set
to 0 and check them after: ``panda_fk``, ``sdf_query``, ``md_update``,
``joint_limit``, ``chomp_obstacle``, ``chomp_step``, ``ik_prefilter``
and ``ik_chain`` must launch on every phase that builds a Panda goal set
from the grasp database and plans (the chain phase, which plans without
a goal set and so without the learner: ``sdf_query``, ``joint_limit``,
``chomp_obstacle`` and ``chomp_step``; the physics phase, which plans before
its counts start: ``rigid_rollout`` and ``panda_fk``), ``rigid_rollout``
on the physics, service and viz and apps phases, ``min_dist_grid`` in
phase 7, and no kernel elsewhere.
The line before the last is a JSON object listing every kernel with its
launches on its path (phase 7 for ``min_dist_grid``, 13 for
``rigid_rollout``, 5 for the IK kernels, and for the plan, loop and CHOMP
kernels phase 6's device launches in one plan), error,
times and
bound; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from omg_planner_torch import interop
from omg_planner_torch.__main__ import main as cli_main
from omg_planner_torch.__main__ import observe_obstacles, perception_plan
from omg_planner_torch.apps import (gen_demos, inspector, kitchen, phys_exec,
                                    serve)
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.io.assets import pose_at
from omg_planner_torch.models import api as model_api
from omg_planner_torch.models import chain
from omg_planner_torch.models import panda as panda_mod
from omg_planner_torch.ops import chomp as chomp_mod
from omg_planner_torch.ops import ik as ik_mod
from omg_planner_torch.ops import kernels
from omg_planner_torch.ops import learner as learner_mod
from omg_planner_torch.ops import sdf as sdf_mod
from omg_planner_torch.ops.chomp import CostParams, GoalSet
from omg_planner_torch.ops.pointsdf import grid_cells, grid_layout
from omg_planner_torch.parallel import batch as batch_mod
from omg_planner_torch.parallel import multihost
from omg_planner_torch.physics import executor, rigid
from omg_planner_torch.physics.panda_ctrl import HOME_POSE, NativePanda
from omg_planner_torch.planner import goal_set as goal_set_mod
from omg_planner_torch.planner import plan as plan_mod
from omg_planner_torch.planner import tasks
from omg_planner_torch.planner.runner import (SuiteRunner, plan_pipelined,
                                              prebuild_goal_sets)
from omg_planner_torch.planner.scene import PlanningScene
from omg_planner_torch.utils import limit_cases
from omg_planner_torch.utils.graphs import GRAPHS
from omg_planner_torch.utils.sync import SYNCS
from omg_planner_torch.utils.timing import RETRIES
from omg_planner_torch.viz.render import collision_probe

ROOT = os.path.dirname(os.path.abspath(__file__))
SUITE = os.path.join(ROOT, "data", "suite_v2")
# bench.py's JSON keys (tests/test_bench.py) plus the port's sync count
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "backend",
              "end_to_end_plans_per_s", "p50_plan_latency_ms",
              "warm_goal_set_build_s", "success_rate", "mean_steps",
              "cascade_success_rate", "cascade_e2e_plans_per_s",
              "host_syncs_per_plan")
# H100 SXM published peaks (NVIDIA data sheet; at the 700 W limit)
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
# flop-equivalents per (cell, point) pair of min_dist_grid: four fp32
# issue slots (3 FFMA + 1 FMNMX) at the FFMA rate of 2 flops a slot
MIN_DIST_FLOPS_PER_PAIR = 8
# the observed cloud's point cap (``__main__.observe_obstacles``)
CAP_POINTS = 3072
# flops that one substep of rigid_rollout cannot avoid, by item (fp32,
# counted from rigid.py's formulas): each robot sphere and each pad sample
# is moved into the body frame and queried (SDF + gradient + normal), each
# body surface sample against every static; each active lane's set-up
# (tangent basis, three effective masses, C alignment dots), each Jacobi
# iteration per active lane and per body (patch brakes, 3 x 3 products),
# each pseudo iteration per active lane and per body
ROLLOUT_FLOPS = dict(robot=100, pad=130, world_static=60, lane_setup=120,
                     lane_align=7, lane_iter=70, body_iter=150,
                     lane_pseudo=35, body_pseudo=25)
# apps/phys_exec.py's 30-scene set: the scenes whose JAX execution keeps
# its reward and lifted height (within 1e-3 m) when the plan moves by
# N(0, 1e-6) (tests/test_torch_exec_stable.py's probe); only these are held
# per scene against docs/phys_exec_r04.json
STABLE_SCENES = (0, 1, 3, 6, 7, 8, 9, 10, 11, 12, 13, 15, 16, 17, 18, 20, 22,
                 24, 26, 27, 28, 29)
# the low end of the JAX package's reward-rate band on that set
# (docs/phys_sensitivity_r05.json)
PHYS_EXEC_RATE_BAR = 0.893
SMALL_CFG = OMGConfig(optim_steps=10, extra_smooth_steps=3,
                      goal_set_max_num=12, ik_seed_num=4, ik_max_iters=30,
                      learner_interp_steps=10, silent=True)


def log(msg):
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event timings after warm-up (for calls of
    milliseconds; a kernel's time comes from :func:`time_launches`)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def time_launches(fn, launches: int = 50, runs: int = 5,
                  warmup: int = 3) -> float:
    """A kernel's time: the median over ``runs`` of elapsed / ``launches``
    for ``launches`` back-to-back calls between one pair of CUDA events,
    after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def time_graph(fn, launches: int = 50, runs: int = 5,
               warmup: int = 3) -> float:
    """A short kernel's device time: ``launches`` back-to-back calls of
    ``fn`` captured in one CUDA graph, the median over ``runs`` replays of
    elapsed / ``launches`` between one pair of CUDA events.  The replay
    leaves out the host, whose wrapper time a call exceeds the kernel's
    own at the plan's shapes (:func:`time_launches` then measures the
    host)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    return float(np.median(times))


def clocks_under_load(fn, calls: int = 50) -> str:
    """``clocks.sm, power.draw, power.limit`` from nvidia-smi, sampled while
    runs of ``calls`` calls of ``fn`` keep the card busy."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    while proc.poll() is None:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError("nvidia-smi failed")
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def _eager_plans():
    """``plan_fast`` without CUDA graphs: every kernel call of a plan goes
    through its wrapper, where a recorder sees it."""
    orig = plan_mod.plan_fast
    plan_mod.plan_fast = functools.partial(orig, _graphs=False)
    try:
        yield
    finally:
        plan_mod.plan_fast = orig


def reset_counts():
    for fn in kernels.KERNELS.values():
        fn.launches = 0
    SYNCS.count = 0
    GRAPHS.reset()


def _chomp_runs(res) -> tuple:
    """(CHOMP evaluations a plan ran, those of them from a CUDA graph, the
    eager re-runs of a graphed terminating step), from ``GRAPHS`` since
    :func:`reset_counts`: one a step, the final evaluation of a plan that
    ran out of steps, and the re-run.  Of a graphed evaluation only
    ``chomp_obstacle`` and ``sdf_query`` are wrapper calls (they run
    between the graph's segments); its other kernels launch from the
    graph, so their wrappers' ``.launches`` count the capture alone."""
    g = GRAPHS.counts["chomp"]
    steps = int(res.steps_used)
    rerun = max(0, g["eager"] - min(steps, plan_mod._EAGER_STEPS))
    return (steps + (not bool(res.flag)) + rerun,
            g["capture"] + g["replay"], rerun)


def check_traj(traj, model, what):
    traj = np.asarray(traj)
    if traj.shape != (30, 9) or not np.isfinite(traj).all():
        raise AssertionError(f"{what}: bad trajectory {traj.shape}")
    lo = model.joint_lower.cpu().numpy() - 1e-4
    hi = model.joint_upper.cpu().numpy() + 1e-4
    if not ((traj >= lo) & (traj <= hi)).all():
        raise AssertionError(f"{what}: trajectory leaves the joint limits")


def phase_environment():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    log(f"allow_tf32 matmul={tf32[0]} cudnn={tf32[1]}")
    if any(tf32):
        raise AssertionError("TF32 must be off")


#: the compiler's output of each library phase 2 built ({library: text})
BUILD_LOGS = {}


def phase_build():
    t0 = time.time()
    logs = kernels.build(extra_flags=("-Xptxas", "-v"))
    BUILD_LOGS.update(logs)
    for src, out in logs.items():
        log(f"[build {src}]\n{out.strip()}")
    log(f"build: {time.time() - t0:.2f} s for {len(logs)} source(s)")


def phase_kernels(dev):
    """min_dist_grid against its plain version and a float64 oracle, its
    launch layout and timings; returns the kernel entry."""
    full = PlanningScene.synthetic(OMGConfig(silent=True), scene_id=0,
                                   n_obstacles=2, device=dev)
    pts_np, dims, lo = grid_layout(observe_obstacles(full), 0.02, 0.24)
    grid = grid_cells(dims, tuple(float(v) for v in lo), 0.02, dev)
    pts = torch.as_tensor(pts_np, device=dev)
    g_main, n_main = grid.shape[0], pts.shape[0]
    log(f"perception grid of scene 0: dims {dims}, G={g_main}, N={n_main}")
    gen = torch.Generator(device="cpu").manual_seed(0)

    def rand(n):
        return (torch.rand(n, 3, generator=gen) - 0.5).to(dev)

    def sample(n):
        return torch.randperm(g_main, generator=gen)[:n].to(dev)

    lo_t, hi_t = grid.min(0).values, grid.max(0).values
    cap = lo_t + (hi_t - lo_t) * torch.rand(CAP_POINTS, 3,
                                            generator=gen).to(dev)
    on_cells = sample(n_main)  # d = 0: points on the grid's own cells
    cases = [("main", grid, pts), ("d=0", grid, grid[on_cells]),
             (f"cap N={CAP_POINTS}", grid, cap), ("N=1", grid, pts[:1]),
             ("N=1025", rand(1000), rand(1025)),
             ("N=3072,G=4099", rand(4099), rand(3072)),
             ("G=777", rand(777), pts), ("G=5", rand(5), pts)]
    worst = 0.0
    for name, g, p in cases:
        k = kernels.min_dist_grid(g, p)
        ref = kernels.min_dist_grid_plain(g, p)
        _sync(dev)
        err = float((k - ref).abs().max())
        log(f"min_dist_grid {name}: G={g.shape[0]} N={p.shape[0]} "
            f"max|kernel-plain|={err:.3e} m")
        if not np.isfinite(err) or err > 1e-3:
            raise AssertionError(f"min_dist_grid {name}: error {err}")
        worst = max(worst, err)

    # the expansion's worst case: cells that hold a point (exact 0)
    err0 = float(kernels.min_dist_grid(grid, grid[on_cells])[on_cells].max())
    log(f"min_dist_grid d=0: max kernel distance at the points' own cells "
        f"(exact 0) = {err0:.3e} m")
    if not err0 <= 1e-3:
        raise AssertionError(f"min_dist_grid d=0 error {err0}")
    # float64 direct form on sampled cells of the main shape
    sub = sample(20000)
    k = kernels.min_dist_grid(grid, pts)[sub].double()
    g64, p64 = grid[sub].double(), pts.double()
    ref64 = torch.cat([((g[:, None, :] - p64[None]) ** 2).sum(-1).amin(1)
                       for g in torch.split(g64, 2000)]).sqrt()
    err64 = float((k - ref64).abs().max())
    log(f"min_dist_grid main, {len(sub)} sampled cells: "
        f"max|kernel-float64 direct|={err64:.3e} m")
    if not err64 <= 1e-4:
        raise AssertionError(f"min_dist_grid float64 error {err64}")

    entry = dict(name="min_dist_grid", route="cuda",
                 source="omg_planner_torch/csrc/min_dist_grid.cu",
                 replaces="omg_planner_tpu/ops/pallas_kernels.py:92",
                 launches=0, max_abs_err=worst)
    for name, p in (("main", pts), ("cap", cap)):
        n = p.shape[0]
        lay = kernels.min_dist_grid_layout(g_main, n)
        per_sm = -(-lay["units"] // lay["blocks"])
        log(f"min_dist_grid {name} layout: {lay}; cells per SM max "
            f"{min(per_sm * lay['unit_cells'], g_main)}, mean "
            f"{g_main / lay['blocks']:.2f}")

        def run(p=p):
            return kernels.min_dist_grid(grid, p)

        ms = time_launches(run)
        smi = clocks_under_load(run)
        plain_ms = time_ms(lambda: kernels.min_dist_grid_plain(grid, p), 5, 1)
        lib_ms = time_ms(lambda: torch.cdist(grid, p).amin(1), 5, 1)
        flops = MIN_DIST_FLOPS_PER_PAIR * g_main * n
        nbytes = 12 * (g_main + n) + 4 * g_main
        op_ms, byte_ms = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
        bound = max(op_ms, byte_ms)
        log(f"min_dist_grid {name} timing (G={g_main}, N={n}): kernel "
            f"{ms:.4f} ms (median of 5 runs of 50 launches), bound "
            f"{bound:.4f} ms ({flops:.3e} flop, {nbytes} B), share of bound "
            f"{bound / ms:.3f}, plain {plain_ms:.4f} ms, cdist+amin "
            f"{lib_ms:.4f} ms; under load clocks.sm, power.draw, "
            f"power.limit = {smi}")
        if name == "main":
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                         bound_by="operations" if op_ms >= byte_ms
                         else "bytes",
                         library_ms=lib_ms, share_of_bound=bound / ms,
                         sm_clock_mhz=float(smi.split()[0]))
    return entry


def _fk_flops(n: int, p: int) -> int:
    """Operations of ``panda_fk`` on ``n`` configurations with the mesh
    offsets and ``p`` points a link: per configuration 7 joint transforms
    b = (P cos + Q sin) + R (64 each, cos and sin one each), 6 joint
    frames and 6 chain products, the hand, the two fingers (one shift
    each) and 10 offsets as 4 x 4 products (112 each: 64 products, 48
    sums), and 10 p points (18 each)."""
    per = 7 * (64 + 2) + (6 + 6 + 1 + 2 + 10) * 112 + 2 + 10 * p * 18
    return n * per


def _fk_bytes(n: int, p: int) -> int:
    """Bytes ``panda_fk`` must move: the configurations and the model's
    tables (pqr, pose_0, center_offset, points) read once, poses, origins,
    axes and points written once."""
    return 4 * (9 * n + 7 * 48 + 2 * 160 + 30 * p
                + n * 10 * (16 + 3 + 3 + 3 * p))


# operations of sdf_query per (point, enabled object) pair, by part,
# counted from csrc/sdf_query.cu and csrc/sdf_point.cuh: the frame change
# (9 products, 9 sums); the analytic SDF and gradient of each kind (with
# the rounding, the penalty and the sign terms); the baked grid's
# coordinates (every pair) and its 7 four-channel lerps (in the volume
# only); the hinge, the rotation back and the masked sums
SDF_PAIR_FLOPS = dict(frame=18, box=42, sphere=33, cylinder=45, grid=21,
                      grid_lerps=112, hinge_reduce=37)


def _sdf_work(scene, inv_poses, points, disables):
    """(operations, bytes) that one query of scene rows ``[B, ...]``
    needs on these inputs: only enabled objects' pairs, the baked grid's
    in-volume pairs at their stencils' cost and only the grid cells those
    stencils touch (16 bytes each) read, each other input read once and
    the three outputs written once."""
    b, p = points.shape[:2]
    keep = disables <= 0                                        # [B, O]
    baked = isinstance(scene, sdf_mod.BakedSceneSDF)
    ops = SDF_PAIR_FLOPS["frame"] + SDF_PAIR_FLOPS["hinge_reduce"]
    nbytes = 4 * b * p * (3 + 1 + 3 + 1) + 4 * keep.numel() * (16 + 4)
    if not baked:
        per_obj = torch.tensor([SDF_PAIR_FLOPS[k] for k in
                                ("box", "sphere", "cylinder")],
                               device=points.device)[scene.kinds.long()]
        flops = float(((ops + per_obj) * keep).sum()) * p
        return flops, nbytes + 4 * keep.numel() * 6
    flops = float(keep.sum()) * p * (ops + SDF_PAIR_FLOPS["grid"])
    cells = []
    for r in range(b):
        for o in torch.nonzero(keep[r]).flatten().tolist():
            inv = inv_poses[r, o]
            pts_obj = points[r] @ inv[:3, :3].T + inv[:3, 3]
            lim = scene.limits[r, o]
            d = lim[6:9].to(torch.int64)
            pg = (pts_obj - lim[0:3]) / (lim[3:6] - lim[0:3]) * lim[6:9]
            c0 = torch.trunc(pg - 0.5).to(torch.int64)
            inb = ((c0 >= 0) & (c0 + 1 < d)).all(-1)
            c0 = c0[inb]
            flops += float(inb.sum()) * SDF_PAIR_FLOPS["grid_lerps"]
            corners = [((c0[:, 0] + dx) * d[1] + c0[:, 1] + dy) * d[2]
                       + c0[:, 2] + dz for dx in (0, 1) for dy in (0, 1)
                       for dz in (0, 1)]
            flat = torch.unique(torch.cat(corners)) + o * (1 << 40)
            if scene.data4.stride(0):
                flat = flat + r * (1 << 48)
            cells.append(flat)
    n_cells = torch.unique(torch.cat(cells)).numel() if cells else 0
    return flops, nbytes + 40 * keep.numel() + 16 * n_cells


def _bound(flops, nbytes):
    op_ms, byte_ms = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return max(op_ms, byte_ms), "operations" if op_ms >= byte_ms else "bytes"


def _host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of ``fn`` takes to enqueue its work (the
    wrapper's own cost: checks, dispatch, the ctypes call)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return host


def _err(a, b) -> float:
    return max((float((x - y).abs().max()) if x.numel() else 0.0)
               for x, y in zip(a, b))


def _f64(t):
    return t.double() if t.is_floating_point() else t


def _query_vs_plain(sc, inv, x, rest, what):
    """``sdf_query`` against its plain version on the same inputs, and
    both against the plain version in float64.  Bars: potentials and
    gradients no farther from the float64 version than max(1e-4, 2 x the
    plain version's own float32 error), that is as accurate as the plain
    version; collision counts differing at no more than 1e-4 of the
    points.  (The two sum the frame change in different orders, and the
    baked query's gradients reach ~10 (penalised channels times the
    hinge's slope) and jump where a point's trilinear stencil leaves its
    object's volume, (1, 0) outside, so a ulp's move of the object-frame
    point moves them by more than 1e-4 at some points; a count flips where
    a point sits within rounding of a clearance surface.)  Returns (the
    kernel's outputs, |kernel - plain|, the collide disagreement)."""
    k = kernels.sdf_query(sc, inv, x, *rest)
    ref = kernels.sdf_query_plain(sc, inv, x, *rest)
    ref64 = kernels.sdf_query_plain(type(sc)(*map(_f64, sc)), _f64(inv),
                                    _f64(x), *map(_f64, rest))
    _sync(x.device)
    err = _err(k[:2], ref[:2])
    own, mine = _err(ref[:2], ref64[:2]), _err(k[:2], ref64[:2])
    far = float(torch.maximum((k[0] - ref[0]).abs(), (k[1] - ref[1]).abs()
                              .amax(-1)).gt(1e-4).float().mean())
    col = float((k[2] != ref[2]).float().mean())
    log(f"sdf_query {what}: max|kernel-plain| pot/grad {err:.3e} (beyond "
        f"1e-4 at {far:.2e} of the points), max|kernel-float64| {mine:.3e}"
        f", max|plain-float64| {own:.3e}; collide differs at {col:.2e} of "
        f"the points; {int((k[0] > 0).sum())} points with a potential")
    if not (mine <= max(1e-4, 2 * own) and col <= 1e-4):
        raise AssertionError(f"sdf_query {what}: error {mine} against "
                             f"float64 (plain's {own}), collide {col}")
    return k, err, col


#: modules a ``torch.library.custom_op`` imports on its first call (seconds
#: of every fresh process); the plan kernels' operators must import none
HEAVY_MODULES = ("torch._dynamo", "torch.distributed.tensor", "sympy")
# a fresh process's first panda_fk and sdf_query calls on the card (the
# libraries built beforehand, untimed), then a second call of each; and,
# where the package has them, the first chomp_obstacle and chomp_step
# calls (one wall for the two)
COLD_PROBE = """
import json, sys, time
import torch
from omg_planner_torch.models import panda
from omg_planner_torch.ops import chomp, kernels, sdf
chomp_ops = "chomp_cost" in kernels._LIBS
kernels.build(libs=["panda_fk", "sdf_query"] + ["chomp_cost"] * chomp_ops)
model = panda.load_panda(15, "cuda")
q = ((model.joint_lower + model.joint_upper) / 2)[None].repeat(30, 1)
scene = sdf.AnalyticScene(
    kinds=torch.zeros(1, dtype=torch.int32, device="cuda"),
    halfs=torch.full((1, 3), 0.1, device="cuda"),
    penals=torch.ones(1, device="cuda"), rounds=torch.zeros(1, device="cuda"))
inv = torch.eye(4, device="cuda")[None]
rest = [torch.full((1,), v, device="cuda") for v in (0.2, 1.0, 0.0, 0.0)]
torch.cuda.synchronize()
out = {}
for call in ("first", "second"):
    t0 = time.perf_counter()
    _, og, ax, x = kernels.panda_fk(q, model.pose_0, model.chain_post,
                                    model.center_offset,
                                    model.collision_points)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    kernels.sdf_query(scene, inv, x.reshape(-1, 3), *rest)
    torch.cuda.synchronize()
    out[call] = [t1 - t0, time.perf_counter() - t1]
    if chomp_ops:
        from omg_planner_torch.config import OMGConfig, schedule_weights
        from omg_planner_torch.models import api
        cfg = OMGConfig()
        hp = cfg.horizon().on("cuda")
        z = torch.zeros(x.shape[:3], device="cuda")
        t2 = time.perf_counter()
        obs = kernels.chomp_obstacle(
            x, og, ax, x[0], x[-1], z, torch.zeros_like(x), z,
            hp.diff_matrices, api.jacobian_tables(model), hp.time_interval,
            cfg.top_k_collision, False, False, False)
        w = schedule_weights(cfg, 1)
        chomp.chomp_step(model, cfg, hp, q, q[0], q[-1], q[-5:], obs,
                         (w[0], w[1], w[3]), model.joint_lower,
                         model.joint_upper)
        torch.cuda.synchronize()
        out[call].append(time.perf_counter() - t2)
out["heavy"] = sorted(m for m in %r if m in sys.modules)
print(json.dumps(out))
""" % (HEAVY_MODULES,)


def cold_start(root: str = ROOT) -> dict:
    """:data:`COLD_PROBE` in a fresh interpreter on the checkout ``root``:
    {"first": [panda_fk s, sdf_query s, chomp_obstacle and chomp_step s
    (where the checkout has them)], "second": [...], "heavy": [the modules
    of :data:`HEAVY_MODULES` it imported]}."""
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", COLD_PROBE], cwd=root,
                         capture_output=True, text=True, env=env,
                         timeout=300)
    if out.returncode != 0:
        raise RuntimeError(f"cold-start probe failed:\n{out.stderr[-3000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _in_limits(model, n: int, gen) -> torch.Tensor:
    lo, hi = model.joint_lower.cpu(), model.joint_upper.cpu()
    return (lo + (hi - lo) * torch.rand(n, 9, generator=gen)).to(
        model.device)


def phase_plan_kernels(dev):
    """``panda_fk`` and ``sdf_query`` against their plain versions on the
    card at the plan's shapes, B-row launches against single launches,
    timings and bounds; returns their two kernel entries."""
    cfg = OMGConfig(silent=True)
    gen = torch.Generator().manual_seed(11)
    scene = PlanningScene.from_npz(cfg, os.path.join(SUITE, "scene_1.npz"),
                                   device=dev)
    model = scene.model
    fk_args = (panda_mod.pqr_table(model.pose_0, model.chain_post),
               model.pose_0, model.center_offset, model.collision_points)
    pts15 = model.collision_points.shape[1]

    # panda_fk: the CHOMP step's start and end (N = 2), its trajectory
    # (30), the restricted learner sweep (544) and the refresh (1,700)
    fk_err, fk = 0.0, {}
    for n in (2, 30, 544, 1700):
        q = _in_limits(model, n, gen)
        for offset, points in ((True, True), (False, False)):
            k = kernels.panda_fk(q, model.pose_0, model.chain_post,
                                 model.center_offset, model.collision_points,
                                 offset, points)
            ref = kernels.panda_fk_plain(q, *fk_args, offset, points)
            _sync(dev)
            err = _err(k, ref)
            fk_err = max(fk_err, err)
            log(f"panda_fk N={n} offsets={offset} points={points}: "
                f"max|kernel-plain| {err:.3e}")
            if not err <= 1e-5:
                raise AssertionError(f"panda_fk N={n}: error {err}")
        fk[n] = q
    q = fk[1700]
    rows = kernels.panda_fk(q[:544], *(model.pose_0, model.chain_post,
                                       model.center_offset,
                                       model.collision_points))
    full = kernels.panda_fk(q, model.pose_0, model.chain_post,
                            model.center_offset, model.collision_points)
    qs = q[:3 * 544].reshape(3, 544, 9)
    mapped = torch.func.vmap(lambda x: kernels.panda_fk(
        x, model.pose_0, model.chain_post, model.center_offset,
        model.collision_points))(qs)
    same = (all(torch.equal(a, b[:544]) for a, b in zip(rows, full))
            and all(torch.equal(a.reshape(b[:3 * 544].shape), b[:3 * 544])
                    for a, b in zip(mapped, full)))
    log(f"panda_fk: the first 544 rows alone and a vmap of 3 x 544 "
        f"against N=1700: {'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("panda_fk rows depend on the batch")

    # sdf_query: analytic and baked suite scene 1 (O = 10); the step's
    # points (30 x 150), the restricted sweep's (480 x 150) and the
    # refresh's (1,500 x 150); a batch of the 8 suite scenes 0-7
    params = scene.env.cost_params()
    rest = (params.epsilons, params.padding_scales, params.clearances,
            params.disables)
    scenes = {"analytic": scene.env.scene_sdf(),
              "baked": sdf_mod.stage_scene_sdfs(
                  [o.sdf for o in scene.env.objects], dev, baked=True)}
    pts = {}
    for p in (4500, 72000, 225000):
        x = kernels.panda_fk(_in_limits(model, p // 150, gen),
                             model.pose_0, model.chain_post,
                             model.center_offset, model.collision_points)[3]
        pts[p] = x.reshape(-1, 3)
    q_err = 0.0
    worst_col = 0.0
    for kind, sc in scenes.items():
        for p, x in pts.items():
            _, err, col = _query_vs_plain(sc, params.inv_poses, x, rest,
                                          f"{kind} P={p}")
            q_err, worst_col = max(q_err, err), max(worst_col, col)

    # B = 8: the suite scenes 0-7 padded to one object count (analytic),
    # suite scene 1's baked stack shared by 8 rows whose objects move
    # (baked); through the vmap rule; each row against its single launch
    batch = []
    for sid in range(8):
        env = PlanningScene.from_npz(
            cfg, os.path.join(SUITE, f"scene_{sid}.npz"), device=dev).env
        batch.append((env.scene_sdf(), env.cost_params()))
    n_obj = max(s.kinds.shape[0] for s, _ in batch)
    stacked = batch_mod._stack(
        [batch_mod.pad_scene(s, n_obj) for s, _ in batch])
    cps = batch_mod._stack([batch_mod._pad_cost_params(
        c, n_obj - c.inv_poses.shape[0]) if c.inv_poses.shape[0] < n_obj
        else c for _, c in batch])
    shift = torch.linspace(-0.03, 0.04, 8, device=dev)
    inv8 = params.inv_poses[None].repeat(8, 1, 1, 1)
    inv8[..., :3, 3] += shift[:, None, None]
    cases = {"analytic": (stacked, cps.inv_poses,
                          (cps.epsilons, cps.padding_scales, cps.clearances,
                           cps.disables)),
             "baked": (scenes["baked"], inv8,
                       tuple(t[None].expand(8, *t.shape) for t in rest))}
    x8s = {p: kernels.panda_fk(_in_limits(model, 8 * p // 150, gen),
                               model.pose_0, model.chain_post,
                               model.center_offset, model.collision_points
                               )[3].reshape(8, p, 3) for p in (4500, 72000)}
    b8 = {}
    for kind, (sc, inv, rr) in cases.items():
        for p, x8 in x8s.items():
            mapped_sc = kind == "analytic"
            if mapped_sc:
                k = torch.func.vmap(lambda s, i, x, *r: kernels.sdf_query(
                    s, i, x, *r))(sc, inv, x8, *rr)
            else:
                k = torch.func.vmap(lambda i, x, *r: kernels.sdf_query(
                    sc, i, x, *r))(inv, x8, *rr)
            same = True
            for r in range(8):
                sc_r = batch_mod._index(sc, r) if mapped_sc else sc
                one, err, col = _query_vs_plain(
                    sc_r, inv[r], x8[r], tuple(t[r] for t in rr),
                    f"{kind} B=8 P={p} row {r}")
                same &= all(torch.equal(a[r], c) for a, c in zip(k, one))
                q_err, worst_col = max(q_err, err), max(worst_col, col)
            log(f"sdf_query {kind} B=8 P={p} (vmap rule): rows against "
                "their single launches "
                f"{'bit-equal' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError(f"sdf_query {kind} B=8 P={p}: rows "
                                     "depend on the batch")
            b8[(kind, p)] = (sc, inv, x8, rr, mapped_sc)

    # timings: the kernel (median of 5 runs of 50 launches), the plain
    # version, the wrapper's host time a call, the bound
    smi = clocks_under_load(lambda: kernels.panda_fk(
        fk[1700], model.pose_0, model.chain_post, model.center_offset,
        model.collision_points))
    log(f"plan kernels under load: clocks.sm, power.draw, power.limit = "
        f"{smi}")
    timing = {}
    for n in (2, 30, 544, 1700):
        def run(q=fk[n]):
            return kernels.panda_fk(q, model.pose_0, model.chain_post,
                                    model.center_offset,
                                    model.collision_points)
        ms, wrapped = time_graph(run), time_launches(run)
        plain_ms = time_ms(lambda q=fk[n]: kernels.panda_fk_plain(
            q, *fk_args, True, True), 5, 1)
        bound, by = _bound(_fk_flops(n, pts15), _fk_bytes(n, pts15))
        host = _host_us(run)
        timing[("panda_fk", n)] = (ms, plain_ms, bound, by)
        log(f"panda_fk N={n}: kernel {ms:.4f} ms (graph of 50), through "
            f"the wrapper {wrapped:.4f} ms a call, plain {plain_ms:.4f} ms,"
            f" bound {bound:.6f} ms ({by}; {_fk_flops(n, pts15):.3e} flop, "
            f"{_fk_bytes(n, pts15)} B), share of bound {bound / ms:.4f}, "
            f"wrapper host {host:.1f} us a call")
    for kind, sc in scenes.items():
        for p in (4500, 72000, 225000):
            x = pts[p]

            def run(sc=sc, x=x):
                return kernels.sdf_query(sc, params.inv_poses, x, *rest)
            ms, wrapped = time_graph(run), time_launches(run)
            plain_ms = time_ms(lambda sc=sc, x=x: kernels.sdf_query_plain(
                sc, params.inv_poses, x, *rest), 5, 1)
            flops, nbytes = _sdf_work(
                batch_mod._stack([sc]), params.inv_poses[None], x[None],
                params.disables[None])
            bound, by = _bound(flops, nbytes)
            host = _host_us(run)
            timing[("sdf_query", kind, p)] = (ms, plain_ms, bound, by)
            log(f"sdf_query {kind} B=1 P={p}: kernel {ms:.4f} ms (graph of "
                f"50), through the wrapper {wrapped:.4f} ms a call, plain "
                f"{plain_ms:.4f} ms, bound {bound:.6f} ms ({by}; "
                f"{flops:.3e} flop, {nbytes} B), share of bound "
                f"{bound / ms:.4f}, wrapper host {host:.1f} us a call")
    for (kind, p), (sc, inv, x8, rr, mapped_sc) in b8.items():
        if mapped_sc:
            def run(sc=sc, inv=inv, x8=x8, rr=rr):
                return torch.func.vmap(lambda s, i, x, *r: kernels.sdf_query(
                    s, i, x, *r))(sc, inv, x8, *rr)
            work_sc = sc
        else:
            def run(sc=sc, inv=inv, x8=x8, rr=rr):
                return torch.func.vmap(lambda i, x, *r: kernels.sdf_query(
                    sc, i, x, *r))(inv, x8, *rr)
            work_sc = type(sc)(*(t[None].expand(8, *t.shape) for t in sc))
        ms, wrapped = time_graph(run), time_launches(run)
        flops, nbytes = _sdf_work(work_sc, inv, x8, rr[3])
        bound, by = _bound(flops, nbytes)
        log(f"sdf_query {kind} B=8 P={p} (vmap): kernel {ms:.4f} ms (graph "
            f"of 50), through the vmap {wrapped:.4f} ms a call, bound "
            f"{bound:.6f} ms ({by}; {flops:.3e} flop, {nbytes} B), share "
            f"of bound {bound / ms:.4f}, wrapper host {_host_us(run):.1f} us"
            " a call")
    sm = float(smi.split()[0])
    entries = []
    for name, src, rep, err, key in (
            ("panda_fk", "omg_planner_torch/csrc/panda_fk.cu",
             "omg_planner_tpu/models/panda.py:250", fk_err,
             ("panda_fk", 30)),
            ("sdf_query", "omg_planner_torch/csrc/sdf_query.cu",
             "omg_planner_tpu/ops/sdf.py:465", q_err,
             ("sdf_query", "analytic", 4500))):
        ms, plain_ms, bound, by = timing[key]
        entries.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=0, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            bound_by=by, library_ms=None,
                            share_of_bound=bound / ms, sm_clock_mhz=sm))
    log(f"sdf_query: collide differs at {worst_col:.2e} of the points at "
        "most")
    cold = cold_start()
    log(f"plan kernels cold start (a fresh process): first panda_fk "
        f"{cold['first'][0]:.4f} s, first sdf_query {cold['first'][1]:.4f} "
        f"s, first chomp_obstacle and chomp_step {cold['first'][2]:.4f} s, "
        f"second {cold['second'][0]:.4f}, {cold['second'][1]:.4f} and "
        f"{cold['second'][2]:.4f} s; imported {cold['heavy'] or 'none'} of "
        f"{list(HEAVY_MODULES)}")
    if cold["heavy"]:
        raise AssertionError(f"the plan kernels' first calls import "
                             f"{cold['heavy']}")
    return entries


# operations of md_update, counted from csrc/md_update.cu: per (expert,
# valid goal) the set-up (the goal count, delta, shiftx, v, the two logs,
# upper), each pass of the Bregman loop (the logsumexp's two sweeps, the
# new alpha and its squared step), the final solve (the logsumexp, the
# projection, its normalisation and the two cost terms); per valid goal
# the mixture (five products, the sums and the normalisation); per row
# eta and the q recurrence (10 exponentials, 5 steps of 5 products, sums
# and divisions)
MD_FLOPS = dict(setup=14, loop_pass=15, final=25, mix=12, row=90)
# operations of joint_limit per (t, d) element: each check of the loop (the
# violation, its square summed) and each pass besides (the argmax, the
# update; plus the length-T dot product, 2 T - 1)
JL_FLOPS = dict(check=5, pass_extra=4)


def _md_rows(g: int, s: int, gen) -> list:
    """``md_update``'s inputs for ``s`` rows of ``g`` goals from ``gen``:
    the experts' distributions on ~70% valid goals, a unit-norm cost
    vector (1e6 on the other goals, as ``finalize_cost_vector`` leaves
    them), the experts' last costs and a mixture (CPU tensors)."""
    mask = torch.rand(s, g, generator=gen) < 0.7
    mask[:, 0] = True
    mf = mask.float()
    ep = -torch.log(torch.rand(s, 5, g, generator=gen)) * mf[:, None]
    ep = ep / ep.sum(-1, keepdim=True)
    cv = torch.rand(s, g, generator=gen) * mf
    cv = torch.where(mask, cv / cv.norm(dim=-1, keepdim=True),
                     torch.full_like(cv, 1e6))
    q = -torch.log(torch.rand(s, 5, generator=gen))
    return [ep, cv, mask, 2 * torch.rand(s, 5, generator=gen),
            q / q.sum(-1, keepdim=True)]


def _md_passes(args, optim_steps: int) -> torch.Tensor:
    """The Bregman loop's passes for each (row, expert) of ``md_update``'s
    inputs ``args`` ([S, ...]; the live flag last), from one run of the
    plain version."""
    return kernels.md_update_plain(*args, optim_steps, passes=True)[4].cpu()


def _md_work(args, passes) -> tuple:
    """(operations, bytes) of one ``md_update`` call on ``args``: the
    per-goal work on each row's valid goals, the loop's at this data's
    passes; each input read once (the live flags where given) and each
    output written once."""
    ep, cv, mask = args[:3]
    s, e, g = ep.shape
    valid = mask.float().sum(-1).cpu()                           # [S]
    per_goal = (e * (MD_FLOPS["setup"] + MD_FLOPS["final"]) + MD_FLOPS["mix"])
    flops = float((valid * per_goal).sum()
                  + (valid[:, None] * passes * MD_FLOPS["loop_pass"]).sum()
                  + s * MD_FLOPS["row"])
    nbytes = s * (4 * (2 * e * g + 2 * g + 4 * e) + g
                  + (args[5] is not None))
    return flops, nbytes


def _jl_passes(xi, lo, hi, ainv, live, max_steps: int) -> list:
    """The joint-limit loop's passes for each row of ``xi [S, T, D]``
    (the plain loop traced row by row; none for a row that is not live)."""
    return [0 if live is not None and not bool(live[r]) else len(
        kernels.limit_loop_trace(xi[r], lo[r], hi[r], ainv, max_steps)[0]) - 1
        for r in range(xi.shape[0])]


def _jl_work(xi, passes, live) -> tuple:
    """(operations, bytes) of one ``joint_limit`` call on ``xi [S, T, D]``
    at ``passes`` per row: each live row's checks and passes; the
    trajectories read and written once, the limits read for the live rows,
    Ainv only where a row makes a pass, the live flags where given.  (The
    kernel starts Ainv's copy before its first check, so it reads Ainv on
    every live row; the bound counts what the function needs.)"""
    s, t, d = xi.shape
    n = t * d
    on = [True] * s if live is None else live.tolist()
    flops = float(sum(n * JL_FLOPS["check"] * (k + 1)
                      + k * (n * (2 * t - 1 + JL_FLOPS["pass_extra"]) + 3)
                      for k, row_on in zip(passes, on) if row_on))
    nbytes = (4 * (2 * s * n + 2 * sum(on) * d + t * t * (max(passes) > 0))
              + s * (live is not None))
    return flops, nbytes


def _md_vs_plain(args, what):
    """``md_update`` against its plain version on the same card inputs.
    Bars: p and experts_p within 1e-6; experts_costs and q within 1e-5 of
    their size (and 1e-12 where q underflows toward 0).  Returns (the
    kernel's outputs, max |kernel - plain| over the four)."""
    k = kernels.md_update(*args, OMG_OPTIM_STEPS)
    ref = kernels.md_update_plain(*args, OMG_OPTIM_STEPS)
    _sync(args[0].device)
    abs_err = _err(k[:2], ref[:2])
    rel = max(float(((a - b).abs() - 1e-12).clamp(min=0).div(
        b.abs().clamp(min=1e-30)).max()) for a, b in zip(k[2:], ref[2:]))
    log(f"md_update {what}: max|kernel-plain| p/experts_p {abs_err:.3e}, "
        f"experts_costs/q relative {rel:.3e}")
    if not (abs_err <= 1e-6 and rel <= 1e-5):
        raise AssertionError(f"md_update {what}: error {abs_err}, {rel}")
    return k, max(abs_err, _err(k[2:], ref[2:]))


def _jl_vs_plain(args, what):
    """``joint_limit`` against its plain version on the same card inputs,
    and both against the plain version in float64.  Bar: no farther from
    float64 than max(1e-6, 2 x the plain version's own error) (the two sum
    the length-T dot products in different orders, and the passes carry
    it).  Returns (the kernel's output, |kernel - plain|)."""
    xi, lo, hi, ainv, live = args
    k = kernels.joint_limit(*args, 10)
    ref = kernels.joint_limit_plain(*args, 10)
    ref64 = kernels.joint_limit_plain(xi.double(), lo.double(), hi.double(),
                                      ainv.double(), live, 10)
    _sync(xi.device)
    err = _err([k], [ref])
    own, mine = _err([ref.double()], [ref64]), _err([k.double()], [ref64])
    log(f"joint_limit {what}: max|kernel-plain| {err:.3e}, "
        f"max|kernel-float64| {mine:.3e}, max|plain-float64| {own:.3e}")
    if not mine <= max(1e-6, 2 * own):
        raise AssertionError(f"joint_limit {what}: error {mine} against "
                             f"float64 (plain's {own})")
    return k, err


#: ``OMGConfig().optim_steps``: the MD learner's eta at full width
OMG_OPTIM_STEPS = OMGConfig().optim_steps
#: phase 3c's pushed trajectories: ``limit_cases.seeded`` of these seeds
#: (no other check uses them), one to four joints up to 1.2 rad past a limit
JL_SEEDS, JL_MOST, JL_REACH = range(3000, 3008), 4, 0.6


def capture_loop_calls(dev) -> tuple:
    """Suite scene 1's plan at full width: (its steps, {"md": [...], "jl":
    [...]}), the arguments of every ``md_update`` and ``joint_limit``
    call it makes, captured as the learner and the CHOMP step pass them."""
    cfg = OMGConfig(silent=True)
    scene = PlanningScene.from_npz(cfg, os.path.join(SUITE, "scene_1.npz"),
                                   device=dev)
    calls = {"md": [], "jl": []}
    upd, hjl = learner_mod.update_goal_dist, chomp_mod.handle_joint_limit

    def rec_md(cfg_, state, cv, goal_set, traj_end, live=None):
        calls["md"].append([t.clone() for t in (
            state.experts_p, cv, goal_set.mask, state.experts_costs,
            state.q)] + [live])
        return upd(cfg_, state, cv, goal_set, traj_end, live)

    def rec_jl(hp, cfg_, xi, lower, upper):
        calls["jl"].append([xi.clone(), lower, upper, hp.Ainv, None])
        return hjl(hp, cfg_, xi, lower, upper)

    learner_mod.update_goal_dist, chomp_mod.handle_joint_limit = (rec_md,
                                                                  rec_jl)
    try:
        with _eager_plans():
            res = scene.step(fast=True)
    finally:
        learner_mod.update_goal_dist, chomp_mod.handle_joint_limit = upd, hjl
    _sync(dev)
    return int(res.steps_used), calls


def seeded_loop_inputs(dev, model) -> tuple:
    """Phase 3c's seeded inputs on ``dev``: (``md_update``'s 8 rows of G =
    100 from a generator seeded 13, the last not live; ``joint_limit``'s 8
    trajectories of :data:`JL_SEEDS` with the model's limits and Ainv, the
    last not live)."""
    gen = torch.Generator().manual_seed(13)
    md8 = [t.to(dev) for t in _md_rows(100, 8, gen)]
    md8.append(torch.arange(8, device=dev) < 7)
    lo, hi = model.joint_lower, model.joint_upper
    xi8 = torch.as_tensor(limit_cases.seeded(
        (lo.cpu().numpy(), hi.cpu().numpy()), JL_SEEDS, JL_MOST,
        JL_REACH)).to(dev)
    jl8 = [xi8, lo[None].expand(8, 9).contiguous(),
           hi[None].expand(8, 9).contiguous(),
           OMGConfig().horizon().on(dev).Ainv,
           torch.arange(8, device=dev) < 7]
    return md8, jl8


def _block_threads(name: str, args) -> tuple:
    """(blocks, threads a block) of one launch of ``name`` on ``args``."""
    if name == "md_update":
        return int(np.prod(args[1].shape[:-1])), 32 * kernels.MD_EXPERTS
    n = args[0].shape[-2] * args[0].shape[-1]
    return int(np.prod(args[0].shape[:-2])), min(1024, (n + 31) // 32 * 32)


def floor_ms(blocks: int, threads: int, dev: torch.device) -> float:
    """An empty kernel's time at ``blocks`` x ``threads`` on CUDA device
    ``dev`` (50 launches in one CUDA graph): what no launch of that grid
    goes below."""
    entry = kernels._entry("md_update", "omg_empty_launch")

    def empty():
        if entry(blocks, threads, kernels._raw_stream(dev)) != 0:
            raise RuntimeError("the empty launch failed")
    return time_graph(empty)


def host_split(name: str, args) -> dict:
    """The wrapper's host time a call (us, 200 calls each): the whole
    call, its input checks, its output allocation and its launch (the
    ctypes arguments and the call), and the dispatch, what is left (the
    operator's dispatch and the wrapper's own frames)."""
    dev = args[0].device
    if name == "md_update":
        ins, lead, g = kernels._md_update_inputs(*args)
        buf, _ = kernels._md_update_outputs(lead, g, dev)
        entry = kernels._entry("md_update", "omg_md_update")
        parts = dict(
            checks=lambda: kernels._md_update_inputs(*args),
            allocation=lambda: kernels._md_update_outputs(lead, g, dev),
            launch=lambda: entry(*kernels._md_update_args(
                ins, buf, lead, g, OMG_OPTIM_STEPS, 20), 1e-6,
                kernels._raw_stream(dev)))
        whole = lambda: kernels.md_update(*args, OMG_OPTIM_STEPS)  # noqa: E731
    else:
        ins, lead, t, d = kernels._joint_limit_inputs(*args)
        out = torch.empty(lead + (t, d), device=dev)
        entry = kernels._entry("joint_limit", "omg_joint_limit")
        parts = dict(
            checks=lambda: kernels._joint_limit_inputs(*args),
            allocation=lambda: torch.empty(lead + (t, d), device=dev),
            launch=lambda: entry(*kernels._joint_limit_args(
                ins, out, lead, t, d, 10), kernels._raw_stream(dev)))
        whole = lambda: kernels.joint_limit(*args, 10)  # noqa: E731
    split = {k: _host_us(fn) for k, fn in parts.items()}
    split["total"] = _host_us(whole)
    split["dispatch"] = split["total"] - sum(split[k] for k in parts)
    return split


def phase_learner_kernels(dev):
    """``md_update`` and ``joint_limit`` against their plain versions on
    the card at the plan's shapes (S = 1 and 8 rows; G = 100; T = 30, D =
    9), seeded and as suite scene 1's plan gives them, rows of a batch
    against single launches, timings, the launch floor, the wrapper's host
    time split and bounds; returns their two kernel entries."""
    steps, calls = capture_loop_calls(dev)
    log(f"learner kernels: suite scene 1's plan ({steps} steps) made "
        f"{len(calls['md'])} md_update and {len(calls['jl'])} joint_limit "
        "calls")
    if not calls["md"] or not calls["jl"]:
        raise AssertionError("suite scene 1's plan missed a loop kernel's "
                             "path")
    model = panda_mod.load_panda(15, dev)
    md8, jl8 = seeded_loop_inputs(dev, model)

    md_err = jl_err = 0.0
    # md_update: every captured call, then seeded rows at S = 1 and 8 (the
    # last row not live), and the 8 rows against single launches
    for i, args in enumerate(calls["md"]):
        md_err = max(md_err, _md_vs_plain(args, f"suite scene 1 call {i}")[1])
    md1 = [t[:1] for t in md8]
    md_err = max(md_err, _md_vs_plain(md1, "seeded S=1")[1])
    k8, err = _md_vs_plain(md8, "seeded S=8")
    md_err = max(md_err, err)
    same = True
    for r in range(8):
        one = kernels.md_update(*[t[r:r + 1] for t in md8], OMG_OPTIM_STEPS)
        same &= all(torch.equal(a[0], b[r]) for a, b in zip(one, k8))
    log(f"md_update S=8: rows against their single launches "
        f"{'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("md_update rows depend on the batch")

    # joint_limit: every captured call, seeded trajectories pushed past the
    # limits at S = 1 and 8 (the last row not live), the rows alone
    for i, args in enumerate(calls["jl"]):
        jl_err = max(jl_err, _jl_vs_plain(args, f"suite scene 1 call {i}")[1])
    xi8, lo8, hi8, ainv, live8 = jl8
    jl1 = [xi8[0], lo8[0], hi8[0], ainv, None]
    jl_err = max(jl_err, _jl_vs_plain(jl1, "seeded S=1")[1])
    k8, err = _jl_vs_plain(jl8, "seeded S=8")
    jl_err = max(jl_err, err)
    passes8 = _jl_passes(xi8, lo8, hi8, ainv, live8, 10)
    same = all(torch.equal(kernels.joint_limit(
        xi8[r:r + 1], lo8[r:r + 1], hi8[r:r + 1], ainv, live8[r:r + 1],
        10)[0], k8[r]) for r in range(8))
    log(f"joint_limit S=8 (passes {passes8}): rows against their single "
        f"launches {'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("joint_limit rows depend on the batch")

    # timings: 50 launches in one CUDA graph (median of 5 replays) beside
    # an empty kernel's at the same grid, the time through the wrapper (5
    # runs of 50 back-to-back calls), the plain version, the wrapper's
    # host time a call and its split, the bound
    main_md = calls["md"][len(calls["md"]) // 2]
    main_jl = calls["jl"][len(calls["jl"]) // 2]
    cases = {
        ("md_update", "suite scene 1 (S=1)"): main_md,
        ("md_update", "seeded S=1"): md1, ("md_update", "seeded S=8"): md8,
        ("joint_limit", "suite scene 1 (S=1)"): main_jl,
        ("joint_limit", "seeded S=1"): jl1, ("joint_limit", "seeded S=8"): jl8,
    }
    smi = clocks_under_load(lambda: kernels.md_update(*md8, OMG_OPTIM_STEPS))
    log(f"learner kernels under load: clocks.sm, power.draw, power.limit = "
        f"{smi}")
    timing = {}
    for (name, what), args in cases.items():
        if name == "md_update":
            def run(args=args):
                return kernels.md_update(*args, OMG_OPTIM_STEPS)

            def plain(args=args):
                return kernels.md_update_plain(*args, OMG_OPTIM_STEPS)
            batch = ([t[None] for t in args[:5]] + [None]
                     if args[0].ndim == 2 else list(args))
            passes = _md_passes(batch, OMG_OPTIM_STEPS)
            flops, nbytes = _md_work(batch, passes)
            detail = f"Bregman passes per expert {passes.tolist()}"
        else:
            def run(args=args):
                return kernels.joint_limit(*args, 10)

            def plain(args=args):
                return kernels.joint_limit_plain(*args, 10)
            xi = args[0] if args[0].ndim == 3 else args[0][None]
            lo = args[1] if args[1].ndim == 2 else args[1][None]
            hi = args[2] if args[2].ndim == 2 else args[2][None]
            passes = _jl_passes(xi, lo, hi, args[3], args[4], 10)
            flops, nbytes = _jl_work(xi, passes, args[4])
            detail = f"passes {passes}"
        ms = time_graph(run)
        blocks, threads = _block_threads(name, args)
        floor = floor_ms(blocks, threads, args[0].device)
        wrapped = time_launches(run)
        plain_ms = time_ms(plain, 5, 1)
        bound, by = _bound(flops, nbytes)
        split = host_split(name, args)
        timing[(name, what)] = (ms, plain_ms, bound, by, floor,
                                split["total"])
        log(f"{name} {what}: kernel {ms:.5f} ms (graph of 50), floor "
            f"{floor:.5f} ms (an empty launch of {blocks} x {threads}), "
            f"through the wrapper {wrapped:.4f} ms a call, plain "
            f"{plain_ms:.4f} ms, bound {bound:.7f} ms ({by}; {flops:.3e} "
            f"flop, {nbytes} B), share of bound {bound / ms:.5f}, wrapper "
            f"host {split['total']:.1f} us a call (dispatch "
            f"{split['dispatch']:.1f}, checks {split['checks']:.1f}, "
            f"allocation {split['allocation']:.1f}, launch "
            f"{split['launch']:.1f}); {detail}")
    sm = float(smi.split()[0])
    entries = []
    for name, src, rep, err in (
            ("md_update", "omg_planner_torch/csrc/md_update.cu",
             "omg_planner_tpu/ops/learner.py:361", md_err),
            ("joint_limit", "omg_planner_torch/csrc/joint_limit.cu",
             "omg_planner_tpu/ops/chomp.py:363", jl_err)):
        ms, plain_ms, bound, by, floor, host = timing[
            (name, "suite scene 1 (S=1)")]
        entries.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=0, max_abs_err=err,
                            ms=ms, plain_ms=plain_ms, bound_ms=bound,
                            bound_by=by, library_ms=None,
                            share_of_bound=bound / ms, floor_ms=floor,
                            host_us=host, sm_clock_mhz=sm))
    return entries


# flops of one IK lane's twist evaluation (the hand FK with the joints'
# origins and axes 1,302, the twist error 64, the Jacobian 84, its norm
# 12; each cosf, sinf and acosf counted as one), of one damped Newton step
# (J J^T + lam I 279, the Cholesky 97, the two substitutions 72, J^T sol
# 77, the update 7) and of one stage's acceptance (two norms of 3)
IK_FLOPS = dict(eval=1462, newton=532, accept=12)
# the IK kernels' layout (csrc/ik_newton.cu: one warp a lane, 4 lanes a
# block), and the floats of the tables and limits a block reads
IK_LANES, IK_THREADS = 4, 128
IK_TABLES = 7 * 48 + 8 * 16 + 14
# the IK kernels' entry functions in ptxas' report
IK_ENTRIES = {"ik_prefilter": "ik_prefilter_kernel",
              "ik_chain": "ik_chain_kernel"}
# the one stack frame the IK kernels may keep: libdevice's cosf and sinf
# hold the 7 words of their Payne-Hanek reduction (arguments of 105615
# and more, which no joint angle reaches) in a 28-byte local array that
# ptxas does not keep in registers in these kernels
IK_STACK_BYTES = 32


def _ik_plain_args(args) -> list:
    """A wrapper's arguments (the model's ``pose_0, chain_post``) as its
    plain version takes them (``pqr, pose_0``)."""
    at = 4 if len(args) == 13 else 2           # the chain has 13
    pose_0, chain_post = args[at:at + 2]
    return (list(args[:at]) + [panda_mod.pqr_table(pose_0, chain_post),
                               pose_0] + list(args[at + 2:]))


def _ik_work(args) -> tuple:
    """(flops, bytes, lane-iterations) of one IK call on its data: the
    prefilter's lanes x (iters + 1) evaluations and iters Newton steps;
    the chain's evaluations, steps and stage ends of each lane as this
    data runs them (``ik_chain_plain(..., passes=True)``), reading the
    targets of the stages an active lane reaches (at most one more than it
    ends).  The tables and limits once."""
    b = args[1].shape[0]
    if len(args) != 13:
        iters = args[7]
        flops = b * ((iters + 1) * IK_FLOPS["eval"]
                     + iters * IK_FLOPS["newton"])
        return flops, 4 * (b * (16 + 7 + 7 + 1) + IK_TABLES), b * (iters + 1)
    _, _, evals, steps = kernels.ik_chain_plain(*_ik_plain_args(args),
                                                passes=True)
    k = args[0].shape[1]
    ends = evals - steps
    ev, st, en = int(evals.sum()), int(steps.sum()), int(ends.sum())
    flops = (ev * IK_FLOPS["eval"] + st * IK_FLOPS["newton"]
             + en * IK_FLOPS["accept"])
    active = args[2]
    reached = int(torch.clamp(ends[active] + 1, max=k).sum())
    per_lane = 4 if torch.is_tensor(args[3]) else 0    # a budget tensor
    nbytes = (4 * 16 * reached + 4 * 7 * int(active.sum())
              + b * (1 + per_lane + 4 * 7 * (k - 1) + 1) + 4 * IK_TABLES)
    return flops, nbytes, ev


def _copy_as_laid_out(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` with its strides (a strided view stays one)."""
    return torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                               device=t.device).copy_(t)


def capture_ik_calls(dev) -> list:
    """[(kind, what, arguments)] of every ``ik_prefilter`` and ``ik_chain``
    call that suite scenes 0-7's goal-set builds make (each scene's own
    build) and one batched build of scenes 0-3 (a wave of 4, as
    ``plan_pipelined(build_batch=4)`` builds it), captured as
    ``ops/ik.py`` passes them: the prefilter's targets a strided view,
    the chain's budget an int where it is every lane's."""
    cfg = OMGConfig(silent=True)
    calls, at = [], ["?"]

    class Recorder:
        """``ops/ik.py``'s view of ``ops/kernels.py`` while capturing: the
        two IK wrappers record their arguments, the rest is the module."""

        def __getattr__(self, name):
            return getattr(kernels, name)

    def recorder(kind):
        def rec(*args):
            calls.append((kind, at[0], [_copy_as_laid_out(a)
                                        if torch.is_tensor(a) else a
                                        for a in args]))
            return getattr(kernels, kind)(*args)
        return rec

    view = Recorder()
    view.ik_prefilter, view.ik_chain = (recorder("ik_prefilter"),
                                        recorder("ik_chain"))
    ik_mod.kernels = view
    try:
        scenes = [(i, PlanningScene.from_npz(
            cfg, os.path.join(SUITE, f"scene_{i}.npz"), device=dev))
            for i in range(8)]
        for i, sc in scenes:
            at[0] = f"suite scene {i}"
            sc.build_problem(assume_goals=True)
        max_obj = max(len(sc.env.objects) for _, sc in scenes)
        wave = [(i, PlanningScene.from_npz(
            cfg, os.path.join(SUITE, f"scene_{i}.npz"), device=dev))
            for i in range(4)]
        at[0] = "wave of suite scenes 0-3"
        prebuild_goal_sets(wave, cfg, wave[0][1].model, 4, max_obj)
    finally:
        ik_mod.kernels = kernels
    _sync(dev)
    return calls


#: distances from the float64 plain version at which phase 3d counts the
#: prefilter's lanes
IK_DIST_STEPS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2)


def _beyond(d: torch.Tensor) -> list:
    """How many lanes stand farther than each of :data:`IK_DIST_STEPS`."""
    return [int((d > x).sum()) for x in IK_DIST_STEPS]


def _prefilter_vs_plain(args, what) -> float:
    """``ik_prefilter`` against its plain version and the plain version in
    float64 on the same inputs.  Its 12 steps from far seeds are chaotic
    on about 1% of the lanes (the redundant arm's null space, ``so3_log``
    near pi): there one ulp of a cosine moves a lane by up to 1e-1, in the
    plain version as in the kernel, so no lane-wise or largest-distance
    bar holds from one call to the next.  Bars: at each distance of
    :data:`IK_DIST_STEPS`, the kernel has at most 2 x + 3 as many lanes
    (q, and the twist norm) beyond it from float64 as the float32 plain
    version; the flags the build takes (twist norm under
    ``ik_prefilter_tol``) are the plain version's, but for a lane whose
    float64 norm sits within max(1e-6, 2 x the plain version's own
    distance on that lane) of the threshold.  Returns the largest
    |kernel - plain|."""
    q, err = kernels.ik_prefilter(*args)
    pa = _ik_plain_args(args)
    qp, ep = kernels.ik_prefilter_plain(*pa)
    q64, e64 = kernels.ik_prefilter_plain(
        *[_f64(a) if torch.is_tensor(a) else a for a in pa])
    _sync(q.device)
    ok = True
    parts = []
    for name, mine, own in (
            ("q", (q.double() - q64).abs().amax(-1),
             (qp.double() - q64).abs().amax(-1)),
            ("norm", (err.double() - e64).abs(), (ep.double() - e64).abs())):
        m_n, o_n = _beyond(mine), _beyond(own)
        ok &= all(m <= 2 * o + 3 for m, o in zip(m_n, o_n))
        parts.append(f"{name}: lanes beyond {IK_DIST_STEPS} from float64 "
                     f"kernel {m_n}, plain {o_n}; mean/max kernel "
                     f"{float(mine.mean()):.3e}/{float(mine.max()):.3e}, "
                     f"plain {float(own.mean()):.3e}/{float(own.max()):.3e}")
    tol = OMGConfig().ik_prefilter_tol
    own_e = (ep.double() - e64).abs()
    flips = torch.nonzero((err < tol) != (ep < tol)).flatten().tolist()
    for i in flips:
        margin = float(e64[i]) - tol
        near = abs(margin) <= max(1e-6, 2 * float(own_e[i]))
        ok &= near
        log(f"  ik_prefilter {what}: lane {i} flag differs: kernel "
            f"{float(err[i]):.6g}, plain {float(ep[i]):.6g}, float64 "
            f"{float(e64[i]):.6g}, margin {margin:.3g} "
            f"({'within' if near else 'BEYOND'} the plain version's own "
            "distance)")
    gap = _err([q, err], [qp, ep])
    log(f"ik_prefilter {what} (B = {args[1].shape[0]}): {'; '.join(parts)}; "
        f"{len(flips)} flags differ; max |kernel - plain| {gap:.3e}")
    if not ok:
        raise AssertionError(f"ik_prefilter {what}: beyond its bars")
    return gap


def _chain_margins(args, qs, lane) -> str:
    """A chain lane's acceptance ratios (position, rotation error over 10 x
    its tolerance; 1 is the threshold) at each recorded tail stage."""
    pa = _ik_plain_args(args)
    pos, rot = kernels.ik_acceptance(args[0][lane:lane + 1],
                                     qs[lane:lane + 1], pa[4], pa[5])
    return (f"pos {[round(float(v), 4) for v in pos[0] / (10 * args[9])]} "
            f"rot {[round(float(v), 4) for v in rot[0] / (10 * args[10])]}")


def _chain_vs_plain(args, what) -> float:
    """``ik_chain`` against its plain version on the same inputs.  Bars:
    ``ok`` equal on all but one lane in 256 (each difference logged with
    both sides' acceptance ratios), ``qs`` within 1e-4 rad on the lanes ok
    in both.  Returns that largest |qs - plain qs|."""
    qs, ok = kernels.ik_chain(*args)
    qsp, okp = kernels.ik_chain_plain(*_ik_plain_args(args))
    _sync(qs.device)
    b = ok.shape[0]
    diff = torch.nonzero(ok != okp).flatten().tolist()
    for i in diff:
        log(f"  ik_chain {what}: lane {i} ok differs: kernel {bool(ok[i])} "
            f"({_chain_margins(args, qs, i)}), plain {bool(okp[i])} "
            f"({_chain_margins(args, qsp, i)})")
    both = ok & okp
    gap = (float((qs - qsp).abs().amax((1, 2))[both].max())
           if bool(both.any()) else 0.0)
    log(f"ik_chain {what} (B = {b}, {int(args[2].sum())} active): ok "
        f"{int(ok.sum())}, plain {int(okp.sum())}, {len(diff)} differ; qs "
        f"on the lanes ok in both within {gap:.3e} of the plain version")
    if len(diff) > -(-b // 256) or gap > 1e-4:
        raise AssertionError(f"ik_chain {what}: beyond its bars")
    return gap


def _ik_rows_alone(args, what):
    """Every 8th lane of a call alone, and a ragged slice of 37 lanes,
    against their rows of the call's launch: bit for bit."""
    run = kernels.ik_chain if len(args) == 13 else kernels.ik_prefilter
    n_lane = 4 if len(args) == 13 else 2    # the lane inputs lead
    full = run(*args)
    b = args[1].shape[0]
    cuts = [slice(i, i + 1) for i in range(0, b, 8)] + [slice(3, 40)]
    for rows in cuts:
        one = run(*[a[rows] if torch.is_tensor(a) else a   # an int budget
                    for a in args[:n_lane]], *args[n_lane:])
        if not all(torch.equal(x, y[rows]) for x, y in zip(one, full)):
            raise AssertionError(f"{run.__name__} {what}: rows {rows} alone "
                                 "differ from the launch")
    log(f"{run.__name__} {what}: {len(cuts)} row sets alone bit for bit "
        "their rows of the launch")


def ptxas_report(text: str) -> dict:
    """{entry function: {"registers", "stack", "spill stores"}} from
    ``nvcc -Xptxas -v``'s output."""
    out, entry, props = {}, None, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, {})
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and props is not None:
            out.setdefault(props, {}).update(
                stack=int(m.group(1)), spill_stores=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            out[entry]["registers"] = int(m.group(1))
    return out


def ik_registers() -> dict:
    """Each IK kernel's registers, stack and spill stores from ptxas (the
    build of phase 2, or a build of ``ik_newton`` alone with ``-Xptxas
    -v``); fails if either kernel spills or keeps a stack frame beyond
    :data:`IK_STACK_BYTES`."""
    text = BUILD_LOGS.get("ik_newton") or kernels.build(
        extra_flags=("-Xptxas", "-v"), libs=["ik_newton"])["ik_newton"]
    report = ptxas_report(text)
    regs = {}
    for name, entry in IK_ENTRIES.items():
        found = [v for k, v in report.items() if entry in k]
        if len(found) != 1 or "registers" not in found[0]:
            raise AssertionError(f"ptxas reported no {entry}")
        regs[name] = found[0]
        log(f"{name} (ptxas): {found[0].get('registers')} registers, "
            f"{found[0].get('stack', 0)} bytes stack frame, "
            f"{found[0].get('spill_stores', 0)} bytes spill stores")
        if (found[0].get("stack", 0) > IK_STACK_BYTES
                or found[0].get("spill_stores", 0)):
            raise AssertionError(f"{name} spills or keeps a stack frame")
    return regs


def phase_ik_kernels(dev):
    """``ik_prefilter`` and ``ik_chain`` against their plain versions on
    the card, on every call of suite scenes 0-7's goal-set builds and of a
    wave of scenes 0-3; rows alone against the launch; registers, stack
    and spills from ptxas; timings beside the floor; returns their two
    kernel entries."""
    regs = ik_registers()
    calls = capture_ik_calls(dev)
    log(f"IK kernels: {len(calls)} calls captured "
        f"({[(k, w, tuple(a[1].shape)) for k, w, a in calls]})")
    kinds = [k for k, _, _ in calls]
    if kinds.count("ik_prefilter") != 9 or kinds.count("ik_chain") != 9:
        raise AssertionError("the builds missed an IK kernel's path")
    errs = {"ik_prefilter": 0.0, "ik_chain": 0.0}
    for kind, what, args in calls:
        check = _chain_vs_plain if kind == "ik_chain" else _prefilter_vs_plain
        errs[kind] = max(errs[kind], check(args, what))
    main = {k: a for k, w, a in calls if w == "suite scene 1"}
    wave = {k: a for k, w, a in calls if w.startswith("wave")}
    for kind in errs:
        _ik_rows_alone(main[kind], "suite scene 1")

    # timings: 50 launches in one CUDA graph (median of 5 replays) beside
    # an empty kernel's at the same grid, through the wrapper, the plain
    # version, the wrapper's host time a call, the bound from this data's
    # lane-iterations
    smi = clocks_under_load(lambda: kernels.ik_chain(*wave["ik_chain"]))
    log(f"IK kernels under load: clocks.sm, power.draw, power.limit = {smi}")
    timing = {}
    for kind in errs:
        wrapper = getattr(kernels, kind)
        plain_fn = getattr(kernels, f"{kind}_plain")
        for what, args in (("suite scene 1", main[kind]),
                           ("wave of 4", wave[kind])):
            def run(args=args):
                return wrapper(*args)

            def plain(pa=_ik_plain_args(args)):
                return plain_fn(*pa)
            ms = time_graph(run)
            blocks = -(-args[1].shape[0] // IK_LANES)
            floor = floor_ms(blocks, IK_THREADS, args[1].device)
            wrapped = time_launches(run)
            plain_ms = time_ms(plain, 3, 1)
            flops, nbytes, lane_its = _ik_work(args)
            bound, by = _bound(flops, nbytes)
            host = _host_us(run)
            timing[(kind, what)] = (ms, plain_ms, bound, by, floor, host)
            log(f"{kind} {what}: kernel {ms:.5f} ms (graph of 50), floor "
                f"{floor:.5f} ms (an empty launch of {blocks} x {IK_THREADS}), "
                f"through the wrapper {wrapped:.4f} ms a call, plain "
                f"{plain_ms:.4f} ms, bound {bound:.7f} ms ({by}; "
                f"{flops:.3e} flop, {nbytes} B, {lane_its} lane-iterations), "
                f"share of bound {bound / ms:.5f}, wrapper host {host:.1f} "
                "us a call")
    sm = float(smi.split()[0])
    entries = []
    for name, rep in (("ik_prefilter", "omg_planner_tpu/ops/ik.py:199"),
                      ("ik_chain", "omg_planner_tpu/ops/ik.py:266")):
        ms, plain_ms, bound, by, floor, host = timing[(name, "suite scene 1")]
        entries.append(dict(
            name=name, route="cuda",
            source="omg_planner_torch/csrc/ik_newton.cu", replaces=rep,
            launches=0, max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
            share_of_bound=bound / ms, floor_ms=floor, host_us=host,
            sm_clock_mhz=sm, registers=regs[name]["registers"]))
    return entries


# flops of chomp_obstacle, counted from csrc/chomp_cost.cu: a point's
# velocity and acceleration (3 coordinates x 2 flops per non-zero entry of
# the two difference matrices' row of its timestep), its direction and cost
# (the norm, v^, the two projections, the division: 40), one Jacobian
# column and its dot with the direction per dof (16), the selection's key
# and compare per radix pass (4 passes x 4), the finger softening (8);
# under the quirks each (t, link)'s gradient point formed again
CHOMP_FLOPS = dict(band=6, point=40, dof=16, select=16, soften=8)
CHOMP_ENTRIES = {"chomp_obstacle": "chomp_obstacle_kernel",
                 "chomp_step": "chomp_step_kernel"}


def _nonzero(m) -> int:
    return 0 if m is None else int(torch.count_nonzero(m))


def _chomp_obstacle_work(args) -> tuple:
    """(flops, bytes) of one ``chomp_obstacle`` call on ``args`` (its
    operator's arguments): each input read once (of the two difference
    matrices only the non-zero entries of the T rows that the derivative
    keeps, of the joint frames only the D dof joints'), each output
    written once."""
    x, pot, dmats, tables = args[0], args[5], args[8], args[9]
    k, soften, quirks = args[11], args[13], args[14]
    t, n_links, p = pot.shape[-3:]
    rows = pot.numel() // (t * n_links * p)
    d = (tables.shape[0] - n_links) // (n_links + 2)
    nz = _nonzero(dmats[:2, :t])
    n = t * n_links * p
    per_row = (CHOMP_FLOPS["band"] * nz * n_links * p
               + n * (CHOMP_FLOPS["point"] + CHOMP_FLOPS["dof"] * d)
               + (CHOMP_FLOPS["select"] * n if 0 < k < n else 0)
               + (CHOMP_FLOPS["soften"] * n if soften else 0))
    if quirks and k:
        per_row += (CHOMP_FLOPS["band"] * nz * n_links + t * n_links * (
            CHOMP_FLOPS["point"] + CHOMP_FLOPS["dof"] * d))
    nbytes = 4 * (rows * (n * 3 + 2 * t * d * 3 + 2 * n_links * p * 3 + n
                          + n * 3 + n + t * n_links + t * d + 1)
                  + nz + tables.numel())
    return rows * per_row, nbytes


def _chomp_step_work(args) -> tuple:
    """(flops, bytes) of one ``chomp_step`` call on ``args``: d1 xi, A xi,
    P grad and M b (2 flops a non-zero matrix entry and dof), the
    weighting, norms and update (12 an element); each input read once (of
    d1, A, P and M only their non-zero entries), each output written
    once."""
    xi, obs_cost, d1, a, pmat, mmat = (args[0], args[4], args[12], args[13],
                                       args[14], args[15])
    t, d = xi.shape[-2:]
    rows = xi.numel() // (t * d)
    k = 0 if mmat is None else mmat.shape[1]
    nz = _nonzero(d1) + _nonzero(a) + _nonzero(pmat) + _nonzero(mmat)
    per_row = 2 * nz * d + k * d + 12 * t * d + 4 * t
    row_vals = (3 * t * d + 2 * d + (k or 1) * d + obs_cost.shape[-1] * t
                + 1 + 3 + 2 * d + 10 + t)
    nbytes = 4 * (rows * row_vals + nz + 2 * d) + rows * 4
    return rows * per_row, nbytes


def chomp_registers() -> dict:
    """Each CHOMP kernel's registers, stack and spill stores from ptxas
    (phase 2's build, or a build of ``chomp_cost`` alone with
    ``-Xptxas -v``); fails if either kernel spills."""
    text = BUILD_LOGS.get("chomp_cost") or kernels.build(
        extra_flags=("-Xptxas", "-v"), libs=["chomp_cost"])["chomp_cost"]
    report = ptxas_report(text)
    regs = {}
    for name, entry in CHOMP_ENTRIES.items():
        found = [v for k, v in report.items() if entry in k]
        if len(found) != 1 or "registers" not in found[0]:
            raise AssertionError(f"ptxas reported no {entry}")
        regs[name] = found[0]
        log(f"{name} (ptxas): {found[0].get('registers')} registers, "
            f"{found[0].get('stack', 0)} bytes stack frame, "
            f"{found[0].get('spill_stores', 0)} bytes spill stores")
        if found[0].get("spill_stores", 0):
            raise AssertionError(f"{name} spills")
    return regs


def chomp_block(name: str, args) -> tuple:
    """(blocks, threads a block) of one launch of CHOMP kernel ``name`` on
    its operator's arguments, from the packer's own launch-shape
    helpers."""
    if name == "chomp_obstacle":
        t, n_links, p = args[5].shape[-3:]
        return (args[5].numel() // (t * n_links * p),
                kernels.chomp_obstacle_threads(t, n_links, p))
    t, d = args[0].shape[-2:]
    return args[0].numel() // (t * d), kernels.chomp_step_threads(t, d)


def chomp_host_split(name: str, args) -> dict:
    """The CHOMP wrapper's host time a call (us, 200 calls each), split as
    :func:`host_split` splits the loop kernels': the whole call, the
    packer's input checks (its time less the allocation), its output
    allocation (one ``torch.empty`` of the packed outputs), the launch (the
    C entry point's call on packed arguments) and the dispatch, what is
    left (the operator's dispatch and the wrapper's own frames)."""
    dev = args[0].device
    pack = getattr(kernels, f"_{name}_pack")
    entry = kernels._entry("chomp_cost", f"omg_{name}")
    keep, outs, ptrs, dims, consts = pack(*args)
    size = sum(o.numel() for o in outs)
    split = dict(
        pack=_host_us(lambda: pack(*args)),
        allocation=_host_us(lambda: torch.empty(size, device=dev)),
        launch=_host_us(lambda: entry(ptrs, dims, consts,
                                      kernels._raw_stream(dev))),
        total=_host_us(lambda: getattr(kernels, name)(*args)))
    del keep
    split["checks"] = split["pack"] - split["allocation"]
    split["dispatch"] = split["total"] - split["pack"] - split["launch"]
    return split


def capture_chomp_calls(dev) -> tuple:
    """Suite scene 1's plan at full width: (its steps, {"obs": [...],
    "step": [...]}), the arguments of every ``chomp_obstacle`` and
    ``chomp_step`` call it makes, captured as ``ops/chomp.py`` passes
    them."""
    cfg = OMGConfig(silent=True)
    scene = PlanningScene.from_npz(cfg, os.path.join(SUITE, "scene_1.npz"),
                                   device=dev)
    calls = {"obs": [], "step": []}
    # the operators the wrappers call (their arguments are the wrappers')
    obs, step = kernels._chomp_obstacle_op, kernels._chomp_step_op

    def keep(args):
        return [a.clone() if torch.is_tensor(a) else a for a in args]

    def rec_obs(*args):
        calls["obs"].append(keep(args))
        return obs(*args)

    def rec_step(*args):
        calls["step"].append(keep(args))
        return step(*args)

    kernels._chomp_obstacle_op, kernels._chomp_step_op = rec_obs, rec_step
    try:
        with _eager_plans():
            res = scene.step(fast=True)
    finally:
        kernels._chomp_obstacle_op, kernels._chomp_step_op = obs, step
    _sync(dev)
    return int(res.steps_used), calls


def seeded_chomp_inputs(dev, calls) -> tuple:
    """Phase 3e's seeded rows on ``dev``: 8 trajectories of suite scene 1
    (its start-to-end line plus noise from a generator seeded 17; the
    last two pushed past the joint limits), their FK and query as the
    plan's calls pass them (``chomp_obstacle``'s operator arguments,
    stacked), and ``chomp_step``'s arguments on the kernel's obstacle
    terms with seeded goals and tails, the weights a row each."""
    cfg = OMGConfig(silent=True)
    scene = PlanningScene.from_npz(cfg, os.path.join(SUITE, "scene_1.npz"),
                                   device=dev)
    model, env = scene.model, scene.env
    gen = torch.Generator().manual_seed(17)
    start = torch.as_tensor(np.asarray(scene.start, np.float32))
    end = torch.as_tensor(np.asarray(scene.end, np.float32))
    line = start + torch.linspace(0, 1, 30)[:, None] * (end - start)
    xi8 = line[None] + 0.1 * torch.randn(8, 30, 9, generator=gen)
    xi8[:, :, 7:] = 0.04
    lo, hi = model.joint_lower.cpu(), model.joint_upper.cpu()
    xi8 = torch.minimum(torch.maximum(xi8, lo + 0.01), hi - 0.01)
    xi8[6, 4, 1], xi8[7, 9, 2] = hi[1] + 0.2, lo[2] - 0.2
    xi8[7, 3, 1] = hi[1] + 0.1
    xi8 = xi8.to(dev)
    rows = []
    for xi in xi8:
        x, og, ax, pot, grad, col = chomp_mod._fk_query(
            model, env.scene_sdf(), env.cost_params(), xi, None)
        xs, xe = model_api.end_points(model, start.to(dev), end.to(dev))
        rows.append((x, og, ax, xs, xe, pot, grad, col))
    obs8 = [torch.stack(a) for a in zip(*rows)] + list(calls["obs"][0][8:])
    o = kernels.chomp_obstacle(*obs8)
    tmpl = calls["step"][0]
    goal = end.to(dev)[None].repeat(8, 1) + 0.01 * torch.randn(
        8, 9, generator=gen).to(dev)
    k = tmpl[3].shape[0]
    tail = goal[:, None].repeat(1, k, 1) + 0.01 * torch.randn(
        8, k, 9, generator=gen).to(dev)
    w = torch.linspace(0.5, 2.0, 8, device=dev)
    step8 = ([xi8, start.to(dev)[None].repeat(8, 1), goal, tail, *o]
             + [float(v) * w for v in tmpl[7:10]]
             + [model.joint_lower[None].repeat(8, 1),
                model.joint_upper[None].repeat(8, 1)] + list(tmpl[12:]))
    return obs8, step8


def _rows_of(args, r: int, n_rows: int, lead: int):
    """Row ``r`` of a call's stacked row arguments (the first ``n_rows``),
    kept as one row (``lead`` leading dims)."""
    return [a[r:r + 1] if i < n_rows and torch.is_tensor(a) and a.ndim
            and a.shape[0] == lead else a for i, a in enumerate(args)]


def _same_bits(a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _f64_args(args):
    return [_f64(a) if torch.is_tensor(a) else a for a in args]


OBSTACLE_OUTPUTS = ("obs_cost", "obs_grad", "collide")
STEP_OUTPUTS = ("xi",) + kernels.INFO_SCALARS + ("cost_traj",)


def _step_outputs(out) -> list:
    """``chomp_step``'s trajectory and its packed floats split into their
    fields (:data:`STEP_OUTPUTS`)."""
    n = len(kernels.INFO_SCALARS)
    return [out[0], *out[1][..., :n].unbind(-1), out[1][..., n:]]


def _near_f64(got, f32, f64, names, what) -> float:
    """Bar of phase 3e: each output (one of ``names``) no farther from the
    float64 plain version than max(1e-5 of its own size, 2 x the float32
    plain version's own distance), NaN where float64 is; a collision count
    equal to the float32 plain version's.  Returns max|kernel - plain|."""
    worst = 0.0
    for name, g, p, q in zip(names, got, f32, f64):
        if name == "collide":
            if not torch.equal(g, p):
                raise AssertionError(f"{what} collide: {g.tolist()} against "
                                     f"{p.tolist()}")
            continue
        g, p, q = g.double(), p.double(), q.double()
        nan = torch.isnan(q)
        if not torch.equal(torch.isnan(g), nan):
            raise AssertionError(f"{what} {name}: NaN where float64 has "
                                 "none, or the reverse")
        g, p, q = g[~nan], p[~nan], q[~nan]
        if not q.numel():
            continue
        mine = float((g - q).abs().max())
        own = float((p - q).abs().max())
        size = float(q.abs().max())
        worst = max(worst, float((g - p).abs().max()))
        if not mine <= max(1e-5 * size, 2 * own):
            raise AssertionError(f"{what} {name}: {mine:.3e} from float64 "
                                 f"(plain {own:.3e}, size {size:.3e})")
    return worst


def _obstacle_vs_plain(args, what) -> float:
    """``chomp_obstacle`` against its plain version: the kernel's k-th
    value and mask (read through the packer, an uncounted launch) equal to
    the plain version's, its outputs near float64 (:func:`_near_f64`),
    the wrapper's launch bit for bit that launch.  Returns max|kernel -
    plain|."""
    dev = args[5].device
    keep, outs, ptrs, dims, consts = kernels._chomp_obstacle_pack(
        *args, selection=True)
    status = kernels._entry("chomp_cost", "omg_chomp_obstacle")(
        ptrs, dims, consts, kernels._raw_stream(dev))
    if status != 0:
        raise RuntimeError(f"chomp_obstacle launch failed: {status}")
    wrapped = kernels.chomp_obstacle(*args)
    plain = kernels.chomp_obstacle_plain(*args)
    err = _near_f64(outs[:3], plain,
                    kernels.chomp_obstacle_plain(*_f64_args(args)),
                    OBSTACLE_OUTPUTS, f"chomp_obstacle {what}")
    if not all(_same_bits(a, b) for a, b in zip(wrapped, outs[:3])):
        raise AssertionError(f"chomp_obstacle {what}: the wrapper's launch "
                             "differs from the packer's")
    pot, lead = args[5], args[5].shape[:-3]
    dmats, tables, dt, k, finger, soften = args[8:14]
    flat = [a.reshape((-1,) + a.shape[len(lead):]) for a in args[:8]]
    kth_k, sel_k = outs[3].reshape(-1), outs[4].reshape(flat[5].shape)
    n_sel = 0
    for r in range(flat[0].shape[0]):
        soft = kernels.obstacle_point_terms(*(a[r] for a in flat), dmats,
                                            tables, dt, soften)[3]
        kth, sel = kernels.obstacle_selection(soft, tables, k, finger)
        same_k = (bool(torch.isnan(kth_k[r])) if kth is None
                  or bool(torch.isnan(kth)) else bool(kth_k[r] == kth))
        if not same_k or not torch.equal(sel_k[r], sel):
            raise AssertionError(f"chomp_obstacle {what} row {r}: k-th "
                                 f"{float(kth_k[r])} against "
                                 f"{None if kth is None else float(kth)}, "
                                 "or the mask differs")
        n_sel += int(sel.sum())
    del keep
    log(f"chomp_obstacle {what}: k-th value and mask equal ({n_sel} points "
        f"selected), max|kernel-plain| {err:.3e}")
    return err


def _step_vs_plain(args, what) -> float:
    """``chomp_step`` against its plain version: trajectory and each
    packed field near float64 (:func:`_near_f64`), flags equal.  Returns
    max|kernel - plain|."""
    got = kernels.chomp_step(*args)
    plain = kernels.chomp_step_plain(*args)
    err = _near_f64(_step_outputs(got), _step_outputs(plain),
                    _step_outputs(kernels.chomp_step_plain(*_f64_args(args))),
                    STEP_OUTPUTS, f"chomp_step {what}")
    if not torch.equal(got[2], plain[2]):
        raise AssertionError(f"chomp_step {what}: flags {got[2].tolist()} "
                             f"against {plain[2].tolist()}")
    log(f"chomp_step {what}: flags equal {got[2].reshape(-1, 4).tolist()}, "
        f"max|kernel-plain| {err:.3e}")
    return err


def phase_chomp_kernels(dev):
    """``chomp_obstacle`` and ``chomp_step`` against their plain versions
    on the card, on every call of suite scene 1's plan and on seeded rows
    at S = 1 and 8; rows of a batch against single launches; registers,
    stack and spills from ptxas; timings beside the floor; returns their
    two kernel entries."""
    regs = chomp_registers()
    steps, calls = capture_chomp_calls(dev)
    log(f"CHOMP kernels: suite scene 1's plan ({steps} steps) made "
        f"{len(calls['obs'])} chomp_obstacle and {len(calls['step'])} "
        "chomp_step calls")
    if not calls["obs"] or len(calls["obs"]) != len(calls["step"]):
        raise AssertionError("suite scene 1's plan missed a CHOMP kernel")
    errs = {"chomp_obstacle": 0.0, "chomp_step": 0.0}
    for i, args in enumerate(calls["obs"]):
        errs["chomp_obstacle"] = max(errs["chomp_obstacle"], _obstacle_vs_plain(
            args, f"suite scene 1 call {i}"))
    for i, args in enumerate(calls["step"]):
        errs["chomp_step"] = max(errs["chomp_step"], _step_vs_plain(
            args, f"suite scene 1 call {i}"))
    obs8, step8 = seeded_chomp_inputs(dev, calls)
    obs1, step1 = _rows_of(obs8, 0, 8, 8), _rows_of(step8, 0, 12, 8)
    for what, o, st in (("seeded S=1", obs1, step1),
                        ("seeded S=8", obs8, step8)):
        errs["chomp_obstacle"] = max(errs["chomp_obstacle"],
                                     _obstacle_vs_plain(o, what))
        errs["chomp_step"] = max(errs["chomp_step"], _step_vs_plain(st, what))
    for name, args, n_rows in (("chomp_obstacle", obs8, 8),
                               ("chomp_step", step8, 12)):
        fn = getattr(kernels, name)
        full = fn(*args)
        same = all(_same_bits(a[0], b[r]) for r in range(8)
                   for a, b in zip(fn(*_rows_of(args, r, n_rows, 8)), full))
        log(f"{name} S=8: rows against their single launches "
            f"{'bit-equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{name} rows depend on the batch")

    # timings: 50 launches in one CUDA graph (median of 5 replays) beside
    # an empty kernel's at the same grid, the time through the wrapper,
    # the plain version, the wrapper's host time a call, the bound
    main = {"chomp_obstacle": calls["obs"][len(calls["obs"]) // 2],
            "chomp_step": calls["step"][len(calls["step"]) // 2]}
    cases = {(n, "suite scene 1 (S=1)"): a for n, a in main.items()}
    cases.update({("chomp_obstacle", "seeded S=8"): obs8,
                  ("chomp_step", "seeded S=8"): step8})
    smi = clocks_under_load(lambda: kernels.chomp_obstacle(*obs8))
    log(f"CHOMP kernels under load: clocks.sm, power.draw, power.limit = "
        f"{smi}")
    timing = {}
    for (name, what), args in cases.items():
        wrapper = getattr(kernels, name)
        plain_fn = getattr(kernels, f"{name}_plain")

        def run(args=args, wrapper=wrapper):
            return wrapper(*args)

        def plain(args=args, plain_fn=plain_fn):
            return plain_fn(*args)
        ms = time_graph(run)
        blocks, threads = chomp_block(name, args)
        flops, nbytes = (_chomp_obstacle_work if name == "chomp_obstacle"
                         else _chomp_step_work)(args)
        floor = floor_ms(blocks, threads, args[0].device)
        wrapped = time_launches(run)
        plain_ms = time_ms(plain, 5, 1)
        bound, by = _bound(flops, nbytes)
        split = chomp_host_split(name, args)
        host = split["total"]
        timing[(name, what)] = (ms, plain_ms, bound, by, floor, host)
        log(f"{name} {what}: kernel {ms:.5f} ms (graph of 50), floor "
            f"{floor:.5f} ms (an empty launch of {blocks} x {threads}), "
            f"through the wrapper {wrapped:.4f} ms a call, plain "
            f"{plain_ms:.4f} ms, bound {bound:.7f} ms ({by}; {flops:.3e} "
            f"flop, {nbytes} B), share of bound {bound / ms:.5f}, wrapper "
            f"host {host:.1f} us a call (dispatch {split['dispatch']:.1f}, "
            f"checks {split['checks']:.1f}, allocation "
            f"{split['allocation']:.1f}, launch {split['launch']:.1f})")
    sm = float(smi.split()[0])
    entries = []
    for name, rep in (("chomp_obstacle", "omg_planner_tpu/ops/chomp.py:197"),
                      ("chomp_step", "omg_planner_tpu/ops/chomp.py:269")):
        ms, plain_ms, bound, by, floor, host = timing[
            (name, "suite scene 1 (S=1)")]
        entries.append(dict(
            name=name, route="cuda",
            source="omg_planner_torch/csrc/chomp_cost.cu", replaces=rep,
            launches=0, max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=by, library_ms=None,
            share_of_bound=bound / ms, floor_ms=floor, host_us=host,
            sm_clock_mhz=sm, registers=regs[name]["registers"]))
    return entries


def phase_reference(dev):
    """The plan loop on one CPU-staged problem, on the CPU and on ``dev``."""
    scene = PlanningScene.synthetic(SMALL_CFG, scene_id=5, n_obstacles=2,
                                    device="cpu")
    problem = scene.build_problem()
    res_cpu = plan_mod.plan_fast(scene.model, SMALL_CFG, problem)
    model_gpu = interop.panda_model(scene.model, dev)
    res_gpu = plan_mod.plan_fast(model_gpu, SMALL_CFG,
                                 interop.plan_problem(problem, dev))
    d = float((res_gpu.traj.cpu() - res_cpu.traj).abs().max())
    log(f"reference plan (scene 5, small cfg): cpu goal {int(res_cpu.goal_idx)}"
        f" flag {bool(res_cpu.flag)}; {dev} goal {int(res_gpu.goal_idx)} flag "
        f"{bool(res_gpu.flag)}; max|traj diff| {d:.2e}")
    if (int(res_cpu.goal_idx) != int(res_gpu.goal_idx)
            or bool(res_cpu.flag) != bool(res_gpu.flag) or not d <= 2e-3):
        raise AssertionError(f"{dev} plan disagrees with the cpu plan")


def _sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


#: the host syncs of each :func:`_timed_plan`'s staging, by its label
STAGE_SYNCS = {}


def _timed_plan(scene, dev, what):
    """Stage, then plan (``step(fast=True)``); logs and returns the
    result.  Counts are read after each part."""
    t0 = time.time()
    scene.build_problem()
    _sync(dev)
    stage_ms, stage_syncs = (time.time() - t0) * 1e3, SYNCS.count
    t1 = time.time()
    res = scene.step(fast=True)
    _sync(dev)
    plan_ms, plan_syncs = (time.time() - t1) * 1e3, SYNCS.count - stage_syncs
    STAGE_SYNCS[what] = stage_syncs
    if res is None:
        raise AssertionError(f"{what}: empty goal set")
    check_traj(res.traj, scene.model, what)
    verdict = "SUCCESS" if bool(res.flag) else "FAIL"
    log(f"{what}: {verdict} steps {int(res.steps_used)} valid goals "
        f"{scene._n_valid_goals} | stage {stage_ms:.1f} ms, {stage_syncs} "
        f"host syncs | plan {plan_ms:.1f} ms, {plan_syncs} host syncs")
    return res


#: the kernels of a Panda goal-set build from the grasp database: each
#: launched once a build
BUILD_KERNELS = ("ik_prefilter", "ik_chain")
#: the kernels every Panda plan with the MD learner launches, its goal-set
#: build included, and none other outside their phases
PLAN_KERNELS = ("panda_fk", "sdf_query", "md_update", "joint_limit",
                "chomp_obstacle", "chomp_step") + BUILD_KERNELS
#: the most host syncs that a suite scene's staging (its goal-set build
#: and ``build_problem``) may take
STAGE_SYNC_CAP = 9


def _check_launches(what, expect) -> dict:
    """The launch counts since the last reset; fails unless exactly the
    kernels of ``expect`` launched."""
    counts = {k: fn.launches for k, fn in kernels.KERNELS.items()}
    log(f"[{what} launches: {counts}]")
    for k, n in counts.items():
        if (k in expect) != (n > 0):
            raise AssertionError(f"{k} launched {n} times on the {what} "
                                 "path")
    return counts


def phase_standard(dev) -> dict:
    """The main path: three suite plans; returns the launches of the plan
    kernels in them."""
    cfg = OMGConfig(silent=True)
    total = dict.fromkeys(PLAN_KERNELS, 0)
    for i in (0, 1, 2):
        path = os.path.join(SUITE, f"scene_{i}.npz")
        scene = PlanningScene.from_npz(cfg, path, device=dev)
        reset_counts()
        what = f"standard plan suite scene {i}"
        res = _timed_plan(scene, dev, what)
        counts = _check_launches(f"standard suite scene {i}", PLAN_KERNELS)
        # chomp_obstacle called once an evaluation, chomp_step once an
        # eager one or a capture (phase 6 counts the device's launches)
        evals, graphed, _ = _chomp_runs(res)
        g = GRAPHS.counts["chomp"]
        log(f"{what}: graphs {GRAPHS.counts}")
        calls = [counts[k] for k in CHOMP_ENTRIES]
        if calls != [evals, evals - graphed + g["capture"]]:
            raise AssertionError(f"{what}: {evals} CHOMP evaluations "
                                 f"({graphed} graphed) called the CHOMP "
                                 f"wrappers {calls} times")
        if (any(counts[k] != 1 for k in BUILD_KERNELS)
                or STAGE_SYNCS[what] > STAGE_SYNC_CAP):
            raise AssertionError(f"{what}: the build launched "
                                 f"{[counts[k] for k in BUILD_KERNELS]} IK "
                                 f"kernels and took {STAGE_SYNCS[what]} "
                                 f"host syncs (1 each, at most "
                                 f"{STAGE_SYNC_CAP})")
        for k in total:
            total[k] += counts[k]
    return total


def _profiled(fn, dev, what, cpu: bool = True):
    """``fn()`` under ``torch.profiler``: (result, wall ms under the
    profiler, device operations, device ms by operation name, device
    operations by the innermost ``attr::<label>`` range that launched
    them, "other" outside every range; empty with ``cpu=False``; device
    operations by name).  Fails
    when the profiler records no device operation.  ``cpu=False`` traces
    the device alone (reading a trace that holds the host's operations too
    is slow in Python)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.time()
        out = fn()
        _sync(dev)
        wall_ms = (time.time() - t0) * 1e3
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and not e.name.startswith("attr::")]
    if not ops:
        raise AssertionError(f"profile {what}: wall {wall_ms:.1f} ms, but "
                             "the profiler recorded no device operations")
    by_name, by_count = {}, {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        by_count[e.name] = by_count.get(e.name, 0) + 1
    by_range = {}
    for e in prof.events() if cpu else ():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        up, label = e, "other"
        while up is not None:
            if up.name.startswith("attr::"):
                label = up.name[len("attr::"):]
                break
            up = up.cpu_parent
        by_range[label] = by_range.get(label, 0) + sum(
            not k.name.startswith("attr::") for k in e.kernels)
    return out, wall_ms, len(ops), by_name, by_range, by_count


# phase 6's attribution: the port's functions whose device operations it
# counts, each under its label (the first two are the functions of the two
# plan kernels, the labels with a kernel's name in brackets those of the
# CHOMP and loop kernels); a function called inside another counts under
# its own label.  The ranges are put around each name in the module that
# calls it, by this script only.
ATTRIBUTION = {
    "FK + body points": [(model_api, n) for n in (
        "fk_points", "end_points", "fk_batch", "fk_one",
        "fk_with_joint_info_batch", "point_positions")],
    "collision query": [(m, "sdf_potentials") for m in (
        chomp_mod, learner_mod, goal_set_mod)],
    "CHOMP obstacle terms (chomp_obstacle)": [
        (kernels, "_chomp_obstacle_op")],
    "CHOMP cost, the rest": [(chomp_mod, "compute_collision_loss")],
    "CHOMP step (chomp_step)": [(kernels, "_chomp_step_op")],
    "CHOMP step, the rest": [(chomp_mod, "chomp_step")],
    "plan step, the rest (goal and tail gathers)": [
        (plan_mod, "_chomp_update")],
    "learner derivatives (get_derivative)": [
        (learner_mod, "get_derivative")],
    "joint-limit loop (joint_limit)": [(chomp_mod, "handle_joint_limit")],
    "learner sweep, the rest": [(learner_mod, "cost_vector_raw")],
    "MD expert update (md_update)": [(learner_mod, "update_goal_dist")],
    "learner, the rest": [(learner_mod, "update_goal")],
}


# phase 6's attribution of a goal-set build's device operations: the two
# IK kernels' functions, the rest of the IK (survivor ranking, gathers, the
# chains' assembly) and the stages after it
BUILD_ATTRIBUTION = {
    "prefilter (ik_prefilter)": [(ik_mod, "ik_batch_fixed")],
    "chain (ik_chain)": [(ik_mod, "_solve_chain_fused")],
    "IK, the rest": [(ik_mod, "solve_goal_set")],
    "flip and task-space filter": [(goal_set_mod, "flip_wrist"),
                                   (goal_set_mod, "task_space_filter")],
    "prune": [(goal_set_mod, "collision_prune")],
    "dedupe": [(goal_set_mod, "diversity_dedupe")],
    "sampling": [(goal_set_mod, "sample_goals")],
}


@contextlib.contextmanager
def _ranges(spec):
    """Each (module, name) of ``spec`` ({label: [(module, name), ...]})
    called inside a ``record_function`` range ``attr::<label>`` while the
    context is open."""
    saved = []
    try:
        for label, targets in spec.items():
            for mod, name in targets:
                orig = getattr(mod, name)

                def wrapped(*a, _orig=orig, _label=label, **k):
                    with torch.profiler.record_function(f"attr::{_label}"):
                        return _orig(*a, **k)
                saved.append((mod, name, orig))
                setattr(mod, name, wrapped)
        yield
    finally:
        for mod, name, orig in reversed(saved):
            setattr(mod, name, orig)


#: each plan kernel's device functions, as the profiler names them
DEVICE_KERNELS = {"panda_fk": ("panda_fk_kernel",),
                  "sdf_query": ("sdf_loop_kernel", "sdf_spread_kernel"),
                  "md_update": ("md_update_kernel",),
                  "joint_limit": ("joint_limit_kernel",),
                  "chomp_obstacle": ("chomp_obstacle_kernel",),
                  "chomp_step": ("chomp_step_kernel",)}


def _plan_launches(scene, dev, by_count, evals: int, rerun: int) -> dict:
    """Each plan kernel's device launches in phase 6's profiled plan
    (``by_count``: its device operations by name), held to the launches of
    the same plan run eagerly, where each launch is a wrapper call, plus
    those of ``rerun`` eager CHOMP evaluations (a graphed plan's re-run of
    its terminating step); ``chomp_obstacle`` and ``chomp_step`` must have
    run once each of the plan's ``evals`` CHOMP evaluations."""
    got = {k: sum(n for name, n in by_count.items()
                  if any(d in name for d in names))
           for k, names in DEVICE_KERNELS.items()}
    cfg = scene.cfg
    problem = scene.build_problem()
    hp = cfg.horizon().on(dev)
    reset_counts()
    plan_mod._chomp_update(scene.model, cfg, hp, problem, problem.traj_init,
                           torch.zeros((), dtype=torch.int64, device=dev),
                           plan_mod.schedule_weights(cfg, 1))
    per_eval = {k: kernels.KERNELS[k].launches for k in DEVICE_KERNELS}
    reset_counts()
    with _eager_plans():
        scene.step(fast=True)
    _sync(dev)
    want = {k: kernels.KERNELS[k].launches + rerun * per_eval[k]
            for k in DEVICE_KERNELS}
    log(f"plan kernels' device launches in the profiled plan: {got}; the "
        f"eager plan's wrapper calls with {rerun} re-run: {want}; "
        f"{evals} CHOMP evaluations")
    if (got != want or got["chomp_obstacle"] != evals
            or got["chomp_step"] != evals):
        raise AssertionError(f"the profiled plan launched {got} on the "
                             f"device, not {want} ({evals} CHOMP "
                             "evaluations)")
    return got


def phase_profile(dev):
    """Where one standard plan's time goes: ``torch.profiler`` over
    ``step(fast=True)`` of suite scene 1 (goal set already staged), for
    the device's busy share and the device operations per plan; then the
    same scene's goal-set build, warm, its device operations by the
    function that launched them.  Returns the plan kernels' device
    launches in the profiled plan (:func:`_plan_launches`)."""
    cfg = OMGConfig(silent=True)
    path = os.path.join(SUITE, "scene_1.npz")
    scene = PlanningScene.from_npz(cfg, path, device=dev)
    scene.step(fast=True)  # stages the goal set and warms up
    _sync(dev)
    reset_counts()
    with _ranges(ATTRIBUTION):
        res, wall_ms, n_ops, by_name, by_range, by_count = _profiled(
            lambda: scene.step(fast=True), dev,
            "standard plan suite scene 1")
    steps = int(res.steps_used)
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"profile standard plan suite scene 1 ({steps} steps):"
        f" wall {wall_ms:.1f} ms under the profiler, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), {n_ops} "
        f"device operations, {n_ops / steps:.1f} a plan step")
    for name, us in top:
        log(f"  {us / 1e3:8.3f} ms  {name[:100]}")
    linked = sum(by_range.values())
    log(f"device operations of the plan by the function that launched them "
        f"({linked} of {n_ops} linked to their launch):")
    for label, n in sorted(by_range.items(), key=lambda kv: -kv[1]):
        log(f"  {n:7d}  {n / steps:8.1f} a step  {100 * n / linked:5.1f}%  "
            f"{label}")
    sorts = {n: us for n, us in by_name.items() if "sort" in n.lower()}
    log(f"  sort kernels of the plan: {len(sorts)} names, "
        f"{sum(sorts.values()) / 1e3:.3f} ms")
    chomp_ops = [by_range.get(label, 0) for label in (
        "CHOMP obstacle terms (chomp_obstacle)", "CHOMP step (chomp_step)")]
    # chomp_obstacle runs between a graph's segments, in its range;
    # chomp_step's graphed launches come from the graph, outside it
    evals, graphed, rerun = _chomp_runs(res)
    if chomp_ops != [evals, evals - graphed]:
        raise AssertionError(f"the CHOMP kernels' ranges hold {chomp_ops} "
                             f"device operations, not {evals} and "
                             f"{evals - graphed} ({graphed} of {evals} CHOMP "
                             "evaluations graphed)")
    launches = _plan_launches(scene, dev, by_count, evals, rerun)

    # the same scene's goal-set build, warm (the staging rebuilt)
    scene._staged = None
    with _ranges(BUILD_ATTRIBUTION):
        _, wall_ms, n_ops, by_name, by_range, _ = _profiled(
            scene.build_problem, dev, "goal-set build suite scene 1")
    busy_ms = sum(by_name.values()) / 1e3
    linked = sum(by_range.values())
    log(f"profile goal-set build suite scene 1 (warm): wall {wall_ms:.1f} ms "
        f"under the profiler, device busy {busy_ms:.3f} ms, {n_ops} device "
        f"operations ({linked} linked to their launch), by the function "
        "that launched them:")
    for label, n in sorted(by_range.items(), key=lambda kv: -kv[1]):
        log(f"  {n:7d}  {100 * n / max(linked, 1):5.1f}%  {label}")
    ik_ops = {label: by_range.get(label, 0)
              for label in list(BUILD_ATTRIBUTION)[:2]}
    if any(n != 1 for n in ik_ops.values()):
        raise AssertionError(f"the build's IK ranges hold {ik_ops} device "
                             "operations, not one each (the launch)")
    return launches


def phase_perception(dev) -> int:
    cfg = OMGConfig(silent=True)
    reset_counts()
    t0 = time.time()
    scene = perception_plan(cfg, 0, 2, device=dev)
    if scene is None:
        raise AssertionError("perception: no grasps")
    _sync(dev)
    log(f"perception observe + full-scene goal set + point SDF: "
        f"{(time.time() - t0) * 1e3:.1f} ms, {SYNCS.count} host syncs")
    SYNCS.count = 0
    _timed_plan(scene, dev, "perception plan -p -f 0")
    return _check_launches("perception", ("min_dist_grid",)
                           + PLAN_KERNELS)["min_dist_grid"]


def phase_suite_runner(dev):
    """``SuiteRunner`` over suite scenes 0-7 with validation, then a resume
    that must plan nothing."""
    made = {}

    class Runner(SuiteRunner):
        def _make_scene(self, sid):
            made[sid] = super()._make_scene(sid)
            return made[sid]

    sids = range(8)
    with tempfile.TemporaryDirectory() as out:
        runner = Runner(out, OMGConfig(silent=True), scene_source="npz",
                        suite_dir=SUITE, device=dev)
        reset_counts()
        RETRIES.count = 0
        t0 = time.time()
        summary = runner.run(sids)
        _sync(dev)
        wall = time.time() - t0
        for sid in sids:
            rec = runner.manifest["done"][str(sid)]
            shard = os.path.join(out, f"scene_{sid}.npz")
            if rec.get("no_goals") or not os.path.exists(shard):
                raise AssertionError(f"suite runner scene {sid}: no shard")
            check_traj(np.load(shard)["traj"], made[sid].model,
                       f"suite runner scene {sid}")
            log(f"suite runner scene {sid}: "
                f"{'SUCCESS' if rec['success'] else 'FAIL'} steps "
                f"{rec['steps']} exec_valid {rec['exec_valid']} wall "
                f"{1e3 * rec['wall_s']:.0f} ms, staging + plan host syncs "
                f"{made[sid].dispatch_syncs}")
        log(f"suite runner: {summary['success']}/{summary['total']} "
            f"success, {summary['exec_valid']} execution-valid, "
            f"{wall:.2f} s for {len(sids)} scenes with validation, "
            f"{SYNCS.count} host syncs in all")
        _check_launches("suite runner", PLAN_KERNELS)
        made.clear()
        again = Runner(out, OMGConfig(silent=True), scene_source="npz",
                       suite_dir=SUITE, device=dev)
        if again.pending(sids) or again.run(sids)["total"] != len(sids) \
                or made:
            raise AssertionError("suite runner resume planned again")
        log("suite runner resume: nothing pending, nothing planned")
    if RETRIES.count:
        raise AssertionError(f"{RETRIES.count} retries in the suite runner")


def phase_bench():
    """``bench_torch.py`` in a subprocess on the card: the analytic
    backend with every phase, then the grid backend and the fused field."""
    for args in (["--scenes", "8"],
                 ["--backend", "exact", "--scenes", "2", "--skip-cascade"],
                 ["--backend", "fused", "--scenes", "2", "--skip-cascade"]):
        t0 = time.time()
        out = subprocess.run(
            [sys.executable, os.path.join(ROOT, "bench_torch.py")] + args,
            capture_output=True, text=True, timeout=900, cwd=ROOT)
        for line in out.stderr.strip().splitlines()[-12:]:
            log(f"  {line}")
        if out.returncode != 0:
            raise AssertionError(f"bench_torch.py {' '.join(args)} exited "
                                 f"{out.returncode}")
        if "[retry]" in out.stderr:
            raise AssertionError(f"bench_torch.py {' '.join(args)} retried")
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        missing = [k for k in BENCH_KEYS if k not in rec]
        if missing:
            raise AssertionError(f"bench_torch.py: missing keys {missing}")
        log(f"bench_torch.py {' '.join(args)} ({time.time() - t0:.1f} s): "
            f"{json.dumps(rec)}")


def phase_fused(dev):
    """The fused world field at full width on suite scenes 0-2; its query
    against the exact grid query; its two bakes against each other."""
    cfg = OMGConfig(silent=True, sdf_analytic=False, sdf_fused=True)
    scene0 = None
    for i in (0, 1, 2):
        scene = PlanningScene.from_npz(
            cfg, os.path.join(SUITE, f"scene_{i}.npz"), device=dev)
        scene.env.scene_sdf()
        scene.env.cost_params()
        _sync(dev)
        t0 = time.time()
        wf = scene._world_field()
        _sync(dev)
        bake_ms = (time.time() - t0) * 1e3
        log(f"fused suite scene {i}: field {tuple(wf.data5.shape)} baked in "
            f"{bake_ms:.1f} ms")
        reset_counts()
        _timed_plan(scene, dev, f"fused plan suite scene {i}")
        scene0 = scene0 or scene
    # production field against the exact query (reported), then the
    # check of tests/test_world_field.py on its scene: synthetic scene 0
    # with two obstacles, the nearest-cell field of the baked stack
    gen = torch.Generator().manual_seed(7)
    pts = (torch.tensor([0.1, -0.5, 0.2]) + torch.rand(
        10000, 3, generator=gen) * torch.tensor([0.8, 1.0, 0.7])).to(dev)
    _field_vs_exact(scene0, scene0._world_field(), pts,
                    "production field, suite scene 0 (no bar)")
    syn = PlanningScene.synthetic(OMGConfig(silent=True, sdf_analytic=False),
                                  scene_id=0, n_obstacles=2, device=dev)
    p = syn.env.cost_params()
    args = (p.inv_poses, p.epsilons, p.padding_scales, p.clearances,
            p.disables)
    near = sdf_mod.bake_world_field(syn.env.scene_sdf(), *args)
    q95, cos05, dis, far = _field_vs_exact(
        syn, near, pts, "nearest-cell field, synthetic scene 0 (bars: q95 "
        "< 0.02, cos q05 > 0.9, disagreement < 0.05, far point 0)")
    if not (q95 < 0.02 and cos05 > 0.9 and dis < 0.05 and far == 0.0):
        raise AssertionError("fused query disagrees with the exact query")
    # the nearest-cell bake of the baked stack against the snapped bake
    fields = [o.sdf for o in scene0.env.objects]
    p = scene0.env.cost_params()
    args = (p.inv_poses, p.epsilons, p.padding_scales, p.clearances,
            p.disables)
    baked = sdf_mod.stage_scene_sdfs(fields, dev, baked=True)
    _sync(dev)
    t0 = time.time()
    near = sdf_mod.bake_world_field(baked, *args)
    _sync(dev)
    near_ms = (time.time() - t0) * 1e3
    kinds, halfs, pens, _, _, dims, limits, _ = \
        sdf_mod.analytic_prim_arrays(fields)

    def t(a):
        return torch.as_tensor(a, device=dev)

    t0 = time.time()
    snap = sdf_mod.bake_world_field_analytic(
        t(kinds), t(halfs), t(pens), t(limits), *args, t(dims), snap=True)
    _sync(dev)
    snap_ms = (time.time() - t0) * 1e3
    d = (near.data5 - snap.data5).abs().reshape(-1, 5).amax(0).tolist()
    log(f"fused bakes, suite scene 0: nearest-cell {near_ms:.1f} ms, "
        f"snapped analytic {snap_ms:.1f} ms; max |diff| pot {d[0]:.3e} "
        f"(bar 3e-5), grad {max(d[1:4]):.3e} (bar 3e-3), min distance "
        f"{d[4]:.3e} (bar 3e-5)")
    if not (d[0] <= 3e-5 and max(d[1:4]) <= 3e-3 and d[4] <= 3e-5):
        raise AssertionError("the two fused bakes disagree")


def _field_vs_exact(scene, wf, pts, what):
    """``tests/test_world_field.py``'s comparison of a fused field's query
    with the exact query of the scene's grid stack: (|pot| q95, gradient
    cosine q05 where both potentials are active, collide disagreement,
    largest output at a far free-space point)."""
    p = scene.env.cost_params()
    pot_e, grad_e, col_e = sdf_mod.sdf_potentials(
        scene.env.scene_sdf(), p.inv_poses, pts, p.epsilons,
        p.padding_scales, p.clearances, p.disables)
    pot_f, grad_f, col_f = sdf_mod.world_field_query(wf, pts)
    q95 = float(torch.quantile((pot_e - pot_f).abs(), 0.95))
    active = (pot_e > 1e-3) & (pot_f > 1e-3)
    ge, gf = grad_e[active], grad_f[active]
    ok = (ge.norm(dim=-1) > 1e-6) & (gf.norm(dim=-1) > 1e-6)
    cos = torch.nn.functional.cosine_similarity(ge[ok], gf[ok], dim=-1)
    cos05 = float(torch.quantile(cos, 0.05)) if len(cos) else 1.0
    dis = float((col_e != col_f).float().mean())
    far = max(float(a.abs().max()) for a in sdf_mod.world_field_query(
        wf, torch.tensor([[0.0, 0.0, 1.2]], device=pts.device)))
    log(f"fused query vs exact, {what}, {len(pts)} points: |pot| q95 "
        f"{q95:.4f}, grad cos q05 {cos05:.4f} over {int(ok.sum())} active "
        f"points, collide disagreement {dis:.4f}, far point {far}")
    return q95, cos05, dis, far


def _ur_chain(dev):
    """The UR-like 6-DOF arm of ``tests/test_chain_plan.py``."""
    def joint(name, parent, child, xyz, rpy, axis):
        return (f'<joint name="{name}" type="revolute"><parent '
                f'link="{parent}"/><child link="{child}"/><origin '
                f'xyz="{xyz}" rpy="{rpy}"/><axis xyz="{axis}"/><limit '
                f'lower="-3.1" upper="3.1"/></joint><link name="{child}"/>')

    urdf = ('<robot name="ur_like"><link name="base_link"/>'
            + joint("shoulder_pan", "base_link", "shoulder", "0 0 0.089",
                    "0 0 0", "0 0 1")
            + joint("shoulder_lift", "shoulder", "upper_arm", "0 0.135 0",
                    "0 1.570796 0", "0 1 0")
            + joint("elbow", "upper_arm", "forearm", "0 -0.119 0.425",
                    "0 0 0", "0 1 0")
            + joint("wrist_1", "forearm", "wrist1", "0 0 0.392",
                    "0 1.570796 0", "0 1 0")
            + joint("wrist_2", "wrist1", "wrist2", "0 0.093 0", "0 0 0",
                    "0 0 1")
            + joint("wrist_3", "wrist2", "tool0", "0 0 0.094", "0 0 0",
                    "0 1 0")
            + "</robot>")
    m = chain.load_urdf_chain(urdf, "base_link", "tool0",
                              collision_points_per_link=8, device=dev)
    rng = np.random.default_rng(3)
    pts = rng.normal(scale=0.02, size=(m.num_joints, 8, 3))
    pts[..., 2] += np.linspace(0, 0.15, 8)[None, :]
    return chain.with_collision_points(m, pts)


def _chain_problem(model, cfg, start, end, baked: bool = False):
    """A pillar beside the arm; a fixed goal configuration.  Its grid is
    read by the exact query, or with ``baked`` by the baked one (the
    planner's grid default, ``sdf_baked=True``)."""
    d = model.device
    box = sdf_mod.SignedDensityField.from_analytic("box", [0.2, 0.2, 0.4],
                                                   delta=0.02)
    pose = np.eye(4)
    pose[:3, 3] = [0.7, 0.0, 0.3]
    start, end = (torch.as_tensor(np.asarray(a, np.float32), device=d)
                  for a in (start, end))
    lo, hi = model.soft_limits(cfg.soft_joint_limit_padding)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=d)

    return plan_mod.PlanProblem(
        start=start, end=end,
        traj_init=plan_mod.init_trajectory(cfg, start, end),
        goal_set=GoalSet(
            grasps=end[None].repeat(4, 1),
            reach_grasps=end[None, None].repeat(4, cfg.reach_tail_length, 1),
            mask=torch.ones(4, dtype=torch.bool, device=d),
            potentials=torch.zeros(4, device=d)),
        scene=(sdf_mod.bake_scene if baked else lambda s: s)(
            sdf_mod.combine_sdfs([box.penalize_inside(5.0)], d)),
        cost_params=CostParams(
            inv_poses=f32(np.linalg.inv(pose)[None]), epsilons=f32([0.2]),
            padding_scales=f32([1.0]), clearances=f32([0.0]),
            disables=f32([0.0]), target_idx=torch.tensor(0, device=d)),
        joint_lower=lo, joint_upper=hi,
        world_potential=sdf_mod.WorldPotential(
            data=torch.zeros((2, 2, 2), device=d),
            origin=torch.zeros(3, device=d),
            delta=torch.tensor(1.0, device=d)))


def phase_chain(dev):
    """The UR-like chain on ``dev`` and on the CPU, every step of the full
    budget (no early termination), with the pillar's grid read by the
    exact query and by the baked one (``sdf_query`` on the card)."""
    cfg = OMGConfig(silent=True, goal_set_proj=False, use_standoff=False,
                    pre_terminate=False)
    start = [0.0, -1.2, 1.6, -0.5, 0.0, 0.0]
    end = [1.2, -0.9, 1.2, -0.8, 0.6, 0.3]
    for query in ("exact", "baked"):
        out = {}
        for where in (dev, "cpu"):
            model = _ur_chain(where)
            problem = _chain_problem(model, cfg, start, end,
                                     baked=query == "baked")
            _sync(where)
            SYNCS.count = 0
            t0 = time.time()
            res = plan_mod.plan_fast(model, cfg, problem)
            _sync(where)
            out[where] = res
            log(f"chain plan (UR-like, 6 dof, {cfg.total_steps}-step "
                f"budget, {query} query) on {where}: "
                f"{'SUCCESS' if bool(res.flag) else 'FAIL'} steps "
                f"{int(res.steps_used)}, collide "
                f"{float(res.info.collide):.0f}, "
                f"{(time.time() - t0) * 1e3:.1f} ms, {SYNCS.count} host "
                "syncs")
        a, b = out[dev], out["cpu"]
        diff = float((a.traj.cpu() - b.traj).abs().max())
        log(f"chain plan, {query} query: max|traj {dev} - cpu| {diff:.2e}")
        if (a.traj.shape != (cfg.timesteps, 6)
                or bool(a.flag) != bool(b.flag)
                or int(a.steps_used) != int(b.steps_used)
                or not diff <= 2e-3):
            raise AssertionError(f"chain plan ({query} query) on {dev} "
                                 "disagrees with the cpu")


def phase_tasks(dev):
    """A grasp plan, then a placement, on synthetic scene 0 at full
    width."""
    cfg = OMGConfig(silent=True)
    scene = PlanningScene.synthetic(cfg, scene_id=0, n_obstacles=0,
                                    device=dev)
    target = scene.env.target
    reset_counts()
    t0 = time.time()
    res = tasks.plan_to_target(scene, scene.start, target.name, fast=True)
    _sync(dev)
    if res is None:
        raise AssertionError("tasks: no grasp goals")
    check_traj(res.traj, scene.model, "tasks grasp plan")
    log(f"tasks plan_to_target {target.name}: "
        f"{'SUCCESS' if bool(res.flag) else 'FAIL'} steps "
        f"{int(res.steps_used)}, {(time.time() - t0) * 1e3:.1f} ms, "
        f"{SYNCS.count} host syncs")
    grasp_conf = np.asarray(res.traj[-1], np.float64)
    place = target.pose_mat.copy()
    place[:3, 3] += [0.0, 0.15, 0.0]
    SYNCS.count = 0
    t0 = time.time()
    res, achieved = tasks.place_target(scene, grasp_conf, place, fast=True)
    _sync(dev)
    if scene.env.target.attached or achieved.shape != (4, 4):
        raise AssertionError("tasks: place_target left the target attached")
    err = np.linalg.norm(achieved[:3, 3] - place[:3, 3])
    log(f"tasks place_target: "
        + ("no placement IK (rolled back)" if res is None else
           f"{'SUCCESS' if bool(res.flag) else 'FAIL'} steps "
           f"{int(res.steps_used)}")
        + f", achieved position {np.round(achieved[:3, 3], 4).tolist()} "
        f"({err * 1e3:.1f} mm from the placement), "
        f"{(time.time() - t0) * 1e3:.1f} ms, {SYNCS.count} host syncs")
    if res is not None:
        check_traj(res.traj, scene.model, "tasks place plan")


def _rollout_flops(inputs, traces, iters: int) -> float:
    """The flops one rollout cannot avoid on these inputs (the
    ``ROLLOUT_FLOPS`` counts, with each substep's active lanes read from
    the traces)."""
    f = ROLLOUT_FLOPS
    k = inputs["sph_track"].shape[-2]
    sp2 = 2 * inputs["pad_samples"].shape[1]
    s = inputs["spec"].surf.shape[0]
    o = inputs["world"].kinds.shape[0]
    c = (min(48, k) + min(32, sp2) + min(48, s))
    active = (traces["robot_contacts"] + traces["world_contacts"]).reshape(
        -1).double().cpu().numpy()
    per_cand = f["robot"] * k + f["pad"] * sp2 + f["world_static"] * s * o
    per_lane = (f["lane_setup"] + f["lane_align"] * c + iters * f["lane_iter"]
                + max(iters // 4, 4) * f["lane_pseudo"])
    per_body = iters * f["body_iter"] + max(iters // 4, 4) * f["body_pseudo"]
    return float(len(active) * (per_cand + per_body)
                 + per_lane * active.sum())


def _rollout_bytes(inputs, t: int) -> int:
    """Bytes a rollout must move: every input read once, the final state and
    the 19-float trace row of each substep written once."""
    n = sum(v.numel() * v.element_size() for v in inputs.values()
            if isinstance(v, torch.Tensor))
    for box in (inputs["spec"], inputs["world"], inputs["pp"],
                inputs["state0"]):
        n += sum(v.numel() * v.element_size() for v in box
                 if isinstance(v, torch.Tensor))
    return n + 4 * (13 + 19 * t)


def _batched(inputs):
    """The keyword arguments of ``rigid.rollout`` as the positional,
    batched arguments of ``kernels.rigid_rollout``."""
    args, _ = rigid._defaults(
        *(inputs[k] for k in ("state0", "sph_track", "is_finger",
                              "pad_track", "pad_samples", "pad_axis",
                              "jv_track", "jv_ref")))
    return (inputs["spec"], inputs["world"], inputs["pp"], *args)


def _pick(dev):
    """Suite scene 0 planned at full width and its pick rollout's inputs:
    (scene, trajectory, PickSetup, the batched arguments of
    ``kernels.rigid_rollout``)."""
    scene = PlanningScene.from_npz(OMGConfig(silent=True),
                                   os.path.join(SUITE, "scene_0.npz"),
                                   device=dev)
    res = scene.step(fast=True)
    if res is None or not bool(res.flag):
        raise AssertionError("physics: suite scene 0 did not plan")
    traj = np.asarray(res.traj)
    setup = executor.pick_setup(scene, traj)
    _sync(dev)
    return scene, traj, setup, _batched(setup.inputs)


def rollout_cycles(batched, what: str) -> dict:
    """One launch of the profile build (``kernels.rigid_rollout_cycles``)
    on ``batched``: clock64() cycles per substep in each phase, logged and
    returned by phase name."""
    _, tr, cyc = kernels.rigid_rollout_cycles(*batched, iters=96)
    torch.cuda.synchronize()
    t = tr["x"].shape[1]
    per = (cyc[0].double() / t).cpu().numpy()
    out = dict(zip(kernels.ROLLOUT_PHASES, per.tolist()))
    log(f"rigid_rollout cycles per substep by phase, {what} ({t} substeps, "
        f"profile build): " + ", ".join(f"{k} {v:.0f}" for k, v in
                                         out.items())
        + f"; total {per.sum():.0f}")
    return out


def _place(scene, traj):
    """A placement rollout's batched inputs on suite scene 0: the target
    held at the pick plan's grasp and carried back along the reversed plan
    (``executor.place_setup``'s 923 substeps at its defaults)."""
    scene.attach_target(traj[-1])
    rel = scene.env.target.rel_hand_pose.copy()
    scene.detach_target()
    return _batched(executor.place_setup(
        scene, np.ascontiguousarray(traj[::-1]), rel).inputs)


def _cat_rollouts(x, y):
    """Two batched argument tuples of ``kernels.rigid_rollout`` as one
    batch (body, world, parameters, finger mask and pad samples shared)."""
    def cat(i, a, b):
        if i == 3:
            return rigid.BodyState(*(torch.cat(p) for p in zip(a, b)))
        return torch.cat([a, b]) if i in (4, 6, 8, 9, 10) else a

    return tuple(cat(i, a, b) for i, (a, b) in enumerate(zip(x, y)))


def rollout_profile(scene, traj, batched, what: str) -> dict:
    """The rollout kernel's numbers on suite scene 0: the pick rollout's
    time (median of 5 runs of 5 back-to-back launches) with the SM clock
    sampled under load, the profile build's cycles by phase, and one
    placement rollout's time (median of 3 runs of 2 launches)."""
    def run():
        return kernels.rigid_rollout(*batched, iters=96)

    ms = time_launches(run, launches=5, runs=5, warmup=1)
    smi = clocks_under_load(run, calls=5)
    t = batched[4].shape[1] - 1
    log(f"rigid_rollout pick, {what} (B=1, T={t}, K={batched[4].shape[2]}, "
        f"Sp={batched[7].shape[1]}, S={batched[0].surf.shape[0]}, "
        f"O={batched[1].kinds.shape[0]}, C=128, iters=96): {ms:.3f} ms "
        f"(median of 5 runs of 5 launches), {1e3 * ms / t:.2f} us a "
        f"substep; under load clocks.sm, power.draw, power.limit = {smi}")
    cycles = rollout_cycles(batched, what)
    placed = _place(scene, traj)
    t_place = placed[4].shape[1] - 1
    place_ms = time_launches(
        lambda: kernels.rigid_rollout(*placed, iters=96), launches=2,
        runs=3, warmup=1)
    log(f"rigid_rollout placement, {what} (T={t_place}): {place_ms:.3f} ms "
        f"(median of 3 runs of 2 launches), {1e3 * place_ms / t_place:.2f} "
        f"us a substep")
    return dict(ms=ms, sm_clock_mhz=float(smi.split()[0]), cycles=cycles,
                place_ms=place_ms)


def phase_physics(dev):
    """Suite scene 0's plan executed at full width, the kernel against its
    plain version, ``NativePanda`` and the ``phys_exec`` app; returns the
    ``rigid_rollout`` kernel entry."""
    scene, traj, setup, batched = _pick(dev)
    inputs = setup.inputs

    # the main path: one executed plan
    reset_counts()
    t0 = time.time()
    rep = executor.execute_plan(scene, traj)
    _sync(dev)
    wall_ms = (time.time() - t0) * 1e3
    launches = kernels.rigid_rollout.launches
    log(f"physics execute_plan suite scene 0: {rep.to_dict()}, "
        f"{wall_ms:.1f} ms, rigid_rollout launches {launches}")
    if launches != 1 or kernels.min_dist_grid.launches:
        raise AssertionError("physics: execute_plan must launch rigid_rollout "
                             "once and min_dist_grid never")
    if not np.isfinite(list(rep.to_dict().values())).all():
        raise AssertionError(f"physics: non-finite report {rep}")

    # the kernel against its plain version on the same inputs
    def run():
        return kernels.rigid_rollout(*batched, iters=96)

    fk, tk = run()
    _sync(dev)
    t0 = time.time()
    fp, tp = rigid.rollout_plain(*batched, iters=96)
    _sync(dev)
    plain_ms = (time.time() - t0) * 1e3
    rk = executor.pick_report(setup, *rigid._unbatch(fk, tk, True))
    rp = executor.pick_report(setup, *rigid._unbatch(fp, tp, True))
    settle = 30
    gap_settle = float((tk["x"][:, :settle] - tp["x"][:, :settle]).abs().max())
    gap_final = float((fk.x - fp.x).norm())
    err = float((tk["x"] - tp["x"]).abs().max())
    log(f"rigid_rollout against rollout_plain, suite scene 0 "
        f"({tk['x'].shape[1]} substeps): reward {rk.reward} / {rp.reward}, "
        f"final |x gap| {gap_final:.3e} m (bar 5e-3), settle max|x gap| "
        f"{gap_settle:.3e} m (bar 1e-5), whole-trace max|x gap| {err:.3e} m, "
        f"lifted {rk.lifted_m:.4f} / {rp.lifted_m:.4f} m, hand_dist "
        f"{rk.hand_dist_m:.4f} / {rp.hand_dist_m:.4f} m, finger_stop "
        f"{rk.finger_stop_m:.5f} / {rp.finger_stop_m:.5f} m")
    if (rk.reward != rp.reward or not gap_final <= 5e-3
            or not gap_settle <= 1e-5):
        raise AssertionError("rigid_rollout disagrees with rollout_plain")

    # a batch of two different states in one launch, bit for bit the two
    # single launches
    raised = (*batched[:3], batched[3]._replace(x=batched[3].x + torch.tensor(
        [0.0, 0.0, 0.02], device=dev)), *batched[4:])
    f2, t2 = kernels.rigid_rollout(*_cat_rollouts(batched, raised), iters=96)
    f1, t1 = kernels.rigid_rollout(*raised, iters=96)
    _sync(dev)
    same = all(torch.equal(t2[k], torch.cat([tk[k], t1[k]])) for k in tk) \
        and all(torch.equal(a, torch.cat([b, c]))
                for a, b, c in zip(f2, fk, f1))
    log(f"rigid_rollout B=2 (scene 0's pick, and its state raised 2 cm) "
        f"against two B=1 launches: {'bit-equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("rigid_rollout: a B=2 launch differs from two "
                             "B=1 launches")

    prof = rollout_profile(scene, traj, batched, "this kernel")
    t = tk["x"].shape[1]
    flops = _rollout_flops(inputs, tk, 96)
    nbytes = _rollout_bytes(inputs, t)
    op_ms, byte_ms = flops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    bound = max(op_ms, byte_ms)
    log(f"rigid_rollout roofline bound {bound:.5f} ms ({flops:.3e} flop, "
        f"{nbytes} B); plain {plain_ms:.1f} ms")
    ms = prof["ms"]
    entry = dict(name="rigid_rollout", route="cuda",
                 source="omg_planner_torch/csrc/rigid_rollout.cu",
                 replaces="omg_planner_tpu/physics/rigid.py:857",
                 launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound,
                 bound_by="operations" if op_ms >= byte_ms else "bytes",
                 library_ms=None, share_of_bound=bound / ms,
                 sm_clock_mhz=prof["sm_clock_mhz"],
                 place_ms=prof["place_ms"], cycles=prof["cycles"])

    robot = NativePanda(device=dev)
    robot.step(2)
    _sync(dev)
    t0 = time.time()
    robot.step(200)
    _sync(dev)
    hold = float(np.abs(robot.q - HOME_POSE).max())
    log(f"NativePanda.step(200) (position hold at home, 1 ms substeps): "
        f"{time.time() - t0:.2f} s, max|q - home| {hold:.2e} rad")
    if not (np.isfinite(robot.q).all() and hold < 1e-2):
        raise AssertionError("NativePanda did not hold its pose")

    _phase_phys_exec()
    return entry


def _phase_phys_exec():
    """``apps/phys_exec.py`` over its default 30-scene set in a
    subprocess, beside the JAX package's record of the same set
    (``docs/phys_exec_r04.json``): the reward rate on the scenes the port
    plans held to JAX's band, and per-scene equality only on the scenes
    whose JAX execution is stable (``STABLE_SCENES``)."""
    with open(os.path.join(ROOT, "docs", "phys_exec_r04.json")) as f:
        record = json.load(f)
    ref = {r["scene"]: r for r in record["scenes"]}
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "phys_exec.json")
        t0 = time.time()
        out = subprocess.run(
            [sys.executable, "-m", "omg_planner_torch.apps.phys_exec",
             "--out", out_path],
            capture_output=True, text=True, timeout=900, cwd=ROOT)
        if out.returncode != 0:
            log(out.stderr[-3000:])
            raise AssertionError(f"phys_exec exited {out.returncode}")
        with open(out_path) as f:
            report = json.load(f)
    log(f"phys_exec --scenes {report['n_scenes']} ({time.time() - t0:.1f} s "
        f"with start-up): "
        f"{json.dumps({k: v for k, v in report.items() if k != 'scenes'})}")
    differ = []
    for row in report["scenes"]:
        sid, r = row["scene"], ref[row["scene"]]
        stable = sid in STABLE_SCENES
        log(f"  scene {sid}{' (stable)' if stable else ''}: port plan "
            f"{row.get('plan_flag')} reward {row['reward']} lifted "
            f"{row.get('lifted_m', 0):.4f} exec {row.get('exec_wall_s', 0)} "
            f"s | JAX record plan {r.get('plan_flag')} reward {r['reward']} "
            f"lifted {r.get('lifted_m') or 0:.4f}")
        if stable and row.get("plan_flag") and r.get("plan_flag") \
                and row["reward"] != r["reward"]:
            differ.append(sid)
    rate = report["exec_reward_rate_on_planned"]
    log(f"phys_exec: reward rate on the port's planned scenes {rate} (bar "
        f"{PHYS_EXEC_RATE_BAR}; JAX record "
        f"{record['exec_reward_rate_on_planned']}); stable scenes with "
        f"another reward than the record: {differ}")
    if rate < PHYS_EXEC_RATE_BAR or differ:
        raise AssertionError(f"phys_exec: reward rate {rate}, stable scenes "
                             f"{differ} differ from the record")


def _scene_body(y=0.1):
    return {"objects": [
        {"name": "table", "kind": "box", "extents": [0.9, 1.2, 0.04],
         "pose": pose_at([0.55, 0.0, 0.16]).ravel().tolist()},
        {"name": "mug", "kind": "cylinder", "extents": [0.045, 0.1],
         "pose": pose_at([0.55, y, 0.23]).ravel().tolist(),
         "target": True}]}


def phase_serve(dev):
    """The planning service in a thread: every endpoint once, /plan fresh
    then warm."""
    import threading
    import urllib.error
    import urllib.request

    srv = serve.make_server(0, OMGConfig(silent=True), device=dev)
    port = srv.server_address[1]
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()

    def call(path, body=None, want=200):
        url = f"http://127.0.0.1:{port}{path}"
        req = (urllib.request.Request(url) if body is None else
               urllib.request.Request(url, data=json.dumps(body).encode(),
                                      method="POST"))
        s0, t0 = SYNCS.count, time.time()
        try:
            with urllib.request.urlopen(req) as r:
                code, out = r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            code, out = e.code, json.loads(e.read())
        if code != want:
            raise AssertionError(f"serve {path}: status {code}: {out}")
        return out, (time.time() - t0) * 1e3, SYNCS.count - s0

    try:
        out, _, _ = call("/health")
        log(f"serve /health: {out}")
        builds = []
        real = serve.PlanningScene.build_goal_set

        def counted(self):
            builds.append(1)
            return real(self)

        serve.PlanningScene.build_goal_set = counted
        try:
            for what in ("fresh", "warm"):
                out, ms, syncs = call("/plan", _scene_body())
                log(f"serve /plan {what}: flag {out['flag']} steps "
                    f"{out['steps_used']} goals {out['n_goals']}, stage_s "
                    f"{out['timings']['stage_s']}, plan_s "
                    f"{out['timings']['plan_s']}, request {ms:.1f} ms, "
                    f"{syncs} host syncs, goal-set builds so far "
                    f"{len(builds)}")
                if not np.isfinite(np.asarray(out["traj"])).all():
                    raise AssertionError("serve /plan: bad trajectory")
        finally:
            serve.PlanningScene.build_goal_set = real
        if len(builds) != 1:
            raise AssertionError("serve: the warm /plan re-staged")
        out, ms, syncs = call("/plan_batch", {
            "scenes": [_scene_body(), _scene_body(-0.12)],
            "pipeline_depth": 2})
        log(f"serve /plan_batch (2 scenes, depth 2): flags "
            f"{[r['flag'] for r in out['results']]}, "
            f"{out['plans_per_s']} plans/s, request {ms:.1f} ms, {syncs} "
            f"host syncs")
        out, ms, syncs = call("/execute", _scene_body())
        ex = out.get("execution", {})
        log(f"serve /execute: flag {out['flag']}, execution {ex}, exec_s "
            f"{out['timings'].get('exec_s')}, request {ms:.1f} ms, {syncs} "
            f"host syncs")
        if "reward" not in ex or "exec_s" not in out["timings"]:
            raise AssertionError(f"serve /execute: no execution: {out}")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()


def _same_plan(a, b, what):
    """The scale-out bar: the same goal, verdict and steps, and the
    trajectory bit for bit."""
    for name in ("goal_idx", "flag", "steps_used"):
        if not torch.equal(getattr(a, name), getattr(b, name)):
            raise AssertionError(f"{what}: {name} {getattr(a, name)} vs "
                                 f"{getattr(b, name)}")
    if not torch.equal(a.traj, b.traj):
        gap = float((a.traj - b.traj).abs().max())
        raise AssertionError(f"{what}: trajectories differ by {gap:.3g}")


def _timed(fn, dev):
    """(result, wall ms, host syncs) of ``fn()``."""
    SYNCS.count = 0
    _sync(dev)
    t0 = time.time()
    out = fn()
    _sync(dev)
    return out, (time.time() - t0) * 1e3, SYNCS.count


def phase_scaleout(dev):
    """The goal-sharded pipeline and plan over a world-size-1 NCCL group,
    against the same paths without a group; then two gloo ranks on the
    card through the multi-process demo."""
    import torch.distributed as dist

    store = os.path.join(ROOT, "build", "scaleout_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", store=dist.FileStore(store, 1), rank=0,
                            world_size=1, timeout=multihost.GROUP_TIMEOUT)
    try:
        mesh = multihost.make_scene_mesh(goal_parallel=1, device=dev)
        cfg = OMGConfig(silent=True)
        ids = multihost.my_scene_ids(4, mesh)
        scenes = [PlanningScene.from_npz(
            cfg, os.path.join(SUITE, f"scene_{i}.npz"), device=dev)
            for i in ids]
        n_obj = max(len(sc.env.objects) for sc in scenes)
        n_grasp = max(len(sc.env.grasp_poses_world()) for sc in scenes)
        inputs = [batch_mod.scene_pipeline_input(
            sc, seed=i, num_objects=n_obj, num_grasps=n_grasp)
            for i, sc in zip(ids, scenes)]
        model = scenes[0].model
        sharded = batch_mod.make_sharded_pipeline(mesh, model, cfg)
        plain = batch_mod.make_sharded_pipeline(None, model, cfg)
        # the stacked batch first: its wall includes the first collective's
        # NCCL communicator set-up
        batch = multihost.host_local_batch(mesh, inputs)
        stacked, ms, syncs = _timed(lambda: sharded(batch), dev)
        log(f"scale-out pipeline, scenes {ids} stacked in one call (first "
            f"collectives included): {ms:.1f} ms, {syncs} host syncs")
        for k, (i, inp) in enumerate(zip(ids, inputs)):
            one = multihost.host_local_batch(mesh, [inp])
            res, ms, syncs = _timed(lambda: sharded(one), dev)
            ref, ref_ms, ref_syncs = _timed(lambda: plain(one), dev)
            check_traj(res.traj[0].cpu(), model, f"sharded scene {i}")
            _same_plan(res, ref, f"sharded pipeline suite scene {i}")
            _same_plan(batch_mod._index(stacked, k), batch_mod._index(res, 0),
                       f"stacked batch entry {k}")
            log(f"scale-out pipeline suite scene {i}: "
                f"{'SUCCESS' if bool(res.flag[0]) else 'FAIL'} steps "
                f"{int(res.steps_used[0])} goal {int(res.goal_idx[0])} | "
                f"sharded {ms:.1f} ms, {syncs} host syncs | no group "
                f"{ref_ms:.1f} ms, {ref_syncs} host syncs | equal to the "
                "stacked call")

        cfg0 = cfg.replace(learner_active_goals=0)
        scene = PlanningScene.from_npz(
            cfg0, os.path.join(SUITE, "scene_0.npz"), device=dev)
        problem = scene.build_problem()
        fn = batch_mod.make_sharded_plan(mesh, model, cfg0)
        res, ms, syncs = _timed(
            lambda: fn(batch_mod.stack_problems([problem])), dev)
        ref, ref_ms, ref_syncs = _timed(
            lambda: plan_mod.plan_fast(model, cfg0, problem), dev)
        _same_plan(batch_mod._index(res, 0), ref,
                   "sharded plan, active goals 0")
        log(f"scale-out plan suite scene 0, learner_active_goals=0 (per-step "
            f"all-gather): {'SUCCESS' if bool(ref.flag) else 'FAIL'} steps "
            f"{int(ref.steps_used)} | sharded {ms:.1f} ms, {syncs} host "
            f"syncs | plan_fast {ref_ms:.1f} ms, {ref_syncs} host syncs")
    finally:
        dist.destroy_process_group()

    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "omg_planner_torch.apps.multihost_demo",
         "--world", "2", "--goal-parallel", "2", "--backend", "gloo",
         "--timeout", "240"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    log(out.stdout.strip())
    if out.returncode != 0 or "MULTIHOST DEMO: PASS" not in out.stdout:
        raise AssertionError(f"multihost demo on the card failed "
                             f"(rc {out.returncode}):\n{out.stderr[-3000:]}")
    log(f"multihost demo, 2 gloo ranks on one card: "
        f"{time.time() - t0:.1f} s")


def _scene_batch_builds(cfg, dev, load, max_obj):
    """The goal-set builds alone: each scene's own build, then waves of 4
    in one batched build each; the goal sets must agree."""
    own = load()
    walls = []
    for i, sc in own:
        _, ms, syncs = _timed(lambda: sc.build_problem(assume_goals=True),
                              dev)
        walls.append((ms, syncs))
        log(f"scene batches: own build suite scene {i}: {ms:.1f} ms, "
            f"{syncs} host syncs")
    waves = load()
    model = waves[0][1].model
    for lo in range(0, len(waves), 4):
        wave = waves[lo:lo + 4]
        _, ms, syncs = _timed(lambda: prebuild_goal_sets(
            wave, cfg, model, 4, max_obj), dev)
        own_ms = sum(w[0] for w in walls[lo:lo + 4])
        own_syncs = sum(w[1] for w in walls[lo:lo + 4])
        log(f"scene batches: batched build of suite scenes "
            f"{[i for i, _ in wave]}: {ms:.1f} ms, {syncs} host syncs "
            f"(their own builds: {own_ms:.1f} ms, {own_syncs} host syncs)")
    for (i, a), (_, b) in zip(own, waves):
        _same_goal_set(a._staged[1], b._staged[1], f"batched build scene {i}")


def _same_goal_set(a, b, what):
    if not torch.equal(a.mask, b.mask):
        raise AssertionError(f"{what}: goal-set masks differ")
    gap = float((a.grasps - b.grasps).abs().max())
    if gap > 1e-5:
        raise AssertionError(f"{what}: grasps differ by {gap:.3g}")


def _same_result(a, b, what):
    """The same goal, verdict and steps."""
    for name in ("goal_idx", "flag", "steps_used"):
        x, y = (np.asarray(getattr(r, name).cpu()
                           if torch.is_tensor(getattr(r, name))
                           else getattr(r, name)) for r in (a, b))
        if not np.array_equal(x, y):
            raise AssertionError(f"{what}: {name} {x} vs {y}")


def _outcome(r):
    """(goal, verdict, steps) of one plan."""
    return int(r.goal_idx), bool(r.flag), int(r.steps_used)


def _traj_gap(a, b):
    return float((a.traj - b.traj).abs().max())


def _batch_row_check(model, cfg, pr, mine, one, what):
    """Hold one scene's row ``mine`` of a batched plan to the scene's own
    ``plan_fast`` result ``one``.  Equal: the same goal, verdict and steps
    and trajectories within 1e-5.  Otherwise the scene must be one whose
    own plan_fast is that sensitive: with its start moved by +-1e-7 rad
    (the probes) plan_fast moves by ``own``; the row must share goal,
    verdict and steps with plan_fast or a probe, and lie within min(1e-2,
    10 * own) of the nearest of those.  Returns the note to log."""
    gap = _traj_gap(mine, one)
    if _outcome(mine) == _outcome(one) and gap <= 1e-5:
        return (f"in the batch the same goal, verdict and steps, trajectory "
                f"gap {gap:.3g}")
    probes = [plan_mod.plan_fast(model, cfg, pr._replace(start=pr.start + e))
              for e in (1e-7, -1e-7)]
    own = max(_traj_gap(p, one) for p in probes)
    twins = [p for p in [one] + probes if _outcome(p) == _outcome(mine)]
    seen = [_outcome(p) for p in probes]
    if not twins:
        raise AssertionError(
            f"{what}: (goal, verdict, steps) {_outcome(mine)} in the batch, "
            f"{_outcome(one)} alone, {seen} with the start moved by +-1e-7 "
            f"rad")
    near = min(_traj_gap(mine, p) for p in twins)
    bar = min(1e-2, 10 * own)
    note = (f"in the batch (goal, verdict, steps) {_outcome(mine)}, "
            f"trajectory gap {gap:.3g}; sensitive: with its start moved by "
            f"+-1e-7 rad its plan_fast gives {seen} and moves by {own:.3g}; "
            f"the batch lies {near:.3g} from the nearest of them with its "
            f"goal, verdict and steps (bar min(1e-2, 10 x {own:.3g}))")
    if near > bar:
        raise AssertionError(f"{what}: {note}")
    return note


def _batch_vs_own(model, cfg, stacked, problems, sids, dev):
    """``plan_batch_vmap`` of the stacked problems against each scene's own
    ``plan_fast`` (:func:`_batch_row_check`), with walls and host syncs.
    Returns the batch's result and loop steps."""
    tag = f"optim_steps={cfg.optim_steps} extra_smooth_steps=" \
          f"{cfg.extra_smooth_steps}"
    batched, ms, syncs = _timed(
        lambda: batch_mod.plan_batch_vmap(model, cfg, stacked), dev)
    loop_steps = int(batched.steps_used.max())
    own_ms = own_syncs = own_steps = 0
    for k, (i, pr) in enumerate(zip(sids, problems)):
        one, ms_i, syncs_i = _timed(
            lambda: plan_mod.plan_fast(model, cfg, pr), dev)
        own_ms, own_syncs = own_ms + ms_i, own_syncs + syncs_i
        own_steps += int(one.steps_used)
        what = f"plan_batch_vmap ({tag}) scene {i}"
        note = _batch_row_check(model, cfg, pr, batch_mod._index(batched, k),
                                one, what)
        fired = bool((one.goal_mask != pr.goal_set.mask).any())
        log(f"scene batches ({tag}): plan_fast suite scene {i}: "
            f"{'SUCCESS' if bool(one.flag) else 'FAIL'} steps "
            f"{int(one.steps_used)} goal {int(one.goal_idx)} blacklist "
            f"{'fired' if fired else 'not fired'}: {ms_i:.1f} ms, "
            f"{syncs_i} host syncs; {note}")
    steps = batched.steps_used.tolist()
    if len(set(steps)) < 2:
        raise AssertionError("scene batches: every scene ended at one step")
    log(f"scene batches ({tag}): plan_batch_vmap over suite scenes "
        f"{sids[0]}-{sids[-1]} (steps {steps}, {loop_steps} loop steps): "
        f"{ms:.1f} ms, {syncs} host syncs ({syncs / loop_steps:.2f} a loop "
        f"step) | {len(problems)} plan_fast: {own_ms:.1f} ms, {own_syncs} "
        f"host syncs ({own_syncs / own_steps:.2f} a step)")
    return batched, loop_steps


def phase_scene_batches(dev):
    """Scene batches at full width (phase 17), suite scenes 0-7: the
    batched goal-set build (``plan_pipelined(build_batch=4)``) against the
    per-scene build, and ``plan_batch_vmap`` against ``plan_fast`` per
    scene, at the full budget and at ``optim_steps=10,
    extra_smooth_steps=1``."""
    cfg = OMGConfig(silent=True)
    sids = list(range(8))

    def load():
        return [(i, PlanningScene.from_npz(
            cfg, os.path.join(SUITE, f"scene_{i}.npz"), device=dev))
            for i in sids]

    max_obj = max(len(sc.env.objects) for _, sc in load())
    _scene_batch_builds(cfg, dev, load, max_obj)

    runs = {}
    for bb in (0, 4):
        scenes = load()
        out, ms, syncs = _timed(lambda: list(plan_pipelined(
            scenes, cfg, build_batch=bb)), dev)
        runs[bb] = scenes, out
        log(f"scene batches: plan_pipelined(build_batch={bb}) over suite "
            f"scenes 0-7: {ms:.1f} ms, {syncs} host syncs; per scene "
            + ", ".join(f"{1e3 * wall:.0f} ms ({sc.dispatch_syncs})"
                        for _, sc, _, wall in out))
    for (i, a), (_, b), ra, rb in zip(runs[0][0], runs[4][0], runs[0][1],
                                      runs[4][1]):
        if ra[2] is None or rb[2] is None:
            raise AssertionError(f"scene batches: scene {i}: no goals")
        _same_goal_set(a._staged[1], b._staged[1],
                       f"build_batch=4 scene {i}")
        _same_result(ra[2], rb[2], f"build_batch=4 scene {i}")
        check_traj(rb[2].traj, b.model, f"build_batch=4 scene {i}")

    scenes = runs[4][0]
    model = scenes[0][1].model
    problems = [batch_mod.pad_objects(sc.build_problem(assume_goals=True),
                                      max_obj) for _, sc in scenes]
    stacked = batch_mod.stack_problems(problems)
    _, loop_steps = _batch_vs_own(model, cfg, stacked, problems, sids, dev)
    # a short budget, on which suite scene 1's goal choice is a near tie
    short = cfg.replace(optim_steps=10, extra_smooth_steps=1)
    fwd, _ = _batch_vs_own(model, short, stacked, problems, sids, dev)
    # a scene's row does not depend on where it sits in the batch
    rev = batch_mod.plan_batch_vmap(
        model, short, batch_mod.stack_problems(problems[::-1]))
    n = len(problems)
    pairs = [(batch_mod._index(fwd, k), batch_mod._index(rev, n - 1 - k))
             for k in range(n)]
    if any(_outcome(a) != _outcome(b) for a, b in pairs):
        raise AssertionError("scene batches: the reversed batch changes a "
                             "goal, verdict or steps")
    rev_gap = max(_traj_gap(a, b) for a, b in pairs)
    log(f"scene batches (optim_steps=10 extra_smooth_steps=1): the batch "
        f"in reverse order: the same goal, verdict and steps on every "
        f"scene, trajectories within {rev_gap:.3g} (bar 1e-5)")
    if rev_gap > 1e-5:
        raise AssertionError("scene batches: the reversed batch moves a "
                             "trajectory")
    _, wall, n_ops, by_name, _, _ = _profiled(
        lambda: batch_mod.plan_batch_vmap(model, cfg, stacked), dev,
        "plan_batch_vmap", cpu=False)
    one, wall1, n_ops1, by_name1, _, _ = _profiled(
        lambda: plan_mod.plan_fast(model, cfg, problems[1]), dev,
        "plan_fast suite scene 1", cpu=False)
    busy, busy1 = (sum(b.values()) / 1e3 for b in (by_name, by_name1))
    log(f"scene batches: device operations a loop step, plan_batch_vmap "
        f"of 8 scenes {n_ops / loop_steps:.0f} ({n_ops} in "
        f"{wall:.1f} ms under the profiler, device busy {busy:.2f} ms, "
        f"{100 * busy / wall:.1f}%) | plan_fast suite scene 1 "
        f"{n_ops1 / int(one.steps_used):.0f} ({n_ops1} in {wall1:.1f} ms, "
        f"device busy {busy1:.2f} ms, {100 * busy1 / wall1:.1f}%)")


def _importable(name: str) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None


def _video_frames(path: str) -> int:
    """Frames in a video that ``viz.render.write_video`` wrote: the
    ``.avi`` (read back with cv2) or its ``.npz`` fallback."""
    if path.endswith(".npz"):
        return len(np.load(path)["frames"])
    import cv2

    cap = cv2.VideoCapture(path)
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    finally:
        cap.release()


def _written(stem: str) -> str:
    found = [p for p in (stem, stem + ".npz") if os.path.exists(p)]
    if len(found) != 1:
        raise AssertionError(f"{stem}: expected one video file, found "
                             f"{found}")
    return found[0]


def _rollouts_since(n0: int) -> int:
    return kernels.rigid_rollout.launches - n0


def _viz_cli(dev, tmp, have_mpl):
    """The CLI's ``-f 0 -vc -vg --fast`` at full width, then the collision
    probe over the plan's rendered waypoints: ms per frame on the card,
    and the card against the CPU."""
    cfg = OMGConfig()
    t0 = time.time()
    if have_mpl:
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            res = cli_main(["-f", "0", "-vc", "-vg", "--fast"])
        finally:
            os.chdir(cwd)
        path = _written(os.path.join(tmp, "output_videos", "scene_0.avi"))
        frames = _video_frames(path)
    else:
        res = PlanningScene.synthetic(cfg, scene_id=0, n_obstacles=2,
                                      device=dev).step(fast=True)
        path, frames = None, 0
    wall = time.time() - t0
    if res is None or not np.isfinite(res.traj).all():
        raise AssertionError("viz CLI: no finite plan of scene 0")
    traj = np.asarray(res.traj)[::2]
    if have_mpl:
        log(f"viz CLI -f 0 -vc -vg --fast: {frames} frames (T = "
            f"{len(res.traj)}) written to {os.path.relpath(path, tmp)}, "
            f"{wall:.1f} s with the plan")
        if frames != len(traj):
            raise AssertionError(f"viz CLI: {frames} frames, want "
                                 f"{len(traj)}")
    else:
        log(f"viz CLI: frames not drawn because matplotlib is missing on "
            f"this machine; the plan ({wall:.1f} s) and the collision probe "
            f"over its {len(traj)} rendered waypoints run on the card")
    scene = PlanningScene.synthetic(cfg, scene_id=0, n_obstacles=2,
                                    device=dev)
    collision_probe(scene, traj[0])     # stage the scene and warm up
    _sync(dev)
    t0 = time.time()
    card = [tuple(a.cpu().numpy() for a in collision_probe(scene, q))
            for q in traj]
    probe_ms = (time.time() - t0) * 1e3 / len(traj)
    ref = PlanningScene.synthetic(cfg, scene_id=0, n_obstacles=2,
                                  device="cpu")
    cpu = [tuple(a.numpy() for a in collision_probe(ref, q)) for q in traj]
    gaps = [max(float(np.abs(a[i] - b[i]).max()) for a, b in zip(card, cpu))
            for i in range(3)]
    log(f"viz collision probe: {probe_ms:.3f} ms a frame on the card (FK, "
        f"points, potentials, one host read; {len(traj)} frames, "
        f"{card[0][0].shape[0] * card[0][0].shape[1]} points); card vs cpu "
        f"max|points| {gaps[0]:.2e} m (bar 1e-5), max|pot| {gaps[1]:.2e}, "
        f"max|grad| {gaps[2]:.2e} (bars 1e-4)")
    if not (gaps[0] <= 1e-5 and gaps[1] <= 1e-4 and gaps[2] <= 1e-4):
        raise AssertionError("viz: the collision probe on the card "
                             "disagrees with the cpu")


def _viz_gen_demos(dev, tmp):
    out = os.path.join(tmp, "demos")
    n0 = kernels.rigid_rollout.launches
    t0 = time.time()
    kept = gen_demos.generate(2, out, observations=True, device=dev)
    wall = time.time() - t0
    launches = _rollouts_since(n0)
    demos = sorted(f for f in os.listdir(out) if f.startswith("demo_"))
    log(f"gen_demos.generate(2, observations=True): kept {kept}, "
        f"{wall:.1f} s, rigid_rollout launches {launches}")
    if launches < 1 or len(demos) != kept:
        raise AssertionError("gen_demos: no rollout launched or demos "
                             "missing")
    for name in demos:
        d = np.load(os.path.join(out, name))
        traj, reward = d["traj"], int(d["scene_sim_reward"])
        lifted = float(d["scene_sim_lifted_m"])
        log(f"  {name}: traj {traj.shape}, sim_reward {reward}, "
            f"sim_lifted_m {lifted:.4f}, obs_rgb {d['obs_rgb'].shape}")
        if (traj.ndim != 2 or traj.shape[1] != 9
                or not np.isfinite(traj).all() or reward != 1
                or not lifted > 0.05):
            raise AssertionError(f"gen_demos: bad demo {name}")


def _viz_kitchen(dev):
    scene = kitchen.kitchen_scene(OMGConfig(silent=True), device=dev)
    steps = [("T", "mug"), ("P", [0.0, 0.25, 0.0]), ("E", 0)]
    n0 = kernels.rigid_rollout.launches
    t0 = time.time()
    results, reports = kitchen.run_script(scene, steps, execute=True)
    _sync(dev)
    wall = time.time() - t0
    launches = _rollouts_since(n0)
    for i, (kind, _, res) in enumerate(results):
        verdict = ("no plan" if res is None else
                   f"{'OK' if bool(res.flag) else 'FAIL'}, "
                   f"{int(res.steps_used)} steps")
        log(f"kitchen --exec {kind}: {verdict}  {reports.get(i, '')}")
    pick, place = reports.get(0), reports.get(1)
    if pick is None or place is None or launches != 2:
        raise AssertionError(f"kitchen --exec: {launches} rollouts, "
                             f"reports {sorted(reports)}")
    log(f"kitchen --exec: pick reward {pick['reward']} lifted "
        f"{pick['lifted_m']:.4f} m; place carried {place['carried']} error "
        f"{place['place_err_xy_m'] * 1e3:.1f} mm; {wall:.1f} s, "
        f"rigid_rollout launches {launches}")


def _viz_replay(tmp, have_mpl):
    n0 = kernels.rigid_rollout.launches
    path = os.path.join(tmp, "replay.avi")
    argv = ["--scenes", "1"] + (["--video", path] if have_mpl else [])
    t0 = time.time()
    report = phys_exec.main(argv)
    wall = time.time() - t0
    launches = _rollouts_since(n0)
    row = report["scenes"][0]
    if have_mpl:
        frames = _video_frames(_written(path))
        what = f"replay of {frames} frames"
    else:
        frames = None
        what = "replay not drawn because matplotlib is missing"
    log(f"phys_exec --scenes 1{' --video' if have_mpl else ''}: reward "
        f"{row.get('reward')}, {what}, {wall:.1f} s, rigid_rollout launches "
        f"{launches}")
    if launches != 1 or not row.get("executed") or frames == 0:
        raise AssertionError("phys_exec --video: no execution or replay")


def _viz_inspector(dev):
    import threading
    import urllib.request

    scene = PlanningScene.synthetic(OMGConfig(silent=True), scene_id=0,
                                    n_obstacles=2, device=dev)
    app = inspector.InspectorApp(scene)
    srv = inspector.make_server(app, port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def call(path, body=None):
        req = (urllib.request.Request(base + path) if body is None else
               urllib.request.Request(base + path, method="POST",
                                      data=json.dumps(body).encode()))
        t0 = time.time()
        with urllib.request.urlopen(req, timeout=300) as r:
            if r.status != 200:
                raise AssertionError(f"inspector {path}: {r.status}")
            data = r.read()
        return data, (time.time() - t0) * 1e3

    try:
        walls = []
        _, ms = call("/state")
        walls.append(f"/state {ms:.1f}")
        t = scene.env.target
        x, y = float(t.pose_mat[0, 3]), float(t.pose_mat[1, 3])
        out, ms = call("/plan", {"action": "pick", "x": x, "y": y})
        pick = json.loads(out)
        walls.append(f"/plan pick {ms:.1f} ({pick['message']})")
        if not pick["ok"]:
            raise AssertionError(f"inspector pick: {pick['message']}")
        out, ms = call("/plan", {"action": "place", "x": x + 0.08,
                                 "y": y - 0.1})
        walls.append(f"/plan place {ms:.1f} ({json.loads(out)['message']})")
        png, ms = call("/render.png")
        walls.append(f"/render.png {ms:.1f} ({len(png)} B)")
        out, ms = call("/state")
        state = json.loads(out)
        walls.append(f"/state after the plans {ms:.1f}")
        log("inspector request walls, ms: " + "; ".join(walls))
        if (png[:8] != b"\x89PNG\r\n\x1a\n" or len(state["ee_path"]) < 4
                or not state["goal_ghosts"]):
            raise AssertionError("inspector: bad /render.png or /state")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join()


def phase_viz_apps(dev):
    """Viz and apps on the card (phase 16)."""
    have_mpl, have_cv2 = _importable("matplotlib"), _importable("cv2")
    log(f"viz libraries here: matplotlib {have_mpl}, cv2 {have_cv2}")
    with tempfile.TemporaryDirectory() as tmp:
        _viz_cli(dev, tmp, have_mpl)
        _viz_gen_demos(dev, tmp)
        _viz_kitchen(dev)
        _viz_replay(tmp, have_mpl)
        _viz_inspector(dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()

    def timed(name, fn, *args):
        t0 = time.time()
        out = fn(*args)
        log(f"[phase {name}: {time.time() - t0:.1f} s]")
        return out

    timed("environment", phase_environment)
    timed("build", phase_build)
    entry = timed("kernels", phase_kernels, "cuda")
    plan_entries = timed("plan kernels", phase_plan_kernels, "cuda")
    plan_entries += timed("learner kernels", phase_learner_kernels, "cuda")
    plan_entries += timed("IK kernels", phase_ik_kernels, "cuda")
    plan_entries += timed("CHOMP kernels", phase_chomp_kernels, "cuda")
    timed("reference", phase_reference, "cuda")
    standard = timed("standard", phase_standard, "cuda")
    device = timed("profile", phase_profile, "cuda")
    for e in plan_entries:
        e["launches"] = device.get(e["name"], standard[e["name"]])
    entry["launches"] = timed("perception", phase_perception, "cuda")
    timed("suite runner", phase_suite_runner, "cuda")
    timed("bench", phase_bench)
    # phases from here on: the kernels each path must launch
    rollout = ("rigid_rollout",) + PLAN_KERNELS
    expect = {"fused": PLAN_KERNELS,
              "chain": ("sdf_query", "joint_limit", "chomp_obstacle",
                        "chomp_step"),
              "tasks": PLAN_KERNELS,
              "physics": ("rigid_rollout", "panda_fk"), "serve": rollout,
              "scale-out": PLAN_KERNELS, "viz and apps": rollout,
              "scene batches": PLAN_KERNELS}
    entries = [entry]
    for name, fn in (("fused", phase_fused), ("chain", phase_chain),
                     ("tasks", phase_tasks), ("physics", phase_physics),
                     ("serve", phase_serve), ("scale-out", phase_scaleout),
                     ("viz and apps", phase_viz_apps),
                     ("scene batches", phase_scene_batches)):
        reset_counts()
        out = timed(name, fn, "cuda")
        if name == "physics":
            entries.append(out)
        _check_launches(name, expect[name])
    entries += plan_entries
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
