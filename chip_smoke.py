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
4. reference: a small plan staged on the CPU, planned on the CPU and on
   the card — same goal, same verdict, trajectories within 2e-3;
5. the standard plan at the full ``OMGConfig()`` width on three
   ``data/suite_v2`` scenes (no kernel on this path), with wall time and
   host syncs per plan;
6. a ``torch.profiler`` trace of one standard plan: the device's busy
   share and its operations per plan (fails if it records none);
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
    budget with ``goal_set_proj=False`` on the card and on the CPU: same
    verdict and steps, trajectories within 2e-3;
12. the task layer on synthetic scene 0 at full width: a grasp plan
    (``plan_to_target``), then ``place_target`` (flag, steps, achieved
    pose);
13. physics execution on suite scene 0 at full width: its plan executed
    by ``execute_plan`` (one ``rigid_rollout`` launch, no other kernel);
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
    the one card, which must print ``MULTIHOST DEMO: PASS``.

Each phase from 10 on runs with the launch counts set to 0 and checks
them after: ``rigid_rollout`` must launch on the physics and service
phases and no kernel elsewhere; ``min_dist_grid`` launches only in phase 7.
The line before the last is a JSON object listing every kernel with its
launches on its path, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from omg_planner_torch import interop
from omg_planner_torch.__main__ import observe_obstacles, perception_plan
from omg_planner_torch.apps import serve
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.io.assets import pose_at
from omg_planner_torch.models import chain
from omg_planner_torch.ops import kernels
from omg_planner_torch.ops import sdf as sdf_mod
from omg_planner_torch.ops.chomp import CostParams, GoalSet
from omg_planner_torch.ops.pointsdf import grid_cells, grid_layout
from omg_planner_torch.parallel import batch as batch_mod
from omg_planner_torch.parallel import multihost
from omg_planner_torch.physics import executor, rigid
from omg_planner_torch.physics.panda_ctrl import HOME_POSE, NativePanda
from omg_planner_torch.planner import plan as plan_mod
from omg_planner_torch.planner import tasks
from omg_planner_torch.planner.runner import SuiteRunner
from omg_planner_torch.planner.scene import PlanningScene
from omg_planner_torch.utils.sync import SYNCS
from omg_planner_torch.utils.timing import RETRIES

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


def reset_counts():
    for fn in kernels.KERNELS.values():
        fn.launches = 0
    SYNCS.count = 0


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


def phase_build():
    t0 = time.time()
    logs = kernels.build(extra_flags=("-Xptxas", "-v"))
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
    if res is None:
        raise AssertionError(f"{what}: empty goal set")
    check_traj(res.traj, scene.model, what)
    verdict = "SUCCESS" if bool(res.flag) else "FAIL"
    log(f"{what}: {verdict} steps {int(res.steps_used)} valid goals "
        f"{scene._n_valid_goals} | stage {stage_ms:.1f} ms, {stage_syncs} "
        f"host syncs | plan {plan_ms:.1f} ms, {plan_syncs} host syncs")
    return res


def phase_standard(dev):
    cfg = OMGConfig(silent=True)
    for i in (0, 1, 2):
        path = os.path.join(SUITE, f"scene_{i}.npz")
        scene = PlanningScene.from_npz(cfg, path, device=dev)
        reset_counts()
        _timed_plan(scene, dev, f"standard plan suite scene {i}")
        if any(fn.launches for fn in kernels.KERNELS.values()):
            raise AssertionError("a kernel launched on the standard path")


def phase_profile(dev):
    """Where one standard plan's time goes: ``torch.profiler`` over
    ``step(fast=True)`` of suite scene 1 (goal set already staged), for
    the device's busy share and the device operations per plan."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = OMGConfig(silent=True)
    path = os.path.join(SUITE, "scene_1.npz")
    scene = PlanningScene.from_npz(cfg, path, device=dev)
    scene.step(fast=True)  # stages the goal set and warms up
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        res = scene.step(fast=True)
        _sync(dev)
        wall_ms = (time.time() - t0) * 1e3
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ops:
        raise AssertionError(
            f"profile standard plan suite scene 1: wall {wall_ms:.1f} ms, "
            "but the profiler recorded no device operations")
    by_name = {}
    for e in ops:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    log(f"profile standard plan suite scene 1 ({int(res.steps_used)} steps):"
        f" wall {wall_ms:.1f} ms under the profiler, device busy "
        f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), {len(ops)} "
        f"device operations")
    for name, us in top:
        log(f"  {us / 1e3:8.3f} ms  {name[:100]}")


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
    launches = kernels.min_dist_grid.launches
    log(f"min_dist_grid launches in the perception run: {launches}")
    if torch.device(dev).type == "cuda" and launches == 0:
        raise AssertionError("perception plan never launched min_dist_grid")
    return launches


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
        if any(fn.launches for fn in kernels.KERNELS.values()):
            raise AssertionError("a kernel launched on the suite path")
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


def _chain_problem(model, cfg, start, end):
    """A pillar beside the arm; a fixed goal configuration."""
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
        scene=sdf_mod.combine_sdfs([box.penalize_inside(5.0)], d),
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
    budget (no early termination)."""
    cfg = OMGConfig(silent=True, goal_set_proj=False, use_standoff=False,
                    pre_terminate=False)
    start = [0.0, -1.2, 1.6, -0.5, 0.0, 0.0]
    end = [1.2, -0.9, 1.2, -0.8, 0.6, 0.3]
    out = {}
    for where in (dev, "cpu"):
        model = _ur_chain(where)
        problem = _chain_problem(model, cfg, start, end)
        _sync(where)
        SYNCS.count = 0
        t0 = time.time()
        res = plan_mod.plan_fast(model, cfg, problem)
        _sync(where)
        out[where] = res
        log(f"chain plan (UR-like, 6 dof, {cfg.total_steps}-step budget) on "
            f"{where}: {'SUCCESS' if bool(res.flag) else 'FAIL'} steps "
            f"{int(res.steps_used)}, collide {float(res.info.collide):.0f}, "
            f"{(time.time() - t0) * 1e3:.1f} ms, {SYNCS.count} host syncs")
    a, b = out[dev], out["cpu"]
    diff = float((a.traj.cpu() - b.traj).abs().max())
    log(f"chain plan: max|traj {dev} - cpu| {diff:.2e}")
    if (a.traj.shape != (cfg.timesteps, 6) or bool(a.flag) != bool(b.flag)
            or int(a.steps_used) != int(b.steps_used) or not diff <= 2e-3):
        raise AssertionError(f"chain plan on {dev} disagrees with the cpu")


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
                             "once and nothing else")
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
    timed("reference", phase_reference, "cuda")
    timed("standard", phase_standard, "cuda")
    timed("profile", phase_profile, "cuda")
    entry["launches"] = timed("perception", phase_perception, "cuda")
    timed("suite runner", phase_suite_runner, "cuda")
    timed("bench", phase_bench)
    # phases from here on: the kernels each path must launch
    expect = {"fused": (), "chain": (), "tasks": (),
              "physics": ("rigid_rollout",), "serve": ("rigid_rollout",),
              "scale-out": ()}
    entries = [entry]
    for name, fn in (("fused", phase_fused), ("chain", phase_chain),
                     ("tasks", phase_tasks), ("physics", phase_physics),
                     ("serve", phase_serve), ("scale-out", phase_scaleout)):
        reset_counts()
        out = timed(name, fn, "cuda")
        if name == "physics":
            entries.append(out)
        counts = {k: fn_.launches for k, fn_ in kernels.KERNELS.items()}
        log(f"[{name} launches: {counts}]")
        for k, n in counts.items():
            if (k in expect[name]) != (n > 0):
                raise AssertionError(f"{k} launched {n} times on the {name} "
                                     "path")
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
