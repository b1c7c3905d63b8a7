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
   full width, which must launch ``min_dist_grid``.

The line before the last is a JSON object listing every kernel with its
launches on the main path, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from omg_planner_torch import interop
from omg_planner_torch.__main__ import observe_obstacles, perception_plan
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.ops import kernels
from omg_planner_torch.ops.pointsdf import grid_cells, grid_layout
from omg_planner_torch.planner import plan as plan_mod
from omg_planner_torch.planner.scene import PlanningScene
from omg_planner_torch.utils.sync import SYNCS

ROOT = os.path.dirname(os.path.abspath(__file__))
# H100 SXM published peaks (NVIDIA data sheet; at the 700 W limit)
FP32_FLOPS = 67e12
HBM_BYTES = 3.35e12
# flop-equivalents per (cell, point) pair of min_dist_grid: four fp32
# issue slots (3 FFMA + 1 FMNMX) at the FFMA rate of 2 flops a slot
MIN_DIST_FLOPS_PER_PAIR = 8
# the observed cloud's point cap (``__main__.observe_obstacles``)
CAP_POINTS = 3072
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


def clocks_under_load(fn) -> str:
    """``clocks.sm, power.draw, power.limit`` from nvidia-smi, sampled while
    runs of 50 calls of ``fn`` keep the card busy."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
         "--format=csv,noheader"], stdout=subprocess.PIPE, text=True)
    while proc.poll() is None:
        for _ in range(50):
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


def check_traj(res, model, what):
    traj = np.asarray(res.traj)
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
    check_traj(res, scene.model, what)
    verdict = "SUCCESS" if bool(res.flag) else "FAIL"
    log(f"{what}: {verdict} steps {int(res.steps_used)} valid goals "
        f"{scene._n_valid_goals} | stage {stage_ms:.1f} ms, {stage_syncs} "
        f"host syncs | plan {plan_ms:.1f} ms, {plan_syncs} host syncs")
    return res


def phase_standard(dev):
    cfg = OMGConfig(silent=True)
    for i in (0, 1, 2):
        path = os.path.join(ROOT, "data", "suite_v2", f"scene_{i}.npz")
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
    path = os.path.join(ROOT, "data", "suite_v2", "scene_1.npz")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.time()
    phase_environment()
    phase_build()
    entry = phase_kernels("cuda")
    phase_reference("cuda")
    phase_standard("cuda")
    phase_profile("cuda")
    entry["launches"] = phase_perception("cuda")
    log(f"total {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
