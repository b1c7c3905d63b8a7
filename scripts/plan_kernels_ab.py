"""Before and after on one card, in one call: this checkout against another
(for example the parent commit, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists).

    python3 scripts/plan_kernels_ab.py OTHER_CHECKOUT [OUT_DIR] [PAIRS]
        [--phases 3b|3c|3d|3e|5-6|build]

Runs each checkout's own ``chip_smoke.py`` phases in a fresh process, in
the order other, this, this, other, ... (PAIRS pairs, default 2):

* ``3b`` (default): ``phase_plan_kernels``, the plan kernels (``panda_fk``,
  ``sdf_query``) built from the checkout's own sources, its wrappers, its
  checks; each run followed by the cold-start probe of this checkout's
  ``chip_smoke.COLD_PROBE`` on that checkout's package.  Reads, for every
  shape, the kernel's time (50 launches in one CUDA graph), its bound, the
  time through the wrapper (or the vmap) and the wrapper's host time a
  call.
* ``3c``: ``phase_learner_kernels``, the loop kernels (``md_update``,
  ``joint_limit``) built from the checkout's own sources, its wrappers,
  its checks.  Reads, for every shape, the kernel's time (50 launches in
  one CUDA graph), its bound, the floor (an empty kernel at the same grid,
  50 in one graph), the time through the wrapper and the wrapper's host
  time a call with its split (dispatch, checks, allocation, launch);
  what a checkout's phase does not print is left out.  Each side times
  its own phase's inputs: suite scene 1's calls are the same on both
  sides, seeded rows only where both checkouts draw them alike.
* ``3d``: ``phase_ik_kernels``, the IK kernels (``ik_prefilter``,
  ``ik_chain``) built from the checkout's own sources, its wrappers, its
  checks, on the calls of suite scenes 0-7's goal-set builds and a wave
  of scenes 0-3 as that checkout's ``ops/ik.py`` makes them.  Reads, for
  each kernel at suite scene 1 and the wave, its time (50 launches in one
  CUDA graph), the floor (an empty kernel at its grid), the time through
  the wrapper, the bound and the wrapper's host time a call.
* ``3e``: ``phase_chomp_kernels``, the CHOMP kernels (``chomp_obstacle``,
  ``chomp_step``) built from the checkout's own sources, its wrappers, its
  checks, on the calls of suite scene 1's plan and seeded rows at S = 8.
  Reads, for each kernel at suite scene 1 and S = 8, its time (50
  launches in one CUDA graph), the floor, the time through the wrapper,
  the bound and the wrapper's host time a call.  Both checkouts must have
  the phase (from this commit on).
* ``5-6``: ``phase_standard`` and ``phase_profile``, three full-width suite
  plans, then suite scene 1's plan under ``torch.profiler``.  Reads each
  staging's and plan's wall and host syncs, and the profiled plan's wall,
  device busy time and device operations a step.
* ``build``: :data:`BUILD_PROBE` (this script's, so it needs nothing of
  the checkout's ``chip_smoke.py`` but ``phase_environment``) on that
  checkout's package: suite scenes 0-2's goal-set builds at full width,
  each built once, then rebuilt warm 5 times.  Reads each scene's median
  warm build wall and its host syncs.

Each run's output goes to OUT_DIR (default ``build/plan_kernels_ab/
<phases>``) as ``<i>-<side>.out``.  Prints every run's figures, then for
each figure and side the median over the side's runs (and, for 3b, each
side's cold first calls and the modules they imported).
"""

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

KERNEL_LINE = re.compile(
    r"^(panda_fk N=\d+|sdf_query \w+ B=\d+ P=\d+(?: \(vmap\))?): kernel "
    r"([\d.]+) ms \(graph of 50\), through the (?:wrapper|vmap) ([\d.]+) ms "
    r"a call.* bound ([\d.]+) ms .* wrapper host ([\d.]+) us a call")
LOOP_LINE = re.compile(
    r"^((?:md_update|joint_limit) .+?): kernel ([\d.]+) ms \(graph of 50\),"
    r"(?: floor ([\d.]+) ms \([^)]*\),)?"
    r"(?: through the wrapper ([\d.]+) ms a call,)? plain [\d.]+ ms, bound "
    r"([\d.]+) ms .* wrapper host ([\d.]+) us a call"
    r"(?: \(dispatch ([-\d.]+), checks ([\d.]+), allocation ([\d.]+), "
    r"launch ([\d.]+)\))?")
IK_LINE = re.compile(
    r"^((?:ik_prefilter|ik_chain) (?:suite scene 1|wave of 4)"
    r"|(?:chomp_obstacle|chomp_step) (?:suite scene 1 \(S=1\)|seeded S=8)"
    r"): kernel "
    r"([\d.]+) ms \(graph of 50\), floor ([\d.]+) ms \([^)]*\), through "
    r"the wrapper ([\d.]+) ms a call, plain [\d.]+ ms, bound ([\d.]+) ms "
    r".* wrapper host ([\d.]+) us a call")
PLAN_LINE = re.compile(r"^standard plan suite scene (\d+): .* \| stage "
                       r"([\d.]+) ms, (\d+) host syncs \| plan ([\d.]+) "
                       r"ms, (\d+) host syncs")
BUILD_LINE = re.compile(r"^warm build suite scene (\d+): ([\d.]+) ms .*, "
                        r"(\d+) host syncs")
# the warm goal-set builds of suite scenes 0-2 (each scene built once
# first), in either checkout's package
BUILD_PROBE = """
import os, time
import torch
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.planner.scene import PlanningScene
from omg_planner_torch.utils.sync import SYNCS
cfg = OMGConfig(silent=True)
for i in (0, 1, 2):
    sc = PlanningScene.from_npz(
        cfg, os.path.join("data", "suite_v2", f"scene_{i}.npz"),
        device="cuda")
    sc.build_problem()
    walls = []
    for _ in range(5):
        sc._staged = None
        torch.cuda.synchronize()
        SYNCS.count = 0
        t0 = time.perf_counter()
        sc.build_problem()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"warm build suite scene {i}: {sorted(walls)[2]:.2f} ms (median "
          f"of 5: {[round(w, 2) for w in walls]}), {SYNCS.count} host "
          "syncs")
"""
PROFILE_LINE = re.compile(r"^profile standard plan suite scene 1 .*: wall "
                          r"([\d.]+) ms under the profiler, device busy "
                          r"([\d.]+) ms .* ([\d.]+) a plan step")


def read_kernels(line: str) -> dict:
    m = KERNEL_LINE.match(line)
    if not m:
        return {}
    ms, wrapped, bound, host = map(float, m.groups()[1:])
    shape = m.group(1)
    return {f"{shape} graph ms": ms, f"{shape} share of bound": bound / ms,
            f"{shape} wrapper ms": wrapped, f"{shape} host us": host}


def read_loop_kernels(line: str) -> dict:
    m = LOOP_LINE.match(line)
    if not m:
        return {}
    shape = m.group(1)
    names = ("graph ms", "floor ms", "wrapper ms", "bound ms", "host us",
             "dispatch us", "checks us", "allocation us", "launch us")
    out = {f"{shape} {k}": float(v)
           for k, v in zip(names, m.groups()[1:]) if v is not None}
    out[f"{shape} share of bound"] = (out[f"{shape} bound ms"]
                                      / out[f"{shape} graph ms"])
    return out


def read_ik_kernels(line: str) -> dict:
    m = IK_LINE.match(line)
    if not m:
        return {}
    shape = m.group(1)
    names = ("graph ms", "floor ms", "wrapper ms", "bound ms", "host us")
    out = {f"{shape} {k}": float(v) for k, v in zip(names, m.groups()[1:])}
    out[f"{shape} share of bound"] = (out[f"{shape} bound ms"]
                                      / out[f"{shape} graph ms"])
    return out


def read_plan(line: str) -> dict:
    m = PLAN_LINE.match(line)
    if m:
        i = m.group(1)
        return dict(zip((f"scene {i} stage ms", f"scene {i} stage syncs",
                         f"scene {i} plan ms", f"scene {i} host syncs"),
                        map(float, m.groups()[1:])))
    m = PROFILE_LINE.match(line)
    if m:
        return dict(zip(("profiled wall ms", "device busy ms",
                         "device ops a step"), map(float, m.groups())))
    return {}


def read_build(line: str) -> dict:
    m = BUILD_LINE.match(line)
    if not m:
        return {}
    return {f"scene {m.group(1)} warm build ms": float(m.group(2)),
            f"scene {m.group(1)} warm build host syncs": float(m.group(3))}


# --phases -> (the chip_smoke phases after phase_environment, the line
# reader, whether to probe the cold start)
PHASES = {
    "3b": ("cs.phase_plan_kernels('cuda')", read_kernels, True),
    "3c": ("cs.phase_learner_kernels('cuda')", read_loop_kernels, False),
    "3d": ("cs.phase_ik_kernels('cuda')", read_ik_kernels, False),
    "3e": ("cs.phase_chomp_kernels('cuda')", read_ik_kernels, False),
    "5-6": ("cs.phase_standard('cuda'); cs.phase_profile('cuda')", read_plan,
            False),
    "build": (f"exec({BUILD_PROBE!r})", read_build, False),
}


def run_phases(root: str, phases: str) -> tuple:
    """({figure: value}, output) of one run of ``root``'s phases."""
    code, read, _ = PHASES[phases]
    out = subprocess.run(
        [sys.executable, "-c",
         f"import chip_smoke as cs; cs.phase_environment(); {code}"],
        cwd=root, capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise RuntimeError(f"phases {phases} of {root} failed:\n"
                           f"{out.stderr[-3000:]}")
    rows = {}
    for line in out.stdout.splitlines():
        rows.update(read(line))
    return rows, out.stdout


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("out_dir", nargs="?")
    ap.add_argument("pairs", nargs="?", type=int, default=2)
    ap.add_argument("--phases", choices=sorted(PHASES), default="3b")
    args = ap.parse_args()
    other = os.path.abspath(args.other)
    out_dir = args.out_dir or os.path.join(ROOT, "build", "plan_kernels_ab",
                                           args.phases)
    os.makedirs(out_dir, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    order = []
    for p in range(args.pairs):
        order += ["other", "this"] if p % 2 == 0 else ["this", "other"]
    runs = {"other": [], "this": []}
    colds = {"other": [], "this": []}
    for i, side in enumerate(order, 1):
        root = other if side == "other" else ROOT
        rows, text = run_phases(root, args.phases)
        if PHASES[args.phases][2]:
            cold = cs.cold_start(root)
            colds[side].append(cold)
            text += json.dumps(cold) + "\n"
        with open(os.path.join(out_dir, f"{i}-{side}.out"), "w") as f:
            f.write(text)
        runs[side].append(rows)
        print(f"run {i} {side}: {rows}", flush=True)
    for key in runs["this"][0]:
        cells = []
        for side in ("other", "this"):
            vals = [r[key] for r in runs[side] if key in r]
            cells.append(f"{side}: median {statistics.median(vals)} runs "
                         f"{vals}" if vals else f"{side}: not printed")
        print(f"{key}: " + "; ".join(cells))
    for side, side_colds in colds.items():
        if side_colds:
            firsts = [c["first"] for c in side_colds]
            print(f"cold start {side}: first panda_fk "
                  f"{[round(f[0], 4) for f in firsts]} s, first sdf_query "
                  f"{[round(f[1], 4) for f in firsts]} s, imported "
                  f"{sorted({m for c in side_colds for m in c['heavy']})}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
