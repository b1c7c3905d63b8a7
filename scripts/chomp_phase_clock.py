"""Where a row of the CHOMP kernels spends its time: ``clock64()`` stamps at
each phase boundary of ``chomp_obstacle`` and ``chomp_step``
(``omg_planner_torch/csrc/chomp_cost.cu``).

    python3 scripts/chomp_phase_clock.py [OTHER_CHECKOUT] [--emu]
        [--launches N]

Builds this checkout's ``chomp_cost.cu`` (and OTHER_CHECKOUT's, for
example the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists) with ``-DOMG_CHOMP_CLOCK``, a macro that only
this script defines: the source's ``OMG_STAMP(kernel, slot)`` calls then
make thread 0 of each block write ``clock64()`` to a device buffer
(:data:`PRELUDE`, inserted into a copy of the source under ``build/``;
the production build keeps the stamps empty).  A source without the
stamps (``chomp_cost.cu`` as of the first CHOMP kernels) gets them at
the anchors of :data:`OLD_STAMPS`.  Both libraries are launched through
this checkout's packers (``ops/kernels.py``), so the other source must
take the same C arguments.

Cases: suite scene 1's middle ``chomp_obstacle`` and ``chomp_step`` calls
of its plan (S = 1, as ``chip_smoke.py::capture_chomp_calls`` captures
them) and phase 3e's seeded rows (S = 8).  Each side runs N launches of
each case (default 20), in the order other, this, this, other; for each
phase the median over launches (and rows) of the cycles since the
previous stamp, and the row's total from entry to the last stamp, in
cycles and in us at the SM clock read under load.  A stamp is thread 0's
view: after a barrier it is the block's, inside a per-warp phase it is
warp 0's.  With ``--emu`` (g++ against ``csrc/cuda_emu.h``, on the CPU)
the clock is the host's in ns and says only that the stamps are placed.
"""

import argparse
import ctypes
import os
import shutil
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from omg_planner_torch.ops import kernels  # noqa: E402

ROWS, SLOTS = 64, 16
# the stamp buffer and OMG_STAMP, inserted after the source's includes
PRELUDE = r"""
// the phase probe: thread 0 of block b < 64 writes clock64() at phase
// boundary `slot` of kernel `k` (0: chomp_obstacle, 1: chomp_step)
constexpr int kClockRows = 64, kClockSlots = 16;
__device__ long long omg_chomp_clock[2][kClockRows][kClockSlots];
#define OMG_STAMP(k, slot)                              \
  do {                                                  \
    if (threadIdx.x == 0 && blockIdx.x < kClockRows)    \
      omg_chomp_clock[k][blockIdx.x][slot] = clock64(); \
  } while (0)
"""
# the stamps' reader, appended to the source: copies them out, zeroes them
READER = r"""
extern "C" int omg_chomp_clock_read(long long* out) {
#ifdef OMG_CUDA_EMU
  memcpy(out, omg_chomp_clock, sizeof omg_chomp_clock);
  memset(omg_chomp_clock, 0, sizeof omg_chomp_clock);
  return 0;
#else
  cudaError_t err =
      cudaMemcpyFromSymbol(out, omg_chomp_clock, sizeof omg_chomp_clock);
  void* p = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&p, omg_chomp_clock);
  if (err == cudaSuccess) err = cudaMemset(p, 0, sizeof omg_chomp_clock);
  return static_cast<int>(err);
#endif
}
"""
INCLUDES = "#include <stdint.h>\n"
# (text, the same text with its stamp) in the first CHOMP kernels' source
# (one warp a timestep), where each text occurs once
OLD_STAMPS = [
    ("    chomp_obstacle_kernel(ObsPtrs A, ObsDims Dm, ObsConsts C) {\n"
     "  OMG_DYNAMIC_SMEM(smem);\n",
     "    chomp_obstacle_kernel(ObsPtrs A, ObsDims Dm, ObsConsts C) {\n"
     "  OMG_DYNAMIC_SMEM(smem);\n  OMG_STAMP(0, 0);\n"),
    ("  __syncthreads();\n\n  // the softened potentials",
     "  __syncthreads();\n  OMG_STAMP(0, 1);\n\n  // the softened potentials"),
    ("  const float kth = topk ? kth_largest(",
     "  OMG_STAMP(0, 2);\n  const float kth = topk ? kth_largest("),
    ("    __syncthreads();\n  }\n  return key_value(state[0]);",
     "    __syncthreads();\n    OMG_STAMP(0, 3 + pass);\n  }\n"
     "  return key_value(state[0]);"),
    ("    A.kth[row] = topk ? kth : __uint_as_float(0x7fc00000u);\n",
     "    A.kth[row] = topk ? kth : __uint_as_float(0x7fc00000u);\n"
     "  OMG_STAMP(0, 7);\n"),
    ("    __syncwarp();\n    for (int l = lane; l < L; l += 32) {",
     "    __syncwarp();\n    OMG_STAMP(0, 8);\n"
     "    for (int l = lane; l < L; l += 32) {"),
    ("#pragma unroll\n    for (int d = 0; d < kMaxDof; ++d) {\n"
     "      if (d < D) {\n        const float s = warp_sum(acc[d]);",
     "    OMG_STAMP(0, 9);\n#pragma unroll\n"
     "    for (int d = 0; d < kMaxDof; ++d) {\n"
     "      if (d < D) {\n        const float s = warp_sum(acc[d]);"),
    ("        if (lane == 0) A.obs_grad[(row * T + t) * D + d] = s;\n"
     "      }\n    }\n",
     "        if (lane == 0) A.obs_grad[(row * T + t) * D + d] = s;\n"
     "      }\n    }\n    OMG_STAMP(0, 10);\n"),
    ("A.obs_cost[(row * T + t) * L + l] = s;\n    }\n  }\n}",
     "A.obs_cost[(row * T + t) * L + l] = s;\n    }\n  }\n"
     "  __syncthreads();\n  OMG_STAMP(0, 12);\n}"),
    ("StepConsts C) {\n  OMG_DYNAMIC_SMEM(smem);\n",
     "StepConsts C) {\n  OMG_DYNAMIC_SMEM(smem);\n  OMG_STAMP(1, 0);\n"),
    ("  __syncthreads();\n\n  // the velocity rows",
     "  __syncthreads();\n  OMG_STAMP(1, 1);\n\n  // the velocity rows"),
    ("  __syncthreads();\n\n  for (int i = tid; i <= T; i += nt) {",
     "  __syncthreads();\n  OMG_STAMP(1, 2);\n\n"
     "  for (int i = tid; i <= T; i += nt) {"),
    ("  __syncthreads();\n\n  if (tid >= 32) return;",
     "  __syncthreads();\n  OMG_STAMP(1, 3);\n\n  if (tid >= 32) return;"),
    ("    f[3] = over;\n  }\n}",
     "    f[3] = over;\n  }\n  OMG_STAMP(1, 4);\n}"),
]
# each slot's phase (the time since the previous stamp), by source
PHASES = {
    "stamped": {
        0: {1: "tables, band", 2: "soften, collisions",
            3: "radix pass 0", 4: "radix pass 1", 5: "radix pass 2",
            6: "radix pass 3", 7: "copy wait", 8: "finiteness, compaction",
            9: "points (round 0)", 10: "dof sums (round 0)",
            11: "later rounds", 12: "link sums, quirks", 13: "to the end"},
        1: {1: "staging", 2: "band products, weights",
            3: "loss, update, partials", 4: "reductions, flags"}},
    "first": {
        0: {1: "tables", 2: "soften, collisions", 3: "radix pass 0",
            4: "radix pass 1", 5: "radix pass 2", 6: "radix pass 3",
            7: "k-th write", 8: "points (warp 0's timestep)",
            9: "link sums (warp 0)", 10: "dof butterflies (warp 0)",
            12: "other warps, quirks (to the end)"},
        1: {1: "staging", 2: "band products, weights", 3: "loss, update",
            4: "warp 0's reductions, flags"}},
}


def stamped_source(checkout: str, out_dir: str) -> tuple:
    """(path of ``checkout``'s ``chomp_cost.cu`` with :data:`PRELUDE`, its
    stamps and :data:`READER`, which of :data:`PHASES` names them)."""
    csrc = os.path.join(checkout, "omg_planner_torch", "csrc")
    with open(os.path.join(csrc, "chomp_cost.cu")) as f:
        text = f.read()
    kind = "stamped" if "OMG_STAMP(" in text else "first"
    if kind == "first":
        for anchor, stamped in OLD_STAMPS:
            if text.count(anchor) != 1:
                raise RuntimeError(f"{checkout}: anchor not found once: "
                                   f"{anchor[:60]!r}")
            text = text.replace(anchor, stamped)
    if text.count(INCLUDES) != 1:
        raise RuntimeError(f"{checkout}: no single '{INCLUDES.strip()}'")
    text = text.replace(INCLUDES, INCLUDES + PRELUDE, 1) + READER
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "chomp_cost.cu")
    with open(path, "w") as f:
        f.write(text)
    return path, kind


def build(checkout: str, out_dir: str, emu: bool) -> tuple:
    """(the C entry points of ``checkout``'s stamped library, its phase
    names)."""
    src, kind = stamped_source(checkout, out_dir)
    lib = os.path.join(out_dir, "libchomp_clock.so")
    csrc = os.path.join(checkout, "omg_planner_torch", "csrc")
    if emu:
        cmd = [shutil.which("g++"), "-std=c++20", "-O1", "-shared", "-fPIC",
               "-DOMG_CUDA_EMU", "-DOMG_CHOMP_CLOCK", f"-I{csrc}", "-x",
               "c++", src, "-o", lib]
    else:
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-DOMG_CHOMP_CLOCK",
               f"-I{csrc}", "-o", lib, src]
    subprocess.run(cmd, check=True)
    so = ctypes.CDLL(lib)
    fns = {}
    for name in ("omg_chomp_obstacle", "omg_chomp_step"):
        fn = getattr(so, name)
        fn.argtypes = kernels._LIBS["chomp_cost"][2][name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    fns["read"] = so.omg_chomp_clock_read
    fns["read"].argtypes = [ctypes.c_void_p]
    fns["read"].restype = ctypes.c_int
    return fns, PHASES[kind]


def launch(fns, kind: str, args, dev: str) -> np.ndarray:
    """One launch of ``kind`` (0 or 1) on its operator's arguments; its
    stamps [rows, slots] (0 where none was written)."""
    pack = kernels._chomp_obstacle_pack if kind == 0 else \
        kernels._chomp_step_pack
    name = "omg_chomp_obstacle" if kind == 0 else "omg_chomp_step"
    keep, outs, ptrs, dims, consts = pack(*args)
    stream = torch.cuda.current_stream().cuda_stream if dev == "cuda" \
        else None
    if fns[name](ptrs, dims, consts, stream) != 0:
        raise RuntimeError(f"{name} launch failed")
    cs._sync(dev)
    del keep
    buf = np.zeros((2, ROWS, SLOTS), np.int64)
    if fns["read"](buf.ctypes.data) != 0:
        raise RuntimeError("reading the stamps failed")
    return buf[kind, :dims[0]]


def phase_cycles(stamps: np.ndarray) -> dict:
    """{slot: cycles since the previous stamp, "total": entry to the last
    stamp} of one row's stamps."""
    seen = [s for s in range(SLOTS) if stamps[s] != 0]
    if not seen or seen[0] != 0:
        raise RuntimeError(f"no entry stamp: {stamps.tolist()}")
    out = {b: int(stamps[b] - stamps[a]) for a, b in zip(seen, seen[1:])}
    out["total"] = int(stamps[seen[-1]] - stamps[0])
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other", nargs="?")
    ap.add_argument("--emu", action="store_true",
                    help="build with g++ against cuda_emu.h, run on the CPU")
    ap.add_argument("--launches", type=int, default=20)
    args = ap.parse_args()
    dev = "cpu" if args.emu else "cuda"
    base = os.path.join(ROOT, "build", "chomp_phase_clock",
                        "emu" if args.emu else "card")
    sides = {"this": ROOT}
    if args.other:
        sides["other"] = os.path.abspath(args.other)
    libs = {side: build(path, os.path.join(base, side), args.emu)
            for side, path in sides.items()}
    if not args.emu:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        print(card, flush=True)
    _, calls = cs.capture_chomp_calls(dev)
    obs8, step8 = cs.seeded_chomp_inputs(dev, calls)
    cases = {
        (0, "suite scene 1 (S=1)"): calls["obs"][len(calls["obs"]) // 2],
        (1, "suite scene 1 (S=1)"): calls["step"][len(calls["step"]) // 2],
        (0, "seeded S=8"): obs8, (1, "seeded S=8"): step8}
    mhz = None
    if not args.emu:
        fns = libs["this"][0]
        smi = cs.clocks_under_load(lambda: launch(fns, 0, obs8, dev))
        print(f"clocks.sm, power.draw, power.limit under load: {smi}")
        mhz = float(smi.split()[0])
    order = ["this", "this"] if "other" not in sides else \
        ["other", "this", "this", "other"]
    got = {}
    for side in order:
        fns, _ = libs[side]
        for (kind, what), a in cases.items():
            for _ in range(args.launches):
                for row in launch(fns, kind, a, dev):
                    got.setdefault((side, kind, what), []).append(
                        phase_cycles(row))
    unit = "ns (emulated)" if args.emu else "cycles"
    for (kind, what) in cases:
        for side in sides:
            names = libs[side][1][kind]
            rows = got[(side, kind, what)]
            cells = []
            for slot in list(names) + ["total"]:
                vals = [r[slot] for r in rows if slot in r]
                if not vals:
                    continue
                med = statistics.median(vals)
                us = f" = {med / mhz:.3f} us" if mhz else ""
                label = names.get(slot, "total") if slot != "total" \
                    else "total"
                cells.append(f"{label} {med:.0f}{us}")
            print(f"{('chomp_obstacle', 'chomp_step')[kind]} {what} {side} "
                  f"({len(rows)} rows, median {unit}): " + "; ".join(cells),
                  flush=True)
    print("CHOMP PHASE CLOCK: DONE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
