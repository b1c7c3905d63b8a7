"""Do the CHOMP kernels of this checkout give the bits of another
checkout's?  Builds ``chomp_obstacle`` and ``chomp_step``
(``omg_planner_torch/csrc/chomp_cost.cu``) from this checkout's source and
from another checkout's (for example the parent commit, unpacked with
``git archive`` into a directory that ``.gitignore`` lists): with the
package's nvcc flags for the card, or with ``--emu`` with g++ against
``csrc/cuda_emu.h`` on the CPU.  Runs both libraries on the same inputs:

* every call of suite scene 1's plan, as ``chip_smoke.py::
  capture_chomp_calls`` captures them (planned by this checkout);
* phase 3e's seeded rows (``chip_smoke.py::seeded_chomp_inputs``) at
  S = 1 and 8.

Bit for bit: ``chomp_obstacle``'s k-th value, selection mask, collision
count and obs_cost, ``chomp_step``'s trajectory and flags.  ``obs_grad``
and the packed floats (the ``CostInfo`` scalars, ``cost_traj``), which
each kernel sums in its own order, are held to phase 3e's bars against
the plain version in float64 (``chip_smoke.py::_near_f64``), and their
largest difference between the two libraries is printed.

    python3 scripts/chomp_kernels_same_bits.py OTHER_CHECKOUT [--emu]

Both libraries are launched with this checkout's packers
(``ops/kernels.py``), so the other source must take the same C
arguments.  Prints one line a case and ``CHOMP KERNEL BITS: SAME``, or
exits 1.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from omg_planner_torch.ops import kernels  # noqa: E402

ENTRIES = ("omg_chomp_obstacle", "omg_chomp_step")


def build(checkout: str, out: str, emu: bool) -> dict:
    """The two C entry points built from ``checkout``'s ``chomp_cost.cu``."""
    src = os.path.join(checkout, "omg_planner_torch", "csrc", "chomp_cost.cu")
    if emu:
        cmd = [shutil.which("g++"), "-std=c++20", "-O1", "-shared", "-fPIC",
               "-DOMG_CUDA_EMU", "-x", "c++", src, "-o", out]
    else:
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, src]
    subprocess.run(cmd, check=True)
    lib = ctypes.CDLL(out)
    fns = {}
    for name in ENTRIES:
        fn = getattr(lib, name)
        fn.argtypes = kernels._LIBS["chomp_cost"][2][name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def run(fns, kind: str, args: list, dev: str) -> tuple:
    """One launch of ``kind`` on its operator's arguments: ``chomp_obstacle``
    (obs_cost, obs_grad, collide, k-th value, mask), ``chomp_step`` (xi,
    packed floats, flags)."""
    if kind == "chomp_obstacle":
        keep, outs, ptrs, dims, consts = kernels._chomp_obstacle_pack(
            *args, selection=True)
    else:
        keep, outs, ptrs, dims, consts = kernels._chomp_step_pack(*args)
    stream = torch.cuda.current_stream().cuda_stream if dev == "cuda" \
        else None
    status = fns[f"omg_{kind}"](ptrs, dims, consts, stream)
    if status != 0:
        raise RuntimeError(f"{kind} launch failed: error {status}")
    cs._sync(dev)
    del keep
    return outs


def compare(kind: str, what: str, args: list, mine, other) -> bool:
    """The bit-for-bit outputs equal, the others within phase 3e's bars;
    prints the case's line."""
    if kind == "chomp_obstacle":
        exact = {"obs_cost": 0, "collide": 2, "kth": 3, "mask": 4}
        bars = kernels.chomp_obstacle_plain(*args)[1:2], \
            kernels.chomp_obstacle_plain(*cs._f64_args(args))[1:2]
        got, names = [mine[1]], ("obs_grad",)
    else:
        exact = {"xi": 0, "flags": 2}
        plain = kernels.chomp_step_plain(*args)
        plain64 = kernels.chomp_step_plain(*cs._f64_args(args))
        got = cs._step_outputs(mine)[1:]
        bars = cs._step_outputs(plain)[1:], cs._step_outputs(plain64)[1:]
        names = cs.STEP_OUTPUTS[1:]
    differ = [name for name, i in exact.items()
              if not cs._same_bits(mine[i], other[i])]
    cs._near_f64(got, *bars, names, f"{kind} {what}")
    # obs_grad, or the packed floats: output 1 of either kernel
    gap = float((mine[1].double() - other[1].double()).abs()
                .nan_to_num().max())
    print(f"{kind} {what}: {', '.join(exact)} "
          f"{'bit-equal' if not differ else 'DIFFERENT: ' + ', '.join(differ)}"
          f"; {'obs_grad' if kind == 'chomp_obstacle' else 'packed floats'} "
          f"within phase 3e's bars, max|this - other| {gap:.3e}", flush=True)
    return not differ


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--emu", action="store_true",
                    help="build with g++ against cuda_emu.h, run on the CPU")
    args = ap.parse_args()
    dev = "cpu" if args.emu else "cuda"
    out_dir = os.path.join(ROOT, "build", "chomp_kernels_same_bits",
                           "emu" if args.emu else "card")
    os.makedirs(out_dir, exist_ok=True)
    libs = {side: build(path, os.path.join(out_dir, f"libchomp_{side}.so"),
                        args.emu)
            for side, path in (("this", ROOT),
                               ("other", os.path.abspath(args.other)))}
    if not args.emu:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        print(card, flush=True)
    _, calls = cs.capture_chomp_calls(dev)
    obs8, step8 = cs.seeded_chomp_inputs(dev, calls)
    cases = [("chomp_obstacle", f"suite scene 1 call {i}", a)
             for i, a in enumerate(calls["obs"])]
    cases += [("chomp_step", f"suite scene 1 call {i}", a)
              for i, a in enumerate(calls["step"])]
    cases += [("chomp_obstacle", "seeded S=1", cs._rows_of(obs8, 0, 8, 8)),
              ("chomp_obstacle", "seeded S=8", obs8),
              ("chomp_step", "seeded S=1", cs._rows_of(step8, 0, 12, 8)),
              ("chomp_step", "seeded S=8", step8)]
    same = True
    for kind, what, a in cases:
        mine = run(libs["this"], kind, a, dev)
        other = run(libs["other"], kind, a, dev)
        same &= compare(kind, what, a, mine, other)
    print(f"{len(cases)} cases on "
          f"{'the CPU (g++, cuda_emu.h)' if args.emu else 'the card'}")
    print(f"CHOMP KERNEL BITS: {'SAME' if same else 'DIFFERENT'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
