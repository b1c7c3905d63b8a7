"""Do the loop kernels of this checkout give the bits of another
checkout's?  Builds ``md_update`` and ``joint_limit`` from this
checkout's ``omg_planner_torch/csrc/`` and from another checkout's (for
example the parent commit, unpacked with ``git archive`` into a directory
that ``.gitignore`` lists): with the package's nvcc flags for the card,
or with ``--emu`` with g++ against ``csrc/cuda_emu.h`` on the CPU.  Runs
both libraries on the same inputs and compares every output bit for bit:

* every call suite scene 1's plan makes at full width (planned by this
  checkout: 16 ``md_update`` and 32 ``joint_limit`` calls);
* ``chip_smoke.py`` phase 3c's seeded rows (S = 8, the last not live);
* seeded ``md_update`` rows at G = 1, 33, 65, 128, 129 and 3,417 (three
  rows, the last not live): every goals-a-lane instance and the layout in
  shared memory.

    python3 scripts/loop_kernels_same_bits.py OTHER_CHECKOUT [--emu]

Both libraries are launched with this checkout's packers
(``ops/kernels.py``), so the other checkout's sources must take the same
C arguments.  Prints one line a case and ``LOOP KERNEL BITS: SAME``, or
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
from omg_planner_torch.models import panda  # noqa: E402
from omg_planner_torch.ops import kernels  # noqa: E402

ENTRIES = {"md_update": "omg_md_update", "joint_limit": "omg_joint_limit"}


def build(checkout: str, name: str, out: str, emu: bool):
    """The C entry point of ``name`` built from ``checkout``'s sources."""
    src = os.path.join(checkout, "omg_planner_torch", "csrc", f"{name}.cu")
    if emu:
        cmd = [shutil.which("g++"), "-std=c++20", "-O1", "-shared", "-fPIC",
               "-DOMG_CUDA_EMU", "-x", "c++", src, "-o", out]
    else:
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out, src]
    subprocess.run(cmd, check=True)
    fn = getattr(ctypes.CDLL(out), ENTRIES[name])
    fn.argtypes = kernels._LIBS[name][2][ENTRIES[name]]
    fn.restype = ctypes.c_int
    return fn


def _stream(dev: str):
    return torch.cuda.current_stream().cuda_stream if dev == "cuda" else None


def run_md(fn, args, dev: str) -> tuple:
    """``md_update``'s four outputs of one launch on ``args`` (experts_p,
    cv, mask, experts_costs, q, live)."""
    keep, outs, ptrs, dims = kernels._md_update_pack(
        *args, cs.OMG_OPTIM_STEPS, 20)
    if fn(ptrs, dims, 1e-6, _stream(dev)) != 0:
        raise RuntimeError("md_update launch failed")
    cs._sync(dev)
    del keep
    return outs


def run_jl(fn, args, dev: str) -> tuple:
    """``joint_limit``'s output of one launch on ``args`` (xi, lower,
    upper, ainv, live) at 10 steps."""
    keep, out, ptrs, dims = kernels._joint_limit_pack(*args, 10)
    if fn(ptrs, dims, _stream(dev)) != 0:
        raise RuntimeError("joint_limit launch failed")
    cs._sync(dev)
    del keep
    return (out,)


def same_bits(a: list, b: list) -> bool:
    return all(x.view(torch.int32).equal(y.view(torch.int32))
               for x, y in zip(a, b))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--emu", action="store_true",
                    help="build with g++ against cuda_emu.h, run on the CPU")
    args = ap.parse_args()
    dev = "cpu" if args.emu else "cuda"
    out_dir = os.path.join(ROOT, "build", "loop_kernels_same_bits",
                           "emu" if args.emu else "card")
    os.makedirs(out_dir, exist_ok=True)
    libs = {(name, side): build(path, name,
                                os.path.join(out_dir, f"lib{name}_{side}.so"),
                                args.emu)
            for name in ENTRIES
            for side, path in (("this", ROOT),
                               ("other", os.path.abspath(args.other)))}
    steps, calls = cs.capture_loop_calls(dev)
    md8, jl8 = cs.seeded_loop_inputs(dev, panda.load_panda(15, dev))
    gen = torch.Generator().manual_seed(14)
    cases = [("md_update", f"suite scene 1 call {i}", c)
             for i, c in enumerate(calls["md"])]
    cases += [("joint_limit", f"suite scene 1 call {i}", c)
              for i, c in enumerate(calls["jl"])]
    cases += [("md_update", "phase 3c seeded S=8", md8),
              ("joint_limit", "phase 3c seeded S=8", jl8)]
    for g in (1, 33, 65, 128, 129, 3417):
        rows = [t.to(dev) for t in cs._md_rows(g, 3, gen)]
        cases.append(("md_update", f"seeded G={g} S=3",
                      rows + [torch.arange(3, device=dev) < 2]))
    same = True
    for name, what, case in cases:
        run = run_md if name == "md_update" else run_jl
        a, b = (run(libs[(name, side)], case, dev)
                for side in ("this", "other"))
        equal = same_bits(a, b)
        same &= equal
        print(f"{name} {what}: {'bit-equal' if equal else 'DIFFERENT'}",
              flush=True)
    print(f"suite scene 1's plan: {steps} steps; {len(cases)} cases on "
          f"{'the CPU (g++, cuda_emu.h)' if args.emu else 'the card'}")
    print(f"LOOP KERNEL BITS: {'SAME' if same else 'DIFFERENT'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
