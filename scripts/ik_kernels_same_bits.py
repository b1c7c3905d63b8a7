"""Do the IK kernels of this checkout give the bits of another checkout's?
Builds ``ik_prefilter`` and ``ik_chain`` (``omg_planner_torch/csrc/
ik_newton.cu``) from this checkout's sources and from another checkout's
(for example the parent commit, unpacked with ``git archive`` into a
directory that ``.gitignore`` lists): with the package's nvcc flags for
the card, or with ``--emu`` with g++ against ``csrc/cuda_emu.h`` on the
CPU.  Runs both libraries on the same inputs and compares every output
bit for bit:

* every call that ``chip_smoke.py::capture_ik_calls`` captures (planned by
  this checkout: suite scenes 0-7's goal-set builds and a batched build of
  scenes 0-3, 9 prefilter and 9 chain calls);
* near-solution prefilter rows at B = 1, 5 and 37 (targets at a seeded q
  within the limits, seeds 0.05 rad from it), the 37 also as a strided
  view;
* suite scene 1's chain rows at B = 1, 5 and 37 with a third of the lanes
  not active and budgets that mix 26, 0 (none) and 9.

    python3 scripts/ik_kernels_same_bits.py OTHER_CHECKOUT [--emu]

Both libraries are launched with this checkout's packers
(``ops/kernels.py``).  This checkout's library gets each call as
``ops/ik.py`` makes it (the prefilter's targets a strided view, the
chain's budget an int where it is one for every lane); the other's the
same values laid out as a kernel with one thread a lane read them
(contiguous targets, a budget tensor), whose C entry points ignore the
ints this checkout's packers add.  Prints one line a case and
``IK KERNEL BITS: SAME``, or exits 1.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from omg_planner_torch.models import panda  # noqa: E402
from omg_planner_torch.ops import kernels  # noqa: E402

ENTRIES = ("omg_ik_prefilter", "omg_ik_chain")


def build(checkout: str, out: str, emu: bool) -> dict:
    """The two C entry points built from ``checkout``'s ``ik_newton.cu``."""
    src = os.path.join(checkout, "omg_planner_torch", "csrc", "ik_newton.cu")
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
        fn.argtypes = kernels._LIBS["ik_newton"][2][name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _stream(dev: str):
    return torch.cuda.current_stream().cuda_stream if dev == "cuda" else None


def _tables(pqr, pose_0):
    """A model tables buffer (``kernels.fk_tables``) whose head, the part
    the IK kernels read, is ``pqr`` and ``pose_0``."""
    model = panda.load_panda(15, pose_0.device)
    return kernels.fk_tables(pqr, pose_0, model.center_offset,
                             model.collision_points)


def run(fns, kind: str, pa: list, dev: str) -> tuple:
    """One launch of ``kind`` on the plain version's arguments ``pa``."""
    if kind == "ik_prefilter":
        *lanes, damping, iters = pa
        lanes[2:4] = [_tables(*lanes[2:4])]
        keep, outs, ptrs, dims = kernels._ik_prefilter_pack(*lanes, iters)
        status = fns["omg_ik_prefilter"](ptrs, dims, damping, _stream(dev))
    else:
        *lanes, damping, pos_tol, rot_tol, max_iters, window = pa
        lanes[4:6] = [_tables(*lanes[4:6])]
        keep, outs, ptrs, dims = kernels._ik_chain_pack(*lanes, max_iters,
                                                        window)
        status = fns["omg_ik_chain"](ptrs, dims, damping, pos_tol,
                                     pos_tol * 10, rot_tol * 10,
                                     _stream(dev))
    if status != 0:
        raise RuntimeError(f"{kind} launch failed: error {status}")
    cs._sync(dev)
    del keep
    return outs


def one_thread_a_lane(kind: str, pa: list) -> list:
    """``pa`` as a kernel with one thread a lane reads it: contiguous
    targets, the chain's budget a tensor."""
    pa = list(pa)
    if kind == "ik_prefilter":
        pa[0] = pa[0].contiguous()
    elif not torch.is_tensor(pa[3]):
        pa[3] = torch.full(pa[1].shape[:-1], pa[3], dtype=torch.int32,
                           device=pa[1].device)
    return pa


def same_bits(a, b) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and (x.view(torch.int32) if x.dtype == torch.float32
                    else x).equal(y.view(torch.int32)
                                  if y.dtype == torch.float32 else y)
               for x, y in zip(a, b))


def seeded_cases(calls: list, dev: str) -> list:
    """The near-solution prefilter rows and suite scene 1's chain rows."""
    pa_pre = next(cs._ik_plain_args(a) for k, w, a in calls
                  if k == "ik_prefilter" and w == "suite scene 1")
    pa_chain = next(cs._ik_plain_args(a) for k, w, a in calls
                    if k == "ik_chain" and w == "suite scene 1")
    pqr, pose_0, lo, hi = pa_pre[2:6]
    model = panda.load_panda(15, dev)
    cases = []
    for b in (1, 5, 37):
        rng = np.random.default_rng(b)
        q_true = lo + (hi - lo) * torch.as_tensor(
            rng.uniform(0.3, 0.7, (b, 7)), dtype=torch.float32, device=dev)
        tgts = panda.hand_pose_batch(model, torch.cat(
            [q_true, torch.full((b, 2), 0.04, device=dev)], 1))
        seeds = q_true + torch.as_tensor(rng.normal(0, 0.05, (b, 7)),
                                         dtype=torch.float32, device=dev)
        rest = [pqr, pose_0, lo, hi] + list(pa_pre[6:])
        cases.append(("ik_prefilter", f"near solutions B={b}",
                      [tgts, seeds] + rest))
        if b == 37:
            strided = torch.stack([tgts.flip(0), tgts], 1)[:, 1]
            cases.append(("ik_prefilter", f"near solutions B={b}, strided",
                          [strided, seeds] + rest))
        active = pa_chain[2][:b].clone()
        active[1::3] = False
        budgets = torch.tensor([26, 0, 9], dtype=torch.int32,
                               device=dev).repeat(b)[:b]
        cases.append(("ik_chain", f"suite scene 1 rows B={b}, budgets 26, "
                      "0, 9, a third not active",
                      [pa_chain[0][:b], pa_chain[1][:b], active, budgets]
                      + list(pa_chain[4:])))
    return cases


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("other")
    ap.add_argument("--emu", action="store_true",
                    help="build with g++ against cuda_emu.h, run on the CPU")
    args = ap.parse_args()
    dev = "cpu" if args.emu else "cuda"
    out_dir = os.path.join(ROOT, "build", "ik_kernels_same_bits",
                           "emu" if args.emu else "card")
    os.makedirs(out_dir, exist_ok=True)
    libs = {side: build(path, os.path.join(out_dir, f"libik_{side}.so"),
                        args.emu)
            for side, path in (("this", ROOT),
                               ("other", os.path.abspath(args.other)))}
    calls = cs.capture_ik_calls(dev)
    cases = [(kind, what, cs._ik_plain_args(a)) for kind, what, a in calls]
    cases += seeded_cases(calls, dev)
    same = True
    for kind, what, pa in cases:
        mine = run(libs["this"], kind, pa, dev)
        other = run(libs["other"], kind, one_thread_a_lane(kind, pa), dev)
        equal = same_bits(mine, other)
        same &= equal
        print(f"{kind} {what} (B = {pa[1].shape[0]}): "
              f"{'bit-equal' if equal else 'DIFFERENT'}", flush=True)
    print(f"{len(cases)} cases ({len(calls)} captured) on "
          f"{'the CPU (g++, cuda_emu.h)' if args.emu else 'the card'}")
    print(f"IK KERNEL BITS: {'SAME' if same else 'DIFFERENT'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
