"""Does an edit of the rollout kernel's sources keep its results bit for
bit?  Builds ``rigid_rollout`` from this checkout's
``omg_planner_torch/csrc/`` and from another checkout's (for example the
parent commit, unpacked with ``git archive`` into a directory that
``.gitignore`` lists), runs both libraries on the same inputs on the card
(suite scene 0's pick rollout, planned by this checkout, and its
placement rollout) and compares the final states and the per-substep
traces.

    python3 scripts/rollout_same_bits.py OTHER_CHECKOUT

Prints one line per rollout and ``ROLLOUT BITS: SAME`` or exits 1.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from omg_planner_torch.ops import kernels  # noqa: E402

ENTRY = "omg_rigid_rollout"


def build(csrc: str, out: str):
    """The rollout library of ``csrc`` (the package's own nvcc flags)."""
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", out,
                    os.path.join(csrc, "rigid_rollout.cu")], check=True)
    fn = getattr(ctypes.CDLL(out), ENTRY)
    fn.argtypes = kernels._LIBS["rigid_rollout"][2][ENTRY]
    fn.restype = ctypes.c_int
    return fn


def run(fn, args):
    """(final state [B, 13], traces [B, T, 19]) of one launch at the
    wrapper's default lanes and iterations."""
    keep, state, trace, ptrs, dims = kernels._rigid_rollout_pack(
        *args, 48, 32, 48, 48)
    status = fn(ptrs, dims, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    del keep
    if status != 0:
        raise RuntimeError(f"launch failed: CUDA error {status}")
    return state, trace


def main() -> int:
    other = os.path.abspath(sys.argv[1])
    out_dir = os.path.join(ROOT, "build", "rollout_same_bits")
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: build(os.path.join(path, "omg_planner_torch", "csrc"),
                        os.path.join(out_dir, f"lib{name}.so"))
            for name, path in (("this", ROOT), ("other", other))}
    scene, traj, _, pick = cs._pick("cuda")
    same = True
    for what, args in (("pick", pick), ("place", cs._place(scene, traj))):
        a, b = (run(libs[k], args) for k in ("this", "other"))
        equal = all(torch.equal(x, y) for x, y in zip(a, b))
        same &= equal
        print(f"{what} rollout ({a[1].shape[1]} substeps): final state and "
              f"traces {'bit-equal' if equal else 'DIFFERENT'}", flush=True)
    print(f"ROLLOUT BITS: {'SAME' if same else 'DIFFERENT'}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
