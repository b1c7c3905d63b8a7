"""How far the JAX package's joint-limit projection and the port's
``joint_limit`` kernel source stand from the port's plain version, on
random trajectories pushed past the Panda's limits (CPU).

    JAX_PLATFORMS=cpu python3 scripts/joint_limit_gaps.py [TRIALS]

Trial i draws a [30, 9] trajectory with seed i between two in-limit
configurations and pushes one to three joints past a limit over a stretch
of timesteps (``omg_planner_torch/utils/limit_cases.py``'s ``seeded``).
It runs ``omg_planner_torch.ops.kernels.joint_limit_plain`` in float32
and float64,
``omg_planner_tpu.ops.chomp.handle_joint_limit`` at
``tests/test_golden.py``'s config, and ``csrc/joint_limit.cu`` compiled
with g++ against ``csrc/cuda_emu.h`` (as
``tests/test_torch_learner_kernels_emu.py`` does; 50 trials a launch).
Prints, for each number of passes the loop ran, the trials and the
largest |port - JAX|, over all trials and over those whose checked norms
stay 1e-4 from the 1e-2 threshold and whose argmax gaps stay >= 1e-4;
then, for JAX and for the kernel source, the trials that stand farther
from the float64 plain version than max(1e-6, 2 x the float32 plain
version's distance), and the largest ratio of distance to that bar.
"""

import os
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

from omg_planner_torch.config import OMGConfig  # noqa: E402
from omg_planner_torch.models import panda  # noqa: E402
from omg_planner_torch.ops import kernels  # noqa: E402
from omg_planner_torch.utils.limit_cases import seeded  # noqa: E402
from omg_planner_tpu.config import OMGConfig as JConfig  # noqa: E402
from omg_planner_tpu.ops import chomp as jchomp  # noqa: E402
from test_torch_learner_kernels_emu import _compile, _jl_emu  # noqa: E402

CFG = dict(optim_steps=10, extra_smooth_steps=3, goal_set_max_num=12,
           ik_seed_num=4, ik_max_iters=30, learner_interp_steps=10)
CHUNK = 50


def main() -> int:
    trials = int(sys.argv[1]) if len(sys.argv) > 1 else 500
    jcfg = JConfig(**CFG)
    ainv = OMGConfig(**CFG).horizon().on("cpu").Ainv
    model = panda.load_panda(15, "cpu")
    lo, hi = model.joint_lower, model.joint_upper
    limits = (lo.numpy(), hi.numpy())
    jl = jax.jit(lambda x: jchomp.handle_joint_limit(
        jcfg.horizon(), jcfg, x, *map(jnp.asarray, limits)))
    with tempfile.TemporaryDirectory() as tmp:
        emu = _compile(tmp, "joint_limit").omg_joint_limit
        emu.argtypes = kernels._LIBS["joint_limit"][2]["omg_joint_limit"]
        xis = list(torch.as_tensor(seeded(limits, range(trials))))
        emus = []
        for c in range(0, trials, CHUNK):
            xi = torch.stack(xis[c:c + CHUNK])
            emus += list(_jl_emu(emu, xi, lo.expand(len(xi), 9),
                                 hi.expand(len(xi), 9), ainv))
    rows = {}
    beyond = {"JAX": [], "kernel source": []}
    worst = dict.fromkeys(beyond, 0.0)
    for i, xi in enumerate(xis):
        norms, gaps = kernels.limit_loop_trace(xi, lo, hi, ainv, 10)
        port = kernels.joint_limit_plain(xi, lo, hi, ainv, None, 10).numpy()
        f64 = kernels.joint_limit_plain(
            *(t.double() for t in (xi, lo, hi, ainv)), None, 10).numpy()
        want = np.asarray(jl(jnp.asarray(xi.numpy())))
        err = float(np.abs(port - want).max())
        bar = max(1e-6, 2 * float(np.abs(port - f64).max()))
        for name, out in (("JAX", want), ("kernel source", emus[i].numpy())):
            ratio = float(np.abs(out - f64).max()) / bar
            worst[name] = max(worst[name], ratio)
            if ratio > 1:
                beyond[name].append(i)
        admitted = (min(abs(n - 1e-2) for n in norms) >= 1e-4
                    and (not gaps or min(gaps) >= 1e-4))
        row = rows.setdefault(len(norms) - 1, [0, 0.0, 0, 0.0])
        row[0] += 1
        row[1] = max(row[1], err)
        if admitted:
            row[2] += 1
            row[3] = max(row[3], err)
    for passes in sorted(rows):
        n, err, n_adm, err_adm = rows[passes]
        print(f"{passes} passes: {n} trials, max |port - JAX| {err:.3e}; "
              f"admitted {n_adm}, max {err_adm:.3e}")
    for name, out in beyond.items():
        print(f"{name} beyond max(1e-6, 2 x the float32 plain version's "
              f"distance) from the float64 plain version: {len(out)} of "
              f"{trials} trials {out[:20]}; largest distance / bar "
              f"{worst[name]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
