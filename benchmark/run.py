"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, configurations, traffic mixes and metrics are named in
``BENCHMARK.json`` at the root of the checkout; everything is built from
the checkout and the seed.  It runs on the first CUDA card and refuses to
run without one.  The last line of standard output is the result, a JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and ``checks``: each number compared
with the reference beside its limit, also the last lines of standard
error).
"""

from __future__ import annotations

import time

# set-up is counted from here, before torch and the program load
STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _caches():
    """Every build and kernel cache in fixed directories of the
    checkout (the hand kernels already build under ``build/``)."""
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    # one process, one host thread for the program's CPU operations: the
    # plan loop is host-bound, and idle OpenMP workers spinning beside it
    # only add noise
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _caches()
    sys.path.insert(0, ROOT)
    import torch

    torch.set_num_threads(1)
    import guard
    import harness

    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), bench=bench, started=STARTED)
    found = guard.loaded_forbidden()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
