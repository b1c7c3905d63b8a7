"""The readings that the limits of ``limits/<cell>.json`` are set from:
for each seed, one short run of a cell at its own load with the reference's
comparison (the program's readings), and the control's readings on the
same plans (the reference in float32 with TF32 products put in the
program's place), in one process.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 \
        --seconds 8 [--out FILE]

Prints one JSON line a seed: ``{"seed", "correct", "program", "control"}``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(HERE))
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = "1"
    import torch

    torch.set_num_threads(1)
    import harness

    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run_cell(args.workload, seed, args.seconds, False,
                               device="cpu" if args.cpu else None,
                               control=True)
        line = {"seed": seed, "correct": out["correct"],
                "program": {k: v["value"] for k, v in out["checks"].items()},
                "control": out["control"], "metrics": out["metrics"]}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(json.dumps(x) for x in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
