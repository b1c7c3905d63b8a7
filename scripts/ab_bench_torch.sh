#!/bin/bash
# Same-call A/B of two checkouts on one card: alternating parent/change
# runs of bench_torch.py, one JSON line per run, then the per-side medians.
#
#   scripts/ab_bench_torch.sh PARENT_DIR OUT_DIR [PAIRS [bench args...]]
#   scripts/ab_bench_torch.sh --summary OUT_DIR
#
# PARENT_DIR is an unpacked parent commit (git archive); the change is the
# working tree.  Runs go parent, change, change, parent, ... (PAIRS pairs,
# default 6; bench args default to --scenes 8 --skip-full-budget
# --skip-cascade), each writing OUT_DIR/<i>-<side>.json and .err.
set -u
summary() {
  python3 - "$1" <<'PY'
import glob, json, os, statistics, sys
keys = ("value", "serial_e2e_plans_per_s", "pipelined_plans_per_s",
        "p50_plan_latency_ms", "mean_plan_latency_ms",
        "warm_goal_set_build_s", "mean_steps", "host_syncs_per_plan",
        "success_rate")
runs = {"parent": [], "change": []}
for path in sorted(glob.glob(os.path.join(sys.argv[1], "*-*.json")),
                   key=lambda p: int(os.path.basename(p).split("-")[0])):
    side = os.path.basename(path).split("-")[1].split(".")[0]
    runs[side].append(json.loads(open(path).read().strip().splitlines()[-1]))
for key in keys:
    vals = {s: [r[key] for r in rs] for s, rs in runs.items()}
    print(key, " ".join(f"{s}: median {statistics.median(v)} runs {v}"
                        for s, v in vals.items() if v))
PY
}
if [ "$1" = --summary ]; then summary "$2"; exit; fi
parent=$1; out=$2; pairs=${3:-6}
shift $(( $# < 3 ? $# : 3 ))
args=("$@"); [ ${#args[@]} -eq 0 ] && args=(--scenes 8 --skip-full-budget --skip-cascade)
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | tee "$out/card.txt"
order=()
for ((p = 0; p < pairs; p++)); do
  if ((p % 2 == 0)); then order+=(parent change); else order+=(change parent); fi
done
i=0
for which in "${order[@]}"; do
  i=$((i + 1))
  if [ "$which" = parent ]; then dir=$parent; else dir=.; fi
  (cd "$dir" && python3 bench_torch.py "${args[@]}") \
    > "$out/$i-$which.json" 2> "$out/$i-$which.err"
  echo "$i $which rc=$?"
done
summary "$out"
