"""bench_torch.py smoke: one suite scene on the CPU through every phase
(serial early-termination plan, the pipelined runner, the cascade) prints
``bench.py``'s JSON keys (``tests/test_bench.py``) plus
``host_syncs_per_plan``."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("metric", "value", "unit", "vs_baseline", "backend",
        "end_to_end_plans_per_s", "p50_plan_latency_ms",
        "warm_goal_set_build_s", "success_rate", "mean_steps",
        "cascade_success_rate", "cascade_e2e_plans_per_s",
        "host_syncs_per_plan")


def test_bench_torch_one_scene_cpu():
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "bench_torch.py"), "--cpu",
         "--scenes", "1", "--skip-full-budget"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    for key in KEYS:
        assert key in rec, key
    assert rec["metric"] == "plans_per_second_per_chip"
    assert rec["unit"] == "plans/s"
    assert rec["value"] > 0 and rec["pipelined_plans_per_s"] > 0
    assert rec["cascade_success_rate"] is not None
    assert rec["host_syncs_per_plan"] > 0
    assert rec["device"] == "cpu"
