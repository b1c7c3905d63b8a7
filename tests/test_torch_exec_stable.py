"""The port's executor against the JAX package's on one suite trajectory
whose execution is stable, at production physics settings.

Some suite executions are chaotic in the JAX package itself: the stick-slip
of the pinch flips their reward when the trajectory moves by 1e-7 m, so
they cannot be held per scene against another executor.  The probe in this
file (``python tests/test_torch_exec_stable.py``, the JAX package on the
CPU) plans suite scenes 0-29 at the production config, executes each plan
as ``apps/phys_exec.py`` does (``pad_statics`` = the largest static count
of the set) and again after moving every waypoint by N(0, 1e-6) with three
seeds; a scene is stable when every execution has the same reward and
``lifted_m`` within 1e-3 m of the unperturbed one.  Its result, the stable
list ``STABLE_SCENES``, is what ``chip_smoke.py`` holds per scene against
``docs/phys_exec_r04.json``.  Scene 0 is stable there (the same reward and
0.2996 m under every perturbation), so the test runs it.

The test: the port plans suite scene 0 on the CPU at the production
config; both executors replay that one trajectory.  Bar: the same reward,
``lifted_m`` within 1e-3 m (415 substeps of float32 contact dynamics in
another op order; a stable execution stays far inside it)."""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from omg_planner_tpu.config import OMGConfig as JConfig  # noqa: E402
from omg_planner_tpu.physics import executor as jex  # noqa: E402
from omg_planner_tpu.planner.scene import PlanningScene as JScene  # noqa: E402
from omg_planner_torch.config import OMGConfig  # noqa: E402
from omg_planner_torch.physics import executor as tex  # noqa: E402
from omg_planner_torch.planner.scene import PlanningScene  # noqa: E402

torch.set_num_threads(2)
SUITE = os.path.join(os.path.dirname(__file__), "..", "data", "suite_v2")
N_SCENES = 30          # apps/phys_exec.py's default set
PERTURB = 1e-6
SEEDS = (1, 2, 3)


def _path(sid):
    return os.path.join(SUITE, f"scene_{sid}.npz")


def pad_statics(n_scenes: int = N_SCENES) -> int:
    """``apps/phys_exec.py``'s ``pad``: the most statics of one scene of
    the set (its objects less the target)."""
    return max(len(np.load(_path(s))["kinds"]) - 1 for s in range(n_scenes))


def test_stable_scene_executes_alike():
    pad = pad_statics()
    ts = PlanningScene.from_npz(OMGConfig(silent=True), _path(0),
                                device="cpu")
    res = ts.step(fast=True)
    assert res is not None and bool(res.flag)
    traj = np.asarray(res.traj, np.float64)
    js = JScene.from_npz(JConfig(silent=True), _path(0))
    jrep = jex.execute_plan(js, traj, pad_statics=pad)
    trep = tex.execute_plan(ts, traj, pad_statics=pad)
    assert trep.reward == jrep.reward == 1
    assert abs(trep.lifted_m - float(jrep.lifted_m)) <= 1e-3, (
        trep.lifted_m, float(jrep.lifted_m))


def probe(n_scenes: int = N_SCENES):
    """JAX's executions of its own plans, unperturbed and perturbed; one
    JSON line a scene, then the stable list."""
    pad = pad_statics(n_scenes)
    stable = []
    for sid in range(n_scenes):
        scene = JScene.from_npz(JConfig(silent=True), _path(sid))
        res = scene.step(fast=True)
        if res is None or not bool(res.flag):
            print(json.dumps({"scene": sid, "plan_flag": False}), flush=True)
            continue
        traj = np.asarray(res.traj, np.float64)
        base = jex.execute_plan(scene, traj, pad_statics=pad)
        runs = []
        for seed in SEEDS:
            noise = np.random.default_rng(seed).normal(0.0, PERTURB,
                                                       traj.shape)
            rep = jex.execute_plan(scene, traj + noise, pad_statics=pad)
            runs.append((int(rep.reward), float(rep.lifted_m)))
        ok = all(r == int(base.reward) and abs(h - float(base.lifted_m))
                 <= 1e-3 for r, h in runs)
        if ok:
            stable.append(sid)
        print(json.dumps({"scene": sid, "plan_flag": True,
                          "reward": int(base.reward),
                          "lifted_m": float(base.lifted_m),
                          "perturbed": runs, "stable": ok}), flush=True)
    print(json.dumps({"pad_statics": pad, "perturbation": PERTURB,
                      "seeds": list(SEEDS), "stable": stable}), flush=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    probe()
