"""The benchmark's perception configuration on the CPU: its reference
(``benchmark/reference/perception.py``), its counted kernel
(``benchmark/kernels/min_dist_grid.py``) and its traffic
(``generators/cloud_stream.py``), driven through whole runs of the
harness (the look for a card skipped) on a stand-in cell.

The stand-in is ``perception_fresh`` made small enough for a few seconds
a run: two of the frozen observations (``benchmark/data/suite_v2_clouds``)
cut to the 300 points nearest their target, 16 of their grasps, and the
plan at ``tests/test_golden.py::CFG``'s sizes; the limits are
``perception_fresh``'s own.  A sound run passes them and the control (the
reference in float32 with TF32 products in the program's place) does not.
Each planted fault makes ``correct`` false: half the cloud left out of
the distance grid, and the grid built at 0.04 m in place of 0.02 m.

The harness runs in this process, where the tests' ``conftest.py`` has
loaded JAX for the port's comparisons, so its check that a run's process
loaded no JAX module is switched off here; the reference's own imports
are checked from its sources."""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
sys.path.insert(0, BENCH)

import guard  # noqa: E402
import harness  # noqa: E402
import probes  # noqa: E402

from omg_planner_torch.apps import serve  # noqa: E402
from omg_planner_torch.ops import kernels, pointsdf  # noqa: E402

CLOUDS = os.path.join(BENCH, "data", "suite_v2_clouds")
CELL = "standin_cloud"
SEED = 2 ** 33 + 21
SECONDS = 2.0
# the sound run's window: room for two requests on a loaded host.  A
# scene's first request builds its cloud's field: up to 3.6 s with the
# whole test suite running beside it under 6 xdist workers, where a 2 s
# window held only that one request; a cached scene's takes 0.05-0.9 s.
SOUND_SECONDS = 6.0
SIZES = dict(optim_steps=10, extra_smooth_steps=3, goal_set_max_num=12,
             ik_seed_num=4, ik_max_iters=30, learner_interp_steps=10)


def _small_observation(k: int, n_points: int = 300, n_grasps: int = 16):
    """A frozen observation cut to the points nearest its target (the
    centre its grasps approach) and every third of its grasps."""
    d = np.load(os.path.join(CLOUDS, f"scene_{k}.npz"))
    points, grasps = d["points"], d["grasps"]
    # a grasp's centre lies 0.103 m along its approach axis
    centre = (grasps[:, :3, 3] + 0.103 * grasps[:, :3, 2]).mean(0)
    near = np.argsort(np.linalg.norm(points - centre, axis=1))[:n_points]
    return points[np.sort(near)], grasps[::3][:n_grasps]


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    """The stand-in's files (configuration, traffic, observations,
    limits) in a directory of their own, and BENCHMARK.json with its
    configuration and cell."""
    root = tmp_path_factory.mktemp("standin_cloud")
    clouds = root / "clouds"
    clouds.mkdir()
    for k in (0, 1):
        points, grasps = _small_observation(k)
        np.savez(clouds / f"scene_{k}.npz", points=points, grasps=grasps)
    with open(clouds / "manifest.json", "w") as f:
        json.dump({"scenes": [{"scene": 0, "steps": 2},
                              {"scene": 1, "steps": 3}]}, f)
    real = harness.traffic("cloud_fresh")
    for kind in ("traffic", "limits", "configs"):
        (root / kind).mkdir()
    with open(root / "traffic" / "cloud_standin.json", "w") as f:
        json.dump(dict(real, scenes=str(clouds), strata=2, warmup_scenes=[0],
                       sample_every=2, trace_requests=2), f)
    limits = harness.limits("perception_fresh")
    with open(root / "limits" / f"{CELL}.json", "w") as f:
        json.dump(limits, f)
    bench = harness.load_benchmark()
    conf = harness.config_of(bench, "panda_perception")
    conf["omg_config"] = dict(conf["omg_config"], **SIZES)
    conf["published"] = dict(conf["published"], **SIZES)
    with open(root / "configs" / "standin_cloud.json", "w") as f:
        json.dump(conf, f)
    bench["configs"].append({
        "name": "standin_cloud", "source": "the tests", "reduced": [],
        "file": str(root / "configs" / "standin_cloud.json"),
        "why": "panda_perception at the tests' sizes"})
    bench["workloads"].append({
        "name": CELL, "config": "standin_cloud", "traffic": "cloud_standin",
        "chips": 1, "why": "perception_fresh made small"})
    return root, bench, limits["limits"]


@pytest.fixture
def harnessed(standin, monkeypatch):
    root, bench, _ = standin
    real = harness.folder
    monkeypatch.setattr(harness, "folder", lambda kind: str(root / kind)
                        if kind in ("traffic", "limits") else real(kind))
    monkeypatch.setattr(guard, "loaded_forbidden", lambda *a, **k: [])
    torch.set_num_threads(4)

    def run(seconds=SECONDS, **kw):
        # a fresh process's cache: no scene of an earlier run is reused
        serve._SCENE_CACHE.clear()
        return harness.run_cell(CELL, SEED, seconds, False, device="cpu",
                                bench=bench, log=lambda *a, **k: None, **kw)
    return run


def test_sound_run_is_correct_and_the_control_is_not(standin, harnessed):
    out = harnessed(control=True, seconds=SOUND_SECONDS)
    checks = out["checks"]
    assert out["correct"], checks
    assert out["failed"] == 0 and out["attempted"] >= 2
    assert checks["plans_checked"]["value"] >= 1
    assert set(checks) == {"fk_gap_m", "sdf_pot_gap", "sdf_grad_gap",
                           "collide_excess", "obstacle_gap", "step_gap",
                           "goal_pose_err", "goal_pot_gap", "goal_invalid",
                           "final_gap", "flag_flips", "unanswered",
                           "plans_checked"}
    lim = standin[2]
    over = [k for k, v in out["control"].items() if k in lim and v > lim[k]]
    assert over, out["control"]


def _half_the_cloud(points, *a, **k):
    return _SDF_FROM_POINTS(points[: len(points) // 2], *a, **k)


def _coarse_grid(points, resolution=0.02, *a, **k):
    return _SDF_FROM_POINTS(points, 0.04, *a, **k)


_SDF_FROM_POINTS = pointsdf.sdf_from_points


@pytest.mark.parametrize("plant", [_half_the_cloud, _coarse_grid])
def test_planted_fault_is_not_correct(harnessed, monkeypatch, plant):
    out = harnessed(faults=lambda: monkeypatch.setattr(
        pointsdf, "sdf_from_points", plant))
    assert out["failed"] == 0
    assert not out["correct"], out["checks"]


def test_reference_imports_nothing_of_the_program_or_jax():
    assert guard.reference_imports(os.path.join(BENCH, "reference")) == {}


def test_work_counts_a_known_launch_exactly():
    mod = harness.kernels_of({"kernels": ["min_dist_grid"]})["min_dist_grid"]
    assert mod.OPS == ("min_dist_grid_kernel",)
    # PERF.md's launch: 413,820 cells x 1,035 points
    grid, pts = torch.zeros(413_820, 3), torch.zeros(1_035, 3)
    assert mod.work((grid, pts), {}) == (8 * 413_820 * 1_035,
                                         4 * (4 * 413_820 + 3 * 1_035))
    assert mod.work((grid, pts), {})[0] == 3_426_429_600


def test_probes_count_the_grid_of_a_cloud():
    """A traced run's probes wrap the kernel and count each call that the
    cloud's field makes, with its work module's count."""
    mod = harness.kernels_of({"kernels": ["min_dist_grid"]})["min_dist_grid"]
    points, _ = _small_observation(0, 64)
    pr = probes.Probes(spans=True, cuda=False,
                       kernels={"min_dist_grid": mod})
    pr.install()
    try:
        pr.counting = True
        sdf = pointsdf.sdf_from_points(points, device="cpu")
    finally:
        pr.uninstall()
    g = int(np.prod(sdf.shape))
    assert pr.named_launch_work() == {"min_dist_grid": [
        mod.work((torch.zeros(g, 3), torch.zeros(64, 3)), {})]}
    assert not hasattr(kernels.min_dist_grid, "__wrapped__")
