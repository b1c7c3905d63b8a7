"""The service's ``/plan_cloud`` (``apps/serve.py::plan_cloud_request``) on
the CPU: an observed obstacle cloud and world grasps planned through
``/plan``'s core.

The plan equals, bit for bit, the CLI's perception path once its cloud and
grasps are made (``PointEnv`` + ``external_grasps`` + ``build_problem`` +
``plan_fast``).  The scene cache keys a cloud by its content: two clouds
(or grasp sets) with one start are two scenes, the same values sent again
are one.  Malformed points or grasps are a 400.  The distance grid calls
``kernels.min_dist_grid`` as resolved at call time, and its read back to
the host is the ``pointsdf.field`` site, inside the ``scene_build.cloud``
span while tracing is on.

Scene: synthetic scene 5's obstacles through the point-splat camera, 400
points; the target's grasp database in the world frame."""

import json

import numpy as np
import pytest
import torch

from omg_planner_torch.__main__ import observe_obstacles
from omg_planner_torch.apps import serve
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.ops import kernels, pointsdf
from omg_planner_torch.planner.plan import plan_fast
from omg_planner_torch.planner.scene import PlanningScene, PointEnv
from omg_planner_torch.utils import timing
from omg_planner_torch.utils.sync import SYNCS

torch.set_num_threads(2)

CFG = OMGConfig(optim_steps=10, extra_smooth_steps=3, goal_set_max_num=12,
                ik_seed_num=4, ik_max_iters=30, learner_interp_steps=10,
                silent=True, sdf_analytic=False, use_point_sdf=True)
START = [0.0, -1.285, 0.0, -2.356, 0.0, 1.571, 0.785, 0.04, 0.04]


@pytest.fixture(scope="module")
def cloud():
    full = PlanningScene.synthetic(CFG, scene_id=5, n_obstacles=2,
                                   device="cpu")
    points = observe_obstacles(full, 400)
    grasps = full.env.grasp_poses_world().astype(np.float32)
    body = {"points": points.tolist(),
            "grasps": grasps.reshape(-1, 16).tolist(), "start": START}
    return points, grasps, body


@pytest.fixture(autouse=True)
def empty_cache():
    serve._SCENE_CACHE.clear()
    yield
    serve._SCENE_CACHE.clear()


def test_plan_cloud_equals_the_cli_path_bit_for_bit(cloud):
    points, grasps, body = cloud
    code, out = serve.plan_cloud_request(body, CFG, "cpu")
    assert code == 200, out
    env = PointEnv(CFG, device="cpu")
    env.compute_sdf_from_points(points)
    scene = PlanningScene(CFG, env)
    scene.external_grasps = grasps
    scene.start = np.asarray(START, np.float64)
    problem = scene.build_problem()
    res = plan_fast(scene.model, scene.cfg, problem)
    assert out["n_goals"] == int(problem.goal_set.mask.sum()) > 0
    np.testing.assert_array_equal(np.asarray(out["traj"], np.float32),
                                  res.traj.numpy())
    assert out["goal_idx"] == int(res.goal_idx)
    assert out["steps_used"] == int(res.steps_used)
    assert out["flag"] == bool(res.flag)
    assert out["info"]["smooth"] == float(res.info.smooth)
    assert set(out) == {"flag", "steps_used", "goal_idx", "traj", "n_goals",
                        "info", "timings"}


def _moved(body, key):
    other = json.loads(json.dumps(body))
    other[key][0][0] += 1e-3
    return other


@pytest.mark.parametrize("change", ["points", "grasps"])
def test_cache_keys_a_cloud_by_its_content(cloud, change):
    body = cloud[2]
    first = serve._cloud_scene(CFG, body, "cpu")
    # the same values in a new body: the same scene
    again = serve._cloud_scene(CFG, json.loads(json.dumps(body)), "cpu")
    assert again is first
    other = serve._cloud_scene(CFG, _moved(body, change), "cpu")
    assert other is not first
    assert len(serve._SCENE_CACHE) == 2
    if change == "points":
        assert not np.array_equal(other.env.objects[0].sdf.data,
                                  first.env.objects[0].sdf.data)
    else:
        assert other.external_grasps[0, 0, 0] != \
            first.external_grasps[0, 0, 0]


def test_empty_cloud_takes_the_references_grid():
    body = {"points": [], "grasps": [np.eye(4).ravel().tolist()]}
    scene = serve._cloud_scene(CFG, body, "cpu")
    sdf = scene.env.objects[0].sdf
    # core.py:433-434: two points at (3, 3, 3), the margin around them (in
    # float32: 0.48 / 0.02 rounds up to 25 cells an axis)
    np.testing.assert_allclose(sdf.origin, [2.76] * 3, rtol=1e-6)
    assert sdf.shape == (25, 25, 25)


_EYE = np.eye(4).ravel().tolist()


@pytest.mark.parametrize("patch", [
    {"points": [[0.1, 0.2]]},
    {"points": [[0.1, 0.2, 0.3], [0.1, 0.2]]},
    {"points": "cloud"},
    {"points": [[0.1, None, 0.3]]},
    {"points": [[0.1, float("nan"), 0.3]]},
    {"grasps": [_EYE[:15]]},
    {"grasps": [[_EYE[:4]] * 3]},
    {"grasps": []},
    {"grasps": [[1.0, "x"] * 8]},
    {"points": None},
], ids=lambda p: json.dumps(p)[:40])
def test_malformed_cloud_or_grasps_is_a_400(cloud, patch):
    body = dict(cloud[2], **patch)
    code, out = serve.plan_cloud_request(body, CFG, "cpu")
    assert code == 400 and "error" in out


@pytest.mark.parametrize("missing", ["points", "grasps"])
def test_missing_cloud_or_grasps_is_a_400(cloud, missing):
    body = {k: v for k, v in cloud[2].items() if k != missing}
    assert serve.plan_cloud_request(body, CFG, "cpu")[0] == 400


def test_grid_calls_the_kernel_resolved_at_call_time(cloud, monkeypatch):
    calls = []
    orig = kernels.min_dist_grid

    def counted(grid, points):
        calls.append((grid.shape, points.shape))
        return orig(grid, points)

    monkeypatch.setattr(kernels, "min_dist_grid", counted)
    sdf = pointsdf.sdf_from_points(cloud[0], device="cpu")
    assert calls == [((int(np.prod(sdf.shape)), 3), (len(cloud[0]), 3))]
    monkeypatch.undo()
    np.testing.assert_array_equal(
        sdf.data, pointsdf.sdf_from_points(cloud[0], device="cpu").data)


def test_field_read_and_cloud_span_are_recorded_while_tracing(cloud):
    timing.take()
    before = SYNCS.sites.get("pointsdf.field", 0)
    timing.enable()
    try:
        with timing.request():
            serve._cloud_scene(CFG, cloud[2], "cpu")
    finally:
        timing.enable(False)
    spans = {s.name: s for s in timing.take()}
    assert SYNCS.sites.get("pointsdf.field", 0) == before + 1
    req, build = spans["request"], spans["scene_build"]
    inner, read = spans["scene_build.cloud"], spans["sync.pointsdf.field"]
    assert build.parent == req.id and inner.parent == build.id
    assert read.parent == inner.id
    assert {s.request for s in spans.values()} == {req.request}
    assert inner.start_ns <= read.start_ns <= read.end_ns <= inner.end_ns
