"""The port's execution validator against the JAX package on the CPU.

On a JAX-planned trajectory of ``tests/test_validate.py``'s scene and on
its two corrupted copies (a waypoint driven into the table, the endpoint
moved home), the port's ``ExecutionReport`` equals JAX's field for field:
the swept and lift collision counts and the three booleans.  Also the
port of ``test_antipodal_friction_cone``."""

import dataclasses

import numpy as np
import pytest
import torch

from omg_planner_tpu.config import OMGConfig
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_tpu.planner.validate import validate_execution as jvalidate
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.io.assets import make_primitive, pose_at
from omg_planner_torch.planner.scene import PlanningScene as TScene
from omg_planner_torch.planner.validate import (
    _grasp_antipodal, _target_surface_normals_obj, validate_execution)

torch.set_num_threads(2)

CFG = OMGConfig(silent=True, optim_steps=15, extra_smooth_steps=5,
                goal_set_max_num=12, ik_seed_num=3, ik_max_iters=30,
                learner_interp_steps=10)


@pytest.fixture(scope="module")
def planned():
    js = JScene.synthetic(CFG, scene_id=0, n_obstacles=1)
    res = js.step(fast=True)
    assert res is not None and bool(res.flag)
    tcfg = TConfig(**{f.name: getattr(CFG, f.name)
                      for f in dataclasses.fields(CFG)})
    ts = TScene.synthetic(tcfg, scene_id=0, n_obstacles=1, device="cpu")
    return js, ts, np.asarray(res.traj)


def _corrupt(kind, traj, start):
    bad = traj.copy()
    if kind == "into_table":
        bad[len(bad) // 2, 1] = 1.6
        bad[len(bad) // 2, 3] = -0.2
    elif kind == "endpoint_home":
        bad[-1] = start
    return bad


@pytest.mark.parametrize("kind", ["planned", "into_table", "endpoint_home"])
def test_report_matches_jax(kind, planned):
    js, ts, traj = planned
    traj = _corrupt(kind, traj, js.start)
    jrep = jvalidate(js, traj)
    trep = validate_execution(ts, traj)
    assert trep.to_dict() == jrep.to_dict()
    if kind == "planned":
        assert trep.valid
    else:
        assert not trep.valid
    if kind == "into_table":
        assert trep.swept_collision_points > 0
    if kind == "endpoint_home":
        assert not trep.grasp_ok


def test_antipodal_friction_cone():
    hand = np.eye(4)  # grasp centre at local z=0.103
    pts = np.array([[0.0, 0.02, 0.103], [0.0, -0.02, 0.103]])
    n_good = np.array([[0.0, 1.0, 0.0], [0.0, -1.0, 0.0]])
    assert _grasp_antipodal(hand, pts, n_good, 0.08)
    # glancing contact: normals orthogonal to the pad travel slip
    n_bad = np.array([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    assert not _grasp_antipodal(hand, pts, n_bad, 0.08)
    # one-sided contact fails even in the cone
    n_one = np.array([[0.0, 1.0, 0.0], [0.0, 1.0, 0.0]])
    assert not _grasp_antipodal(hand, pts, n_one, 0.08)

    box = make_primitive("b", "box", [0.06, 0.06, 0.1],
                         pose_at([0.0, 0.0, 0.0]), compute_grasp=False)
    pts_obj = np.array([[0.03, 0.0, 0.0], [-0.03, 0.0, 0.0],
                        [0.0, 0.03, 0.0], [0.0, 0.0, 0.05]])
    n = _target_surface_normals_obj(box, pts_obj)
    np.testing.assert_allclose(n[0], [1, 0, 0], atol=1e-3)
    np.testing.assert_allclose(n[1], [-1, 0, 0], atol=1e-3)
    np.testing.assert_allclose(n[2], [0, 1, 0], atol=1e-3)
    np.testing.assert_allclose(n[3], [0, 0, 1], atol=1e-3)
    # the data-backed branch: central differences of the host grid
    from omg_planner_torch.ops.sdf import SignedDensityField
    grid = make_primitive("g", "box", [0.06, 0.06, 0.1],
                          pose_at([0.0, 0.0, 0.0]), compute_grasp=False)
    grid.sdf = SignedDensityField(box.sdf.data, box.sdf.origin,
                                  box.sdf.delta)
    ng = _target_surface_normals_obj(grid, pts_obj)
    assert (np.einsum("ij,ij->i", ng, n) > 0.9).all()
