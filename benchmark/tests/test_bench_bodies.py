"""The request bodies that the traffic builds give the service the objects,
poses and target of ``PlanningScene.from_npz`` on the same scene file.
The one difference, recorded in PERF.md: a body carries no voxel size, so
the service builds every object at 0.0075 m where the file gives some
objects a coarser one."""

import os

import numpy as np
import pytest

import harness

T = harness.traffic("fresh")
STREAM = harness.generator(T)
ROOT = os.path.join(os.path.dirname(harness.HERE), "data", "suite_v2")


@pytest.mark.parametrize("k", range(0, 100, 7))
def test_body_objects_match_from_npz(k):
    from omg_planner_torch.apps import serve
    from omg_planner_torch.config import OMGConfig
    from omg_planner_torch.planner.scene import PlanningScene

    cfg = OMGConfig(silent=True)
    body = STREAM.scene_body(os.path.join(harness.HERE, T["scenes"],
                                          f"scene_{k}.npz"), T["start"])
    served = serve._build_scene(cfg, body, "cpu")
    ref = PlanningScene.from_npz(cfg, os.path.join(ROOT, f"scene_{k}.npz"),
                                 device="cpu")
    a, b = served.env, ref.env
    assert a.names == b.names
    assert a.target.name == b.target.name
    for oa, ob in zip(a.objects, b.objects):
        assert oa.kind == ob.kind
        np.testing.assert_array_equal(oa.extents, ob.extents)
        np.testing.assert_array_equal(oa.pose_mat, ob.pose_mat)
        assert oa.target == ob.target
        np.testing.assert_array_equal(oa.grasps_poses, ob.grasps_poses)
        assert oa.sdf.delta == 0.0075
    np.testing.assert_array_equal(served.start, T["start"])


def test_suite_copy_is_the_repos():
    for k in range(100):
        with open(os.path.join(ROOT, f"scene_{k}.npz"), "rb") as f:
            a = f.read()
        with open(os.path.join(harness.HERE, T["scenes"],
                               f"scene_{k}.npz"), "rb") as f:
            assert f.read() == a
