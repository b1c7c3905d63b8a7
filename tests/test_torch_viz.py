"""The port's viz layer (``viz/raster.py``, ``viz/render.py``) and the CLI's
render flags against the JAX package on the CPU, at ``tests/test_raster.py``
and ``tests/test_peripherals.py``'s sizes.

Tolerances, and why:
* ``primitive_mesh`` and ``render_rgb`` (rgb, depth, seg): exactly equal;
  both are the same numpy code on the same float64 inputs;
* matplotlib frames (``render_frame``, ``render_execution``,
  ``render_grasps``): mean absolute difference <= 0.5 grey levels and at
  least 99% of pixels identical; float32 FK in the two packages differs in
  the last bits, which only moves antialiasing;
* ``collision_probe`` against JAX's ``fk_one`` / ``point_positions`` /
  ``sdf_potentials`` on the same ``q``: points within 1e-5 m, potentials
  and gradients within 1e-4 (float32 op order through the FK chain and
  the analytic SDF)."""

import glob
import math
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.config import OMGConfig as JConfig
from omg_planner_tpu.io import assets as jassets
from omg_planner_tpu.models import api as japi
from omg_planner_tpu.models import panda as jpanda
from omg_planner_tpu.ops.sdf import sdf_potentials as j_sdf_potentials
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_tpu.viz import raster as jraster
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.io import assets as tassets
from omg_planner_torch.models import panda as tpanda
from omg_planner_torch.planner.scene import PlanningScene
from omg_planner_torch.viz import raster as traster

torch.set_num_threads(2)

Q = np.array([0, -1.2, 0, -2.3, 0, 1.5, 0.8, 0.04, 0.04])
KW = dict(silent=True, optim_steps=10, extra_smooth_steps=3,
          goal_set_max_num=12, ik_seed_num=4, ik_max_iters=30,
          learner_interp_steps=10)


def _same_image(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    diff = np.abs(a.astype(int) - b.astype(int))
    same = (diff == 0).all(-1).mean()
    assert diff.mean() <= 0.5 and same >= 0.99, (diff.mean(), same)


@pytest.fixture(scope="module")
def models():
    return jpanda.load_panda(), tpanda.load_panda(device="cpu")


@pytest.fixture(scope="module")
def scenes():
    """Synthetic scene 0 (two obstacles) staged by each package."""
    return (JScene.synthetic(JConfig(**KW), scene_id=0, n_obstacles=2),
            PlanningScene.synthetic(OMGConfig(**KW), scene_id=0,
                                    n_obstacles=2, device="cpu"))


@pytest.mark.parametrize("kind, ext", [("box", [0.1, 0.2, 0.3]),
                                       ("cylinder", [0.05, 0.2]),
                                       ("sphere", [0.08])])
def test_primitive_mesh_matches_jax(kind, ext):
    jv, jf = jraster.primitive_mesh(kind, ext)
    tv, tf = traster.primitive_mesh(kind, ext)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)


def test_render_rgb_scene_matches_jax(scenes):
    js, ts = scenes
    j = jraster.render_rgb(js.env.objects)
    t = traster.render_rgb(ts.env.objects)
    assert set(np.unique(t[2])) >= {0, 1}
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def _textured_wall(assets):
    wall = assets.make_primitive("wall", "box", [0.02, 0.6, 0.6],
                                 assets.pose_at([0.6, 0.0, 0.3]),
                                 compute_grasp=False)
    v = np.array([[0.0, -0.3, -0.3], [0.0, 0.3, -0.3],
                  [0.0, 0.3, 0.3], [0.0, -0.3, 0.3]])
    f = np.array([[0, 1, 2], [0, 2, 3]])
    uv = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    wall.mesh = (v, f)
    wall.mesh_uv = uv[f]
    tex = np.zeros((8, 8, 3))
    tex[:, :4] = [1.0, 0.0, 0.0]
    tex[:, 4:] = [0.0, 0.0, 1.0]
    wall.texture = tex
    return wall


def test_textured_quad_with_robot_points_matches_jax(models):
    jm, _ = models
    fresh = tassets.make_primitive("box", "box", [0.1] * 3, np.eye(4))
    assert (fresh.mesh, fresh.mesh_uv, fresh.texture) == (None, None, None)
    pts = np.asarray(japi.point_positions(
        jm, japi.fk_one(jm, jnp.asarray(Q, jnp.float32)))).reshape(-1, 3)
    j = jraster.render_rgb([_textured_wall(jassets)], robot_points=pts)
    t = traster.render_rgb([_textured_wall(tassets)], robot_points=pts)
    assert (t[2] == 0).sum() > 200
    assert (t[0] == [114, 216, 127]).all(-1).any()   # robot splats drawn
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)


def test_collision_probe_matches_jax(scenes):
    from omg_planner_torch.viz.render import collision_probe

    js, ts = scenes
    q = Q + np.random.default_rng(3).normal(scale=0.05, size=9)
    q[7:] = 0.04
    params = js.env.cost_params()
    poses = japi.fk_one(js.model, jnp.asarray(q, jnp.float32))
    jx = japi.point_positions(js.model, poses)
    jpot, jgrad, _ = j_sdf_potentials(
        js.env.scene_sdf(), params.inv_poses, jx.reshape(-1, 3),
        params.epsilons, params.padding_scales, params.clearances,
        params.disables)
    x, pot, grad = collision_probe(ts, q)
    assert x.device.type == "cpu" and pot.shape == (x.shape[0] * x.shape[1],)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(pot.numpy(), np.asarray(jpot), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), atol=1e-4,
                               rtol=0)
    assert float(pot.max()) > 0   # the probe configuration touches the scene


def test_render_frame_matches_jax(models, scenes):
    pytest.importorskip("matplotlib")
    from omg_planner_torch.viz.render import collision_probe, render_frame
    from omg_planner_tpu.viz.render import render_frame as j_render_frame

    jm, tm = models
    _, ts = scenes
    objs = [tassets.make_primitive("mug", "cylinder", [0.04, 0.1],
                                   tassets.pose_at([0.5, 0, 0.3]))]
    j = j_render_frame(jm, objs, Q)
    t = render_frame(tm, objs, Q)
    assert t.shape == (480, 640, 3) and t.std() > 1
    _same_image(t, j)
    # the collision and goal-ghost modes
    x, pot, grad = (a.numpy() for a in collision_probe(ts, Q))
    ghosts = Q[None] + np.linspace(-0.2, 0.2, 3)[:, None]
    kw = dict(collision_pts=x.reshape(-1, 3), potentials=pot, grads=grad,
              goal_configs=ghosts)
    _same_image(render_frame(tm, ts.env.objects, Q, **kw),
                j_render_frame(jm, ts.env.objects, Q, **kw))


def test_render_execution_matches_jax_and_restores_pose(models):
    pytest.importorskip("matplotlib")
    from omg_planner_torch.viz.render import render_execution
    from omg_planner_tpu.viz.render import \
        render_execution as j_render_execution

    jm, tm = models
    objs = [tassets.make_primitive("mug", "cylinder", [0.04, 0.1],
                                   tassets.pose_at([0.5, 0, 0.3]))]
    old = objs[0].pose_mat.copy()
    configs = np.tile(Q, (40, 1))
    xs = np.linspace([0.5, 0, 0.3], [0.5, 0, 0.6], 40)
    quats = np.tile([1.0, 0, 0, 0], (40, 1))
    com = np.array([0.0, 0.0, 0.01])
    t = render_execution(tm, objs, 0, configs, xs, quats, com=com,
                         every=20)
    np.testing.assert_array_equal(objs[0].pose_mat, old)   # pose restored
    j = j_render_execution(jm, objs, 0, configs, xs, quats, com=com,
                           every=20)
    assert len(t) == len(j) == 2 and t[0].shape == (480, 640, 3)
    for a, b in zip(t, j):
        _same_image(a, b)


def test_render_grasps_matches_jax(models):
    pytest.importorskip("matplotlib")
    from omg_planner_torch.viz.render import render_grasps
    from omg_planner_tpu.viz.render import render_grasps as j_render_grasps

    jm, tm = models
    obj = tassets.make_primitive("mug", "cylinder", [0.04, 0.1], np.eye(4))
    _same_image(render_grasps(tm, obj, obj.grasps_poses, max_grasps=8),
                j_render_grasps(jm, obj, obj.grasps_poses, max_grasps=8))


def test_write_video_avi_and_npz_fallback(tmp_path, monkeypatch):
    cv2 = pytest.importorskip("cv2")
    from omg_planner_torch.viz.render import write_video

    frames = [np.full((48, 64, 3), 40 * i, np.uint8) for i in range(3)]
    path = str(tmp_path / "v.avi")
    write_video(frames, path)
    cap = cv2.VideoCapture(path)
    assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
    cap.release()
    monkeypatch.setitem(sys.modules, "cv2", None)   # import cv2 now fails
    path2 = str(tmp_path / "w.avi")
    write_video(frames, path2)
    got = np.load(path2 + ".npz")["frames"]
    np.testing.assert_array_equal(got, np.stack(frames))


def test_cli_collision_and_goalset_video(tmp_path, monkeypatch, capsys):
    """``python -m omg_planner_torch -f 0 -vc -vg --cpu --fast``: one frame
    every second waypoint into ``output_videos/scene_0.avi`` (or its
    ``.npz`` without cv2)."""
    pytest.importorskip("matplotlib")
    from omg_planner_torch.__main__ import main

    monkeypatch.chdir(tmp_path)
    res = main(["-f", "0", "-vc", "-vg", "--cpu", "--fast"])
    assert res is not None and np.isfinite(res.traj).all()
    want = math.ceil(len(res.traj) / 2)
    written = glob.glob(str(tmp_path / "output_videos" / "scene_0.avi*"))
    assert len(written) == 1
    assert f"({want} frames)" in capsys.readouterr().out
    if written[0].endswith(".npz"):
        n = len(np.load(written[0])["frames"])
    else:
        import cv2
        cap = cv2.VideoCapture(written[0])
        n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
        cap.release()
    assert n == want == 15


def test_phys_exec_video_writes_replay(tmp_path, capsys):
    """``phys_exec --cpu --scenes 1 --video``: the first executed scene's
    rollout trace rendered every 20 substeps (415 substeps: 21 frames)."""
    pytest.importorskip("matplotlib")
    from omg_planner_torch.apps import phys_exec

    path = str(tmp_path / "replay.avi")
    report = phys_exec.main(["--cpu", "--scenes", "1", "--video", path])
    assert report["scenes"][0]["executed"]
    assert "(21 frames)" in capsys.readouterr().out
    assert len(glob.glob(path + "*")) == 1
