"""The perception-mode plan (``-p``) of the port against the JAX package
on the CPU, at ``tests/test_golden.py::CFG``.

Scene: synthetic scene 5.  Its obstacles are observed through the
point-splat camera (``viz/camera.py``), and the same numpy cloud goes to
both packages.  Each builds the 0.02 m distance grid from it (the port's
wrapper takes the plain version of ``min_dist_grid`` on CPU tensors; JAX
its chunked XLA path), bakes the grid's gradient channels and the
learner's world potential, and plans with the full scene's grasps as
external grasps.

The plan comparison plans the problem JAX staged, carried across with
``interop``: equal ``goal_idx`` and ``flag``, ``traj`` within atol 2e-3,
as ``tests/test_golden.py``.  The staging comparison holds the port's own
grid (atol 1e-3 m: the expansion |g|^2+|p|^2-2g.p loses up to ~5e-4 m in
float32 near d = 0), its baked stack (the grid's bound, and 1e-3/delta
on the central-difference gradient channels) and its world potential
(atol 1e-4, up to 0.1% of cells whose nearest-cell index straddles a
face by rounding) against JAX's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.models import panda as jpanda
from omg_planner_tpu.planner import plan as jplan
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_tpu.planner.scene import PointEnv as JPointEnv
from omg_planner_torch import interop
from omg_planner_torch.__main__ import observe_obstacles, perception_plan
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.ops import kernels
from omg_planner_torch.ops import sdf as tsdf
from omg_planner_torch.planner import plan as tplan
from omg_planner_torch.planner.scene import PlanningScene as TScene
from omg_planner_torch.planner.scene import PointEnv as TPointEnv
from test_golden import CFG

torch.set_num_threads(2)


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def staged():
    """JAX's perception staging (``omg_planner_tpu/__main__.py``'s
    ``_perception_plan`` at CFG) plus the port's from the same cloud."""
    full = JScene.synthetic(CFG, scene_id=5, n_obstacles=2)
    goal_set = full.build_goal_set()
    mask = np.asarray(goal_set.mask)
    hands = np.array(jax.vmap(lambda q: jpanda.hand_pose(full.model, q))(
        jnp.asarray(np.asarray(goal_set.grasps)[mask])))
    tfull = TScene.synthetic(tcfg(CFG), scene_id=5, n_obstacles=2,
                             device="cpu")
    cloud = observe_obstacles(tfull)
    jenv = JPointEnv(CFG)
    jenv.compute_sdf_from_points(cloud)
    jscene = JScene(CFG, jenv)
    jscene.external_grasps = hands
    jprob = jscene.build_problem()

    tenv = TPointEnv(tcfg(CFG), device="cpu")
    before = kernels.min_dist_grid.launches
    tenv.compute_sdf_from_points(cloud)
    assert kernels.min_dist_grid.launches == before  # CPU: plain version
    tscene = TScene(tcfg(CFG), tenv)
    tscene.external_grasps = hands
    return dict(cloud=cloud, jenv=jenv, jscene=jscene, jprob=jprob,
                tenv=tenv, tscene=tscene,
                tmodel=interop.panda_model(
                    jax.tree.map(np.asarray, full.model), "cpu"),
                tprob=interop.plan_problem(jax.tree.map(np.asarray, jprob),
                                           "cpu"))


def test_cloud_and_grid_match_jax(staged):
    cloud = staged["cloud"]
    assert 300 < len(cloud) <= 3072
    jf, tf = staged["jenv"].objects[0].sdf, staged["tenv"].objects[0].sdf
    assert tf.shape == jf.shape
    np.testing.assert_array_equal(tf.origin, jf.origin)
    np.testing.assert_allclose(tf.data, jf.data, atol=1e-3)


def test_staged_grid_scene_matches_jax(staged):
    jstack = jax.tree.map(np.asarray, staged["jenv"].scene_sdf())
    tstack = staged["tenv"].scene_sdf()
    assert isinstance(tstack, tsdf.BakedSceneSDF)
    np.testing.assert_array_equal(tstack.limits.numpy(), jstack.limits)
    # value channel as the grid; the central-difference gradient channels
    # take (v[i+1] - v[i-1]) / (2 delta), so their bound is 1e-3 / delta
    delta = float(staged["tenv"].objects[0].sdf.delta)
    t4, j4 = tstack.data4.numpy(), jstack.data4
    np.testing.assert_allclose(t4[..., 0], j4[..., 0], atol=1e-3)
    np.testing.assert_allclose(t4[..., 1:], j4[..., 1:], atol=1e-3 / delta)
    jp = jax.tree.map(np.asarray, staged["jenv"].cost_params())
    tp = staged["tenv"].cost_params()
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      getattr(jp, name), name)


def test_world_potential_matches_jax(staged):
    jwp = jax.tree.map(np.asarray, staged["jprob"].world_potential)
    twp = staged["tscene"]._world_potential()
    jd, td = jwp.data, twp.data.numpy()
    assert td.shape == jd.shape and (jd > 0).sum() > 100
    bad = np.abs(td - jd) > 1e-4
    assert bad.mean() <= 1e-3, bad.sum()
    np.testing.assert_array_equal(twp.origin.numpy(), jwp.origin)


def test_perception_plan_fast_matches_jax(staged):
    jres = jax.tree.map(np.asarray, jax.jit(
        lambda m, p: jplan.plan_fast(m, CFG, p))(
            staged["jscene"].model, staged["jprob"]))
    tres = tplan.plan_fast(staged["tmodel"], tcfg(CFG), staged["tprob"])
    assert int(tres.goal_idx) == int(jres.goal_idx)
    assert bool(tres.flag) == bool(jres.flag)
    assert int(tres.steps_used) == int(jres.steps_used)
    np.testing.assert_allclose(tres.traj.numpy(), jres.traj, atol=2e-3)


def test_perception_plan_matches_jax(staged):
    jres = jax.tree.map(np.asarray, jax.jit(
        lambda m, p: jplan.plan(m, CFG, p))(
            staged["jscene"].model, staged["jprob"]))
    tres = tplan.plan(staged["tmodel"], tcfg(CFG), staged["tprob"])
    assert int(tres.goal_idx) == int(jres.goal_idx)
    assert bool(tres.flag) == bool(jres.flag)
    np.testing.assert_allclose(tres.traj.numpy(), jres.traj, atol=2e-3)
    np.testing.assert_allclose(tres.history.numpy(), jres.history, atol=2e-3)


def test_port_perception_cli_path_runs():
    """``python -m omg_planner_torch -p`` end to end on the CPU at CFG:
    the port's own goal set, cloud, grid, world potential and plan."""
    scene = perception_plan(tcfg(CFG), 5, 2, device="cpu")
    assert scene is not None and scene.external_grasps is not None
    res = scene.step(fast=True)
    assert res is not None
    assert res.traj.shape == (CFG.timesteps, 9)
    assert np.isfinite(res.traj).all()


@pytest.mark.gpu
def test_perception_on_card_matches_jax(staged):
    """The port's grid built on the card by the CUDA kernel, and the
    JAX-staged perception problem planned on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    env = TPointEnv(tcfg(CFG), device="cuda")
    before = kernels.min_dist_grid.launches
    env.compute_sdf_from_points(staged["cloud"])
    assert kernels.min_dist_grid.launches == before + 1
    jf = staged["jenv"].objects[0].sdf
    np.testing.assert_allclose(env.objects[0].sdf.data, jf.data, atol=1e-3)
    jres = jax.tree.map(np.asarray, jax.jit(
        lambda m, p: jplan.plan_fast(m, CFG, p))(
            staged["jscene"].model, staged["jprob"]))
    tres = tplan.plan_fast(
        interop.panda_model(staged["tmodel"], "cuda"), tcfg(CFG),
        interop.plan_problem(jax.tree.map(np.asarray, staged["jprob"]),
                             "cuda"))
    assert int(tres.goal_idx) == int(jres.goal_idx)
    assert bool(tres.flag) == bool(jres.flag)
    np.testing.assert_allclose(tres.traj.cpu().numpy(), jres.traj, atol=2e-3)
