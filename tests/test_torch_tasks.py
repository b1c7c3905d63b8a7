"""The task layer of the port (``planner/tasks.py`` and the scene's attach
API) against the JAX package on the CPU, as
``tests/test_peripherals.py`` exercises it.

Each package stages synthetic scene 0 itself (no obstacles, the small
config of ``test_peripherals``).  Where staging runs IK (``plan_to_target``
and ``place_target``), both packages' ``solve_goal_set`` is wrapped to
return its lanes in lane-index order: every lane survives the cap here,
so that fixes the order the greedy dedupe sees on both sides, which float
rounding decides otherwise (the lane-order fault, ``ROADMAP.md`` section
3).  The port's goal sampling gets the Gumbel noise JAX draws from its
scene key.

* ``attached_collision_points``: atol 1e-6.
* ``plan_to_target``: same verdict, goal and steps; trajectory within
  2e-3 (``tests/test_golden.py``'s bar).
* ``place_target`` on success and on the rollback without placement IK:
  same flag; achieved pose within 5e-3 m and 5e-3 rad; the scene ends
  detached with its cfg, hand points and staged state restored.
* ``plan_to_conf``: same verdict; trajectory within 2e-3."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.models import panda as jpanda
from omg_planner_tpu.ops import ik as jik
from omg_planner_tpu.planner import tasks as jtasks
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.models import panda as tpanda
from omg_planner_torch.ops import ik as tik
from omg_planner_torch.planner import scene as tscene
from omg_planner_torch.planner import tasks as ttasks
from test_golden import CFG

torch.set_num_threads(2)

SMALL = CFG.replace(optim_steps=4, extra_smooth_steps=2, goal_set_max_num=4,
                    ik_seed_num=2, ik_max_iters=25, learner_interp_steps=5)
GRASP_CONF = np.array([0.0, -0.8, 0.0, -2.0, 0.0, 1.6, 0.785, 0.04, 0.04])


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


@pytest.fixture
def scenes(monkeypatch):
    """(JAX scene, port scene) of synthetic scene 0, IK lanes in index
    order and the port sampling with JAX's first-build noise."""
    j_solve, t_solve = jik.solve_goal_set, tik.solve_goal_set

    def j_sorted(*a, **kw):
        out = j_solve(*a, **kw)
        order = jnp.argsort(out[3])
        return tuple(x[order] for x in out)

    def t_sorted(*a, **kw):
        out = t_solve(*a, **kw)
        order = torch.argsort(out[3])
        return tuple(x[order] for x in out)

    monkeypatch.setattr(jik, "solve_goal_set", j_sorted)
    monkeypatch.setattr(tik, "solve_goal_set", t_sorted)
    key = jax.random.split(jax.random.PRNGKey(233))[1]
    build = tscene.gs.build_goal_set

    def gumbel_fn(tag, n):
        k = jax.random.fold_in(key, 0x9d5) if tag == "prune" else key
        return torch.as_tensor(np.array(jax.random.gumbel(k, (n,))))

    monkeypatch.setattr(tscene.gs, "build_goal_set",
                        lambda *a, **kw: build(*a, gumbel_fn=gumbel_fn, **kw))
    js = JScene.synthetic(SMALL, scene_id=0, n_obstacles=0)
    ts = tscene.PlanningScene.synthetic(tcfg(SMALL), scene_id=0,
                                        n_obstacles=0, device="cpu")
    return js, ts


def _rot_err(a, b):
    r = a[:3, :3].T @ b[:3, :3]
    return float(np.arccos(np.clip((np.trace(r) - 1) / 2, -1.0, 1.0)))


def test_attached_collision_points_matches_jax():
    jm = jpanda.load_panda(collision_point_num=12)
    tm = tpanda.load_panda(12, "cpu")
    rng = np.random.default_rng(5)
    obj_points = rng.uniform(-0.03, 0.03, (500, 3))
    rel = np.eye(4)
    rel[:3, 3] = [0.0, 0.0, 0.1]  # the object 10 cm in front of the hand
    j = np.asarray(jtasks.attached_collision_points(jm, rel, obj_points))
    t = ttasks.attached_collision_points(tm, rel, obj_points)
    assert t.shape == tm.collision_points.shape and t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, atol=1e-6, rtol=0)
    assert not np.allclose(t.numpy()[-1], tm.collision_points.numpy()[-1])


def test_plan_to_target_matches_jax(scenes):
    js, ts = scenes
    start = np.asarray(js.start)
    name = js.env.target.name
    jres = jtasks.plan_to_target(js, start, name, fast=True)
    tres = ttasks.plan_to_target(ts, start, name, fast=True)
    assert tres is not None and jres is not None
    assert bool(tres.flag) == bool(jres.flag)
    assert int(tres.goal_idx) == int(jres.goal_idx)
    assert int(tres.steps_used) == int(jres.steps_used)
    np.testing.assert_allclose(tres.traj, jres.traj, atol=2e-3)


@pytest.mark.parametrize("where", ["reachable", "out_of_reach"])
def test_place_target_matches_jax(scenes, where):
    js, ts = scenes
    old_pose = js.env.target.pose_mat.copy()
    place = old_pose.copy()
    if where == "reachable":
        place[:3, 3] += [0.0, 0.15, 0.0]
    else:
        place[:3, 3] = [2.0, 0.0, 0.1]  # every placement IK fails
    base_points = ts.model.collision_points
    jres, jpose = jtasks.place_target(js, GRASP_CONF, place)
    version = ts.env.version
    tres, tpose = ttasks.place_target(ts, GRASP_CONF, place)
    assert (tres is None) == (jres is None)
    if jres is None:
        assert where == "out_of_reach"
        np.testing.assert_array_equal(tpose, old_pose)
    else:
        assert bool(tres.flag) == bool(jres.flag)
        np.testing.assert_allclose(tres.traj, jres.traj, atol=2e-3)
    np.testing.assert_allclose(tpose[:3, 3], jpose[:3, 3], atol=5e-3)
    assert _rot_err(tpose, jpose) < 5e-3
    np.testing.assert_allclose(ts.env.target.pose_mat, tpose)
    # detached, cfg and hand points restored; nothing staged survives
    assert not ts.env.target.attached and ts.env.target.rel_hand_pose is None
    assert ts.cfg == tcfg(SMALL)
    assert ts.model.collision_points is base_points
    assert ts.env.version > version and not ts.has_staged()
    ts.start = np.asarray(js.start)
    assert ts.step(fast=True) is not None


def test_plan_to_conf_matches_jax(scenes):
    js, ts = scenes
    start = np.asarray(js.start)
    end = GRASP_CONF
    jres = jtasks.plan_to_conf(js, start, end, disable_list=("table",),
                               fast=True)
    tres = ttasks.plan_to_conf(ts, start, end, disable_list=("table",),
                               fast=True)
    assert bool(tres.flag) == bool(jres.flag)
    assert int(tres.steps_used) == int(jres.steps_used)
    np.testing.assert_allclose(tres.traj, jres.traj, atol=2e-3)
    assert ts.cfg.goal_set_proj  # the session cfg is untouched
