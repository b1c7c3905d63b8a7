"""The whole plan of the port against the JAX package on the CPU, on the
analytic backend at ``tests/test_golden.py::CFG``.

The JAX package stages each problem (goal set, initial goal and spline,
scene, cost parameters); ``interop`` carries it across, and both packages
plan it with ``plan_fast`` (the benchmark's early-exit loop) and ``plan``
(the CLI default, with per-step history).

Cases:
* synthetic scene 5, the golden-trajectory scene
  (``tests/golden_plan_analytic.npz``);
* suite scenes 0 and 4 with the in-plan blacklist checked from step 3 on
  every second step, so that the blacklist restart fires (both), the plan
  runs out its whole budget and fails (scene 4), and the executable-state
  snapshot and the final re-evaluation run.

Bars, as ``tests/test_golden.py``: equal ``goal_idx`` and ``flag``, and
``traj`` within atol 2e-3; also equal step counts and final goal masks."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from omg_planner_tpu.planner import plan as jplan
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.planner import plan as tplan
from omg_planner_torch.planner.scene import PlanningScene as TScene
from test_golden import CFG, GOLDEN_ANALYTIC

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLACKLIST_CFG = CFG.replace(inplan_blacklist_step=3, inplan_blacklist_every=2)
CASES = {
    "synthetic5": (CFG, None),
    "suite0_blacklist": (BLACKLIST_CFG, "scene_0.npz"),
    "suite4_blacklist_fail": (BLACKLIST_CFG, "scene_4.npz"),
}


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    cfg, npz = CASES[request.param]
    if npz is None:
        js = JScene.synthetic(cfg, scene_id=5, n_obstacles=2)
    else:
        js = JScene.from_npz(cfg, os.path.join(ROOT, "data", "suite_v2", npz))
    jprob = js.build_problem()
    return dict(name=request.param, cfg=cfg, js=js, jprob=jprob,
                tmodel=interop.panda_model(jax.tree.map(np.asarray, js.model),
                                           "cpu"),
                tprob=interop.plan_problem(jax.tree.map(np.asarray, jprob),
                                           "cpu"))


def _check_same(tres, jres):
    jres = jax.tree.map(np.asarray, jres)
    assert int(tres.goal_idx) == int(jres.goal_idx)
    assert bool(tres.flag) == bool(jres.flag)
    assert int(tres.steps_used) == int(jres.steps_used)
    np.testing.assert_array_equal(tres.goal_mask.numpy(), jres.goal_mask)
    np.testing.assert_allclose(tres.traj.numpy(), jres.traj, atol=2e-3)
    assert bool(tres.info.execute) == bool(jres.info.execute)
    np.testing.assert_allclose(float(tres.info.collide),
                               float(jres.info.collide))
    return jres


def test_plan_fast_matches_jax(case):
    cfg = case["cfg"]
    jres = jax.jit(lambda m, p: jplan.plan_fast(m, cfg, p))(
        case["js"].model, case["jprob"])
    tres = tplan.plan_fast(case["tmodel"], tcfg(cfg), case["tprob"])
    jres = _check_same(tres, jres)
    if case["name"] == "synthetic5":
        golden = np.load(GOLDEN_ANALYTIC)
        assert int(tres.goal_idx) == int(golden["goal_idx"])
        assert bool(tres.flag) == bool(golden["flag"])
        np.testing.assert_allclose(tres.traj.numpy(), golden["traj"],
                                   atol=2e-3)
    if case["name"] != "synthetic5":
        # the blacklist fired: the final mask lost the first goal's
        # neighbourhood
        assert (jres.goal_mask != np.asarray(case["jprob"].goal_set.mask)).any()
    if case["name"] == "suite4_blacklist_fail":
        assert int(jres.steps_used) == cfg.total_steps and not jres.flag


def test_plan_with_history_matches_jax(case):
    cfg = case["cfg"]
    jres = jax.jit(lambda m, p: jplan.plan(m, cfg, p))(
        case["js"].model, case["jprob"])
    tres = tplan.plan(case["tmodel"], tcfg(cfg), case["tprob"])
    jres = _check_same(tres, jres)
    assert tres.history.shape == jres.history.shape == (
        cfg.total_steps, cfg.timesteps, 9)
    np.testing.assert_allclose(tres.history.numpy(), jres.history,
                               atol=2e-3)
    np.testing.assert_array_equal(tres.selected_goals.numpy(),
                                  jres.selected_goals)
    np.testing.assert_array_equal(tres.info_history.terminate.numpy(),
                                  jres.info_history.terminate)
    np.testing.assert_allclose(tres.info_history.collide.numpy(),
                               jres.info_history.collide)


def test_port_scene_plans_end_to_end():
    """The port's own staging and plan on the CPU (``PlanningScene.step``,
    both loops): a successful, finite, in-limit plan of the golden scene.
    The goal set is the port's own draw, so goal indices are not compared
    with JAX's (see ``tests/test_torch_goal_set.py`` for why lane order
    differs)."""
    cfg = tcfg(CFG)
    scene = TScene.synthetic(cfg, scene_id=5, n_obstacles=2, device="cpu")
    for fast in (True, False):
        res = scene.step(fast=fast)
        assert res is not None and bool(res.flag)
        assert res.traj.shape == (cfg.timesteps, 9)
        assert np.isfinite(res.traj).all()
        lo = scene.model.joint_lower.numpy() - 1e-4
        hi = scene.model.joint_upper.numpy() + 1e-4
        assert ((res.traj >= lo) & (res.traj <= hi)).all()
    assert len(scene.history_trajectories) == cfg.total_steps


@pytest.mark.gpu
def test_plan_fast_on_card_matches_jax(case):
    """The same JAX-staged problems planned by the port on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = case["cfg"]
    jres = jax.jit(lambda m, p: jplan.plan_fast(m, cfg, p))(
        case["js"].model, case["jprob"])
    tres = tplan.plan_fast(
        interop.panda_model(jax.tree.map(np.asarray, case["js"].model),
                            "cuda"), tcfg(cfg),
        interop.plan_problem(jax.tree.map(np.asarray, case["jprob"]), "cuda"))
    _check_same(jax.tree.map(lambda t: t.cpu(), tres), jres)
