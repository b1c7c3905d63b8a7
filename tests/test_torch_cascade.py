"""The port's escalation cascade against the JAX package on the CPU.

Both packages plan the same JAX-built goal sets (``set_precomputed_goals``;
IK lane order is rounding noise, ``ROADMAP.md`` queue 3).  Suite scene 0
FAILs on the analytic backend at ``tests/test_golden.py::CFG``, so the
cascade runs its goal-blacklist retries and, with a strangled budget, the
exact grid fallback; both packages choose the same backend, make the same
number of attempts and reach the same verdict.  ``plan_cascade_suite``
over two scenes likewise."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from omg_planner_tpu.planner import cascade as jcascade
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.planner import cascade as tcascade
from omg_planner_torch.planner.scene import PlanningScene as TScene
from test_golden import CFG

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE = os.path.join(ROOT, "data", "suite_v2")
# every attempt runs out of budget: the exact fallback must run too
STRANGLED = CFG.replace(optim_steps=2, extra_smooth_steps=0,
                        pre_terminate=False)


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def jax_goals():
    out = {}
    for sid in (0, 1):
        js = JScene.from_npz(CFG, os.path.join(SUITE, f"scene_{sid}.npz"))
        g = jax.tree.map(np.asarray, js.build_goal_set())
        out[sid] = (g.grasps[g.mask], g.reach_grasps[g.mask])
    return out


def _scene(cls, cfg, goals, sid, **kw):
    sc = cls.from_npz(cfg, os.path.join(SUITE, f"scene_{sid}.npz"), **kw)
    sc.set_precomputed_goals(*goals[sid])
    return sc


@pytest.mark.parametrize("cfg", [CFG, STRANGLED], ids=["retry", "fallback"])
def test_plan_cascade_matches_jax(cfg, jax_goals):
    js = _scene(JScene, cfg, jax_goals, 0)
    first = js.step(fast=True)
    assert not bool(first.flag)  # the analytic plan FAILs
    jout = jcascade.plan_cascade(js, backends=("analytic", "exact"))
    ts = _scene(TScene, tcfg(cfg), jax_goals, 0, device="cpu")
    tout = tcascade.plan_cascade(ts, backends=("analytic", "exact"))
    assert (tout.backend, tout.attempts, tout.success) == \
        (jout.backend, jout.attempts, jout.success)
    assert int(tout.result.goal_idx) == int(jout.result.goal_idx)
    np.testing.assert_allclose(tout.result.traj, np.asarray(jout.result.traj),
                               atol=2e-3)
    assert tout.attempts > 1  # a blacklist retry or the fallback ran
    if cfg is STRANGLED:
        # every analytic attempt failed, so the exact backend planned
        assert tout.attempts > 1 + 3 or tout.backend == "exact"
    assert ts.cfg == tcfg(cfg)  # the session cfg is restored


def test_plan_cascade_suite_matches_jax(jax_goals):
    cfg = STRANGLED
    jouts = jcascade.plan_cascade_suite(
        [(sid, _scene(JScene, cfg, jax_goals, sid)) for sid in (0, 1)],
        cfg, chunk=2)
    tscenes = [(sid, _scene(TScene, tcfg(cfg), jax_goals, sid, device="cpu"))
               for sid in (0, 1)]
    touts = tcascade.plan_cascade_suite(tscenes, tcfg(cfg), chunk=2)
    assert set(touts) == set(jouts) == {0, 1}
    for sid in (0, 1):
        t, j = touts[sid], jouts[sid]
        assert (t.backend, t.attempts, t.flag, t.goal_idx) == \
            (j.backend, j.attempts, j.flag, j.goal_idx)
        np.testing.assert_allclose(t.traj, j.traj, atol=2e-3)
    assert any(o.backend == "exact" for o in touts.values())
    for _, sc in tscenes:
        assert sc.cfg == tcfg(cfg) and sc.env._scene_sdf is None
