"""The port's suite runner against the JAX package on the CPU.

* the flat result layout: a port PlanResult packed by the port and
  unpacked by the JAX package's ``_unpack_flat`` equals the port's own
  unpack;
* ``plan_pipelined(depth=2)`` over suite scenes 0-2, both packages
  planning the same JAX-built goal sets (``set_precomputed_goals``: IK
  lane order is rounding noise, ``ROADMAP.md`` queue 3), yields in order
  the same ``goal_idx``, ``flag`` and ``steps_used`` as the JAX runner and
  trajectories within atol 2e-3; the port's serial ``step(fast=True)``
  gives the same results;
* ``SuiteRunner`` resumes (``tests/test_apps.py::
  test_suite_runner_resumes``) and writes the shard keys the JAX runner
  writes."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from omg_planner_tpu.planner import runner as jrunner
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.planner import runner as trunner
from omg_planner_torch.planner.scene import PlanningScene as TScene
from test_apps import SMALL
from test_golden import CFG

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE = os.path.join(ROOT, "data", "suite_v2")
SIDS = (0, 1, 2)


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def jax_goals():
    """JAX-built goal sets of suite scenes 0-2 (valid lanes only)."""
    out = {}
    for sid in SIDS:
        js = JScene.from_npz(CFG, os.path.join(SUITE, f"scene_{sid}.npz"))
        g = jax.tree.map(np.asarray, js.build_goal_set())
        out[sid] = (g.grasps[g.mask], g.reach_grasps[g.mask])
    return out


def _scenes(cls, cfg, goals, sids=SIDS, **kw):
    out = []
    for sid in sids:
        sc = cls.from_npz(cfg, os.path.join(SUITE, f"scene_{sid}.npz"), **kw)
        sc.set_precomputed_goals(*goals[sid])
        out.append((sid, sc))
    return out


@pytest.fixture(scope="module")
def jax_pipelined(jax_goals):
    return [(sid, res) for sid, _, res, _ in jrunner.plan_pipelined(
        _scenes(JScene, CFG, jax_goals), CFG, depth=2)]


def _same(tres, jres):
    assert int(tres.goal_idx) == int(jres.goal_idx)
    assert bool(tres.flag) == bool(jres.flag)
    assert int(tres.steps_used) == int(jres.steps_used)
    np.testing.assert_allclose(np.asarray(tres.traj), np.asarray(jres.traj),
                               atol=2e-3)


def test_pack_is_readable_by_jax_unpack(jax_goals):
    cfg = tcfg(CFG)
    (_, sc), = _scenes(TScene, cfg, jax_goals, sids=(0,), device="cpu")
    problem = sc.build_problem()
    res = trunner.plan_fast(sc.model, cfg, problem)
    packed = trunner.PackedResult(res, problem.goal_set.mask)
    flat = packed.host.numpy()
    assert flat.dtype == np.float32 and flat.ndim == 1
    tres, tn = packed.result()
    jres, jn = jrunner._unpack_flat(flat, *packed.shapes)
    assert tn == jn == int(problem.goal_set.mask.sum())
    np.testing.assert_array_equal(tres.traj, jres.traj)
    np.testing.assert_array_equal(tres.goal_mask, jres.goal_mask)
    for f in trunner._SCALAR_FIELDS + ("cost_traj",):
        np.testing.assert_array_equal(getattr(tres.info, f),
                                      getattr(jres.info, f))
    for f in ("goal_idx", "steps_used", "flag"):
        assert getattr(tres, f) == getattr(jres, f)
    # and the port's unpack reads what the plan computed
    assert int(tres.goal_idx) == int(res.goal_idx)
    assert int(tres.steps_used) == int(res.steps_used)
    np.testing.assert_array_equal(tres.traj, res.traj.numpy())


def test_plan_pipelined_matches_jax(jax_goals, jax_pipelined):
    cfg = tcfg(CFG)
    out = [(sid, res) for sid, _, res, _ in trunner.plan_pipelined(
        _scenes(TScene, cfg, jax_goals, device="cpu"), cfg, depth=2)]
    assert [s for s, _ in out] == [s for s, _ in jax_pipelined] == list(SIDS)
    for (_, tres), (_, jres) in zip(out, jax_pipelined):
        assert tres is not None and jres is not None
        _same(tres, jres)


def test_serial_step_matches_pipelined(jax_goals, jax_pipelined):
    cfg = tcfg(CFG)
    for (sid, sc), (_, jres) in zip(
            _scenes(TScene, cfg, jax_goals, device="cpu"), jax_pipelined):
        _same(sc.step(fast=True), jres)


def test_suite_runner_resumes_with_jax_shard_keys(tmp_path):
    cfg = tcfg(SMALL)
    r = trunner.SuiteRunner(str(tmp_path / "torch"), cfg, n_obstacles=1,
                            device="cpu")
    out = r.run(range(2))
    assert out["total"] == 2
    # resume: nothing pending, nothing planned
    r2 = trunner.SuiteRunner(str(tmp_path / "torch"), cfg, n_obstacles=1,
                             device="cpu")
    assert r2.pending(range(2)) == []
    r2._make_scene = None  # would raise if a scene were made
    assert r2.run(range(2))["total"] == 2
    d = dict(np.load(tmp_path / "torch" / "scene_0.npz"))
    assert "traj" in d and "success" in d and "valid" in d
    jr = jrunner.SuiteRunner(str(tmp_path / "jax"), SMALL, n_obstacles=1)
    jr.run(range(2))
    for sid in range(2):
        tkeys = set(np.load(tmp_path / "torch" / f"scene_{sid}.npz").files)
        jkeys = set(np.load(tmp_path / "jax" / f"scene_{sid}.npz").files)
        assert tkeys == jkeys

