"""Execution-verified planning in the port
(``omg_planner_torch/planner/exec_verify.py``): the seven cases of
``tests/test_exec_verify.py`` on the port's scene, with the stepper stubbed
where the JAX tests stub it.  The first case executes for real (the plain
rollout on the CPU)."""

import numpy as np
import pytest
import torch

import omg_planner_torch.physics as phys
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.planner import exec_verify as ev
from omg_planner_torch.planner.exec_verify import (ExecVerifiedOut,
                                                   plan_execute_verified)
from omg_planner_torch.planner.scene import PlanningScene

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    cfg = OMGConfig(silent=True, optim_steps=15, extra_smooth_steps=5,
                    goal_set_max_num=12, ik_seed_num=3, ik_max_iters=30,
                    learner_interp_steps=10)
    return PlanningScene.synthetic(cfg, scene_id=0, n_obstacles=1,
                                   device="cpu")


def _report(reward, lifted, hand):
    return phys.PhysExecReport(reward, lifted, hand, 0.0, 0.1, 0.02, 0.3)


def test_verified_on_first_attempt(scene):
    out = plan_execute_verified(scene, exec_retries=2)
    assert out is not None and out.verified
    assert out.exec_attempts == 1
    assert out.report.reward == 1


def test_failed_lift_triggers_goal_blacklist_replan(scene, monkeypatch):
    calls = {"n": 0, "trajs": []}
    ok = _report(1, 0.3, 0.1)
    fail = _report(0, 0.0, 0.5)

    def fake_execute(sc, traj, **kw):
        calls["n"] += 1
        calls["trajs"].append(np.asarray(traj).copy())
        return fail if calls["n"] == 1 else ok

    monkeypatch.setattr(phys, "execute_plan", fake_execute)
    out = plan_execute_verified(scene, exec_retries=2)
    assert out.verified and out.exec_attempts == 2
    # the retry executed a different trajectory (a new goal)
    assert not np.allclose(calls["trajs"][0], calls["trajs"][1])


def test_exhaustion_returns_least_bad(scene, monkeypatch):
    calls = {"n": 0}
    reports = [_report(0, 0.0, 0.5), _report(0, 0.2, 0.25),
               _report(0, 0.0, 0.6)]

    def fake_execute(sc, traj, **kw):
        r = reports[min(calls["n"], len(reports) - 1)]
        calls["n"] += 1
        return r

    monkeypatch.setattr(phys, "execute_plan", fake_execute)
    out = plan_execute_verified(scene, exec_retries=2)
    assert isinstance(out, ExecVerifiedOut)
    assert not out.verified
    assert out.exec_attempts == calls["n"]
    assert out.report.hand_dist_m == pytest.approx(0.25)


def test_no_mass_model_returns_unverified(scene, monkeypatch):
    def raise_nmm(sc, traj, **kw):
        raise phys.NoMassModelError("stub")

    monkeypatch.setattr(phys, "execute_plan", raise_nmm)
    out = plan_execute_verified(scene, exec_retries=2)
    assert out is not None and not out.verified
    assert out.report is None and out.reason == "no mass model"
    assert bool(np.asarray(out.result.flag))


class _FakeRes:
    flag = np.bool_(True)
    traj = np.zeros((4, 9), np.float32)
    goal_idx = np.int32(0)
    goal_mask = None


def test_plan_failure_routes_through_cascade(monkeypatch):
    calls = {"cascade": 0}

    class FakeCascadeResult:
        result = _FakeRes()

    def fake_cascade(scene, fast=True):
        calls["cascade"] += 1
        return FakeCascadeResult()

    class FakeGoalSet:
        grasps = np.zeros((4, 9), np.float32)
        mask = np.ones(4, bool)

    class FakeScene:
        goal_set = FakeGoalSet()

        def step(self, fast=True, goal_mask=None):
            return None                     # IK-FAIL refusal

    monkeypatch.setattr(ev, "plan_cascade", fake_cascade)
    monkeypatch.setattr(phys, "execute_plan",
                        lambda sc, traj, **kw: _report(1, 0.3, 0.1))
    out = ev.plan_execute_verified(FakeScene(), exec_retries=1, cascade=True)
    assert calls["cascade"] == 1
    assert out is not None and out.verified


def test_plan_failure_without_cascade_returns_none():
    class FakeScene:
        def step(self, fast=True, goal_mask=None):
            return None

    assert ev.plan_execute_verified(FakeScene(), exec_retries=1) is None


def test_cascade_backend_pinned_for_retries_then_restored(monkeypatch):
    """A recovery on another backend pins that backend's cfg for the retry
    re-plans, and the session cfg comes back afterwards."""
    base = OMGConfig(silent=True)
    assert base.sdf_analytic

    class FakeCR:
        result = _FakeRes()
        backend = "exact"

    class FakeGoalSet:
        grasps = np.arange(36, dtype=np.float32).reshape(4, 9)
        mask = np.ones(4, bool)

    cfgs_seen = []

    class FakeScene:
        cfg = base
        goal_set = FakeGoalSet()

        def step(self, fast=True, goal_mask=None):
            if goal_mask is None:
                return None              # the primary plan refuses
            cfgs_seen.append(self.cfg)   # a retry re-plan: record the cfg
            r = _FakeRes()
            r.goal_idx = np.int32(int(np.nonzero(goal_mask)[0][0]))
            return r

        def _sync_env_cfg(self):
            pass

    monkeypatch.setattr(ev, "plan_cascade", lambda sc, fast=True: FakeCR())
    calls = {"n": 0}

    def fake_exec(sc, traj, **kw):
        calls["n"] += 1
        return _report(0, 0.0, 0.5) if calls["n"] == 1 else _report(1, 0.3,
                                                                     0.1)

    monkeypatch.setattr(phys, "execute_plan", fake_exec)
    sc = FakeScene()
    out = ev.plan_execute_verified(sc, exec_retries=2, cascade=True)
    assert out is not None and out.verified
    assert cfgs_seen and all(not c.sdf_analytic for c in cfgs_seen)
    assert sc.cfg is base
