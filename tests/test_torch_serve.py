"""The port's planning service (``omg_planner_torch/apps/serve.py``) on the
CPU, mirroring ``tests/test_serve.py``: the same requests and every one of
its assertions for ``/health``, ``/plan`` (fresh, then warm with a smaller
``stage_s``), the 400s, ``/plan_batch`` and ``/execute`` (200, the lift
scorecard under ``execution``, ``timings.exec_s``; the rollout runs as the
plain loop on the CPU).

Against the JAX service: the ``/plan`` response has exactly the JAX
response's keys, and ``plan_request`` gives JAX's ``flag`` on the same
body.  ``plan_fresh`` (the fresh request's one-call build and plan)
matches ``step(fast=True)`` (trajectory atol 2e-3, ``tests/test_golden.py``
's bar) and gives None under ``dynamic_timestep``.  A warm request
re-stages nothing: it takes no IK and no more host syncs than its plan."""

import dataclasses
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

from omg_planner_tpu.apps import serve as jserve
from omg_planner_tpu.config import OMGConfig as JConfig
from omg_planner_torch.apps import serve as tserve
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.io.assets import pose_at
from omg_planner_torch.planner import scene as tscene
from omg_planner_torch.planner.scene import PlanningScene
from omg_planner_torch.utils.sync import SYNCS

torch.set_num_threads(2)

PORT = 8823  # tests/test_serve.py holds 8811


def _small_cfg(cls=OMGConfig):
    return cls(silent=True, optim_steps=12, extra_smooth_steps=4,
               goal_set_max_num=10, ik_seed_num=2, ik_max_iters=25,
               learner_interp_steps=8)


def _post(path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{PORT}{path}", method="POST",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _scene_body():
    return {
        "objects": [
            {"name": "table", "kind": "box", "extents": [0.9, 1.2, 0.04],
             "pose": np.asarray(pose_at([0.55, 0.0, 0.16])).ravel().tolist()},
            {"name": "mug", "kind": "cylinder", "extents": [0.045, 0.1],
             "pose": np.asarray(pose_at([0.55, 0.1, 0.23])).ravel().tolist(),
             "target": True},
        ],
    }


@pytest.fixture(scope="module")
def server():
    srv = tserve.make_server(PORT, _small_cfg(), device="cpu")
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    t.join()


def test_serve_plan_roundtrip(server, monkeypatch):
    builds = []
    real = tscene.gs.build_goal_set
    monkeypatch.setattr(tscene.gs, "build_goal_set",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    with urllib.request.urlopen(f"http://127.0.0.1:{PORT}/health") as r:
        h = json.loads(r.read())
    assert h["ok"] and h["device"] == "cpu" and set(h) == {
        "ok", "device", "requests"}

    code, out = _post("/plan", _scene_body())
    assert code == 200, out
    traj = np.asarray(out["traj"])
    assert traj.shape[1] == 9 and np.isfinite(traj).all()
    assert out["n_goals"] > 0
    assert out["timings"]["plan_s"] > 0
    assert len(builds) == 1

    # warm second request: the staged goal set, no IK, no staging reads
    s0 = SYNCS.count
    code2, out2 = _post("/plan", _scene_body())
    warm_syncs = SYNCS.count - s0
    assert code2 == 200
    assert out2["timings"]["stage_s"] < out["timings"]["stage_s"]
    assert len(builds) == 1
    assert warm_syncs <= out2["steps_used"] + 8
    assert out2["traj"] == out["traj"]

    # malformed: unknown cfg field
    bad = _scene_body()
    bad["cfg"] = {"not_a_field": 1}
    code3, out3 = _post("/plan", bad)
    assert code3 == 400 and "unknown cfg" in out3["error"]

    # no target object
    nt = _scene_body()
    nt["objects"][1]["target"] = False
    code4, out4 = _post("/plan", nt)
    assert code4 == 400

    # pipelined batch endpoint
    body = _scene_body()
    b2 = _scene_body()
    b2["objects"][1]["pose"] = np.asarray(
        pose_at([0.5, -0.12, 0.23])).ravel().tolist()
    code5, out5 = _post("/plan_batch",
                        {"scenes": [body, b2], "pipeline_depth": 2})
    assert code5 == 200, out5
    assert len(out5["results"]) == 2
    for r5 in out5["results"]:
        assert "traj" in r5 and np.isfinite(np.asarray(r5["traj"])).all()
    assert out5["plans_per_s"] > 0

    # batch errors surface as 400s
    code6, _ = _post("/plan_batch", {"scenes": []})
    assert code6 == 400

    # plan, then execute in the rigid-body stepper
    code7, out7 = _post("/execute", _scene_body())
    assert code7 == 200, out7
    assert out7["execution"]["reward"] in (0, 1)
    assert out7["timings"]["exec_s"] > 0
    if out7["flag"]:
        assert set(out7["execution"]) >= {"lifted_m", "hand_dist_m",
                                          "grasp_impulse"}
    assert _post("/nowhere", {})[0] == 404


def test_plan_response_matches_jax():
    """Same keys, letter for letter, and the same verdict."""
    body = _scene_body()
    jcode, jout = jserve.plan_request(body, _small_cfg(JConfig))
    tcode, tout = tserve.plan_request(body, _small_cfg(), device="cpu")
    assert jcode == tcode == 200
    assert set(tout) == set(jout)
    assert set(tout["info"]) == set(jout["info"])
    assert set(tout["timings"]) == set(jout["timings"])
    assert tout["flag"] == jout["flag"]
    assert np.asarray(tout["traj"]).shape == np.asarray(jout["traj"]).shape


def test_plan_fresh_matches_step():
    cfg = _small_cfg()
    s1 = PlanningScene.synthetic(cfg, scene_id=2, n_obstacles=1,
                                 device="cpu")
    fused = s1.plan_fresh()
    assert fused is not None
    r_f, mask = fused
    assert s1.has_staged() and int(mask.sum()) > 0
    s2 = PlanningScene.synthetic(cfg, scene_id=2, n_obstacles=1,
                                 device="cpu")
    r_s = s2.step(fast=True)
    assert bool(r_f.flag) == bool(r_s.flag)
    np.testing.assert_allclose(r_f.traj.numpy(), r_s.traj, atol=2e-3)
    s3 = PlanningScene.synthetic(
        dataclasses.replace(cfg, dynamic_timestep=True), scene_id=2,
        n_obstacles=1, device="cpu")
    assert s3.plan_fresh() is None
