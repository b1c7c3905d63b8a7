"""Headless JSON planning service (counterpart of
``omg_planner_tpu/apps/serve.py``).

Run:  ``python -m omg_planner_torch.apps.serve [--port 8009] [--cpu]``

It runs on ``cuda`` unless ``--cpu`` is given, and raises without a GPU.
One warm process keeps a request-keyed scene cache, so a repeated
workspace re-plans off its staged goal set with no staging work.

Endpoints (stdlib ``http.server``, single-threaded: the device serializes
plans anyway); response keys and status codes are the JAX service's:

* ``GET /health`` -> ``{"ok", "device", "requests"}``; ``device`` is the
  torch device and, on a GPU, the card's name.
* ``POST /plan`` -> body::

      {"objects": [{"name": str, "kind": "box|cylinder|sphere",
                    "extents": [..], "pose": [16 floats, row-major 4x4],
                    "target": bool}],
       "start": [9 floats]          (optional, default home config)
       "cfg": {field: value, ...}}  (optional OMGConfig overrides)

  response: ``{"flag", "steps_used", "goal_idx", "traj" [T, 9],
  "n_goals", "info": {reach, collide, smooth, execute, violate_limit},
  "timings": {stage_s, plan_s}}``; 400 for a malformed body, 422 when the
  goal set is empty (the reference's IK-FAIL "planning not run" path,
  ``omg/planner.py:651-652``), 500 for any other error.  A fresh scene
  stages and plans in one call (``PlanningScene.plan_fresh``): in eager
  PyTorch that call returns after the plan loop, so a fresh request's
  ``stage_s`` holds its plan and its ``plan_s`` only the harvest; a warm
  request's ``plan_s`` holds the plan.  The result comes back through the
  runner's flat pack: one copy into pinned host memory behind one CUDA
  event, not one read per field.
* ``POST /plan_batch`` -> ``{"scenes": [<plan body>, ...],
  "pipeline_depth": int}`` through the pipelined runner
  (``planner/runner.py::plan_pipelined``).
* ``POST /execute`` -> a ``/plan`` body (plus optional ``"density"`` and
  ``"exec_retries"``): plans, then executes the plan in the rigid-body
  stepper on the service's device (on a GPU one launch of the
  ``rigid_rollout`` kernel) and adds ``execution`` (the lift scorecard,
  ``physics.executor.PhysExecReport``) and ``timings.exec_s``.
  ``exec_retries > 0`` runs execution-verified planning
  (``planner/exec_verify.py``): the response then carries the verified
  (possibly re-planned) trajectory and ``execution.verified`` /
  ``execution.exec_attempts``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
import torch

from .. import resolve_device
from ..config import OMGConfig
from ..io.assets import make_primitive
from ..planner.plan import plan_fast
from ..planner.runner import PackedResult, plan_pipelined
from ..planner.scene import PlanningScene

def _build_scene(cfg: OMGConfig, spec: dict, device) -> PlanningScene:
    objs = []
    target = None
    for o in spec["objects"]:
        pose = np.asarray(o["pose"], np.float64).reshape(4, 4)
        obj = make_primitive(
            o["name"], o.get("kind", "box"), o.get("extents", [0.06]),
            pose, target=bool(o.get("target", False)),
            compute_grasp=bool(o.get("target", False))
            or o.get("compute_grasp", False))
        objs.append(obj)
        if o.get("target"):
            target = o["name"]
    if target is None:
        raise ValueError("no object marked target=true")
    scene = PlanningScene._from_objects(cfg, objs, target, device)
    if "start" in spec:
        scene.start = np.asarray(spec["start"], np.float64)
    return scene


_CFG_FIELDS = {f.name for f in dataclasses.fields(OMGConfig)}

#: request-keyed scene cache (the key includes ``cfg.jit_key()``): a
#: repeated workspace re-plans off the scene's staged goal set, whose own
#: key is (env version, start, ``cfg.jit_key()``)
_SCENE_CACHE: dict = {}
_SCENE_CACHE_CAP = 32


def _cached_scene(cfg: OMGConfig, body: dict, device) -> PlanningScene:
    key = (json.dumps(body.get("objects"), sort_keys=True),
           tuple(body.get("start", ())), cfg.jit_key(), str(device))
    scene = _SCENE_CACHE.get(key)
    if scene is None:
        scene = _build_scene(cfg, body, device)
        if len(_SCENE_CACHE) >= _SCENE_CACHE_CAP:
            _SCENE_CACHE.pop(next(iter(_SCENE_CACHE)))
        _SCENE_CACHE[key] = scene
    return scene


def _request_cfg(body: dict, base_cfg: OMGConfig):
    """(cfg, None) or (None, the 400 response) for a body's overrides."""
    overrides = body.get("cfg", {})
    bad = set(overrides) - _CFG_FIELDS
    if bad:
        return None, (400, {"error": f"unknown cfg fields: {sorted(bad)}"})
    return (base_cfg.replace(**overrides) if overrides else base_cfg), None


def plan_request(body: dict, base_cfg: OMGConfig,
                 device=None) -> tuple[int, dict]:
    """Handle one /plan body; returns (http_status, response_dict)."""
    cfg, err = _request_cfg(body, base_cfg)
    if err is not None:
        return err
    device = resolve_device(device)
    try:
        t0 = time.time()
        scene = _cached_scene(cfg, body, device)
        fused = None if scene.has_staged() else scene.plan_fresh()
        if fused is not None:
            res, goal_mask = fused
            stage_s = time.time() - t0
            t0 = time.time()
        else:
            # staged repeat (or a scene the fresh path does not cover):
            # assume_goals leaves the empty-goal-set check to the harvest
            problem = scene.build_problem(assume_goals=True)
            stage_s = time.time() - t0
            t0 = time.time()
            res = plan_fast(scene.model, scene.cfg, problem)
            goal_mask = problem.goal_set.mask
    except (KeyError, ValueError) as e:
        return 400, {"error": str(e)}
    res, n_goals = PackedResult(res, goal_mask).result()
    plan_s = time.time() - t0
    if n_goals == 0 and cfg.goal_set_proj:
        return 422, {"error": "IK FAIL: empty goal set (planning not run)"}
    return 200, {
        "flag": bool(res.flag),
        "steps_used": int(res.steps_used),
        "goal_idx": int(res.goal_idx),
        "traj": np.asarray(res.traj).tolist(),
        "n_goals": n_goals,
        "info": {
            "reach": float(res.info.reach),
            "collide": float(res.info.collide),
            "smooth": float(res.info.smooth),
            "execute": bool(res.info.execute),
            "violate_limit": bool(res.info.violate_limit),
        },
        "timings": {"stage_s": round(stage_s, 4),
                    "plan_s": round(plan_s, 4)},
    }


def execute_request(body: dict, base_cfg: OMGConfig,
                    device=None) -> tuple[int, dict]:
    """Handle /execute: plan, then replay the plan in the rigid-body
    stepper (:mod:`omg_planner_torch.physics`) and attach the lift-reward
    scorecard, so a client can gate on the simulated grasp.  Body knob
    ``"exec_retries"`` (default 0) enables execution-verified planning."""
    retries = int(body.get("exec_retries", 0))
    code, payload = plan_request(body, base_cfg, device)
    if code != 200:
        return code, payload
    if not payload["flag"]:
        payload["execution"] = {"reward": 0, "skipped": "plan failed"}
        return 200, payload
    from ..physics import NoMassModelError, execute_plan

    cfg, _ = _request_cfg(body, base_cfg)
    scene = _cached_scene(cfg, body, resolve_device(device))  # staged
    t0 = time.time()
    density = float(body.get("density", 300.0))
    try:
        if retries > 0:
            from ..planner.exec_verify import plan_execute_verified

            out = plan_execute_verified(scene, exec_retries=retries,
                                        density=density)
            if out is not None and out.report is not None:
                payload["execution"] = dict(
                    out.report.to_dict(), verified=out.verified,
                    exec_attempts=out.exec_attempts)
                # the verified (possibly re-planned) trajectory is the one
                # the client should execute
                payload["traj"] = np.asarray(out.result.traj).tolist()
                payload["flag"] = bool(np.asarray(out.result.flag))
                payload["goal_idx"] = int(np.asarray(out.result.goal_idx))
            else:
                reason = (out.reason if out is not None
                          else "re-plan refused (IK FAIL)")
                payload["execution"] = {"reward": 0, "skipped": reason}
        else:
            rep = execute_plan(scene, np.asarray(payload["traj"]),
                               density=density)
            payload["execution"] = rep.to_dict()
    except NoMassModelError as e:            # no mass model for this target
        payload["execution"] = {"reward": 0, "skipped": str(e)}
    payload["timings"]["exec_s"] = round(time.time() - t0, 4)
    return 200, payload


def plan_batch_request(body: dict, base_cfg: OMGConfig,
                       device=None) -> tuple[int, dict]:
    """Handle /plan_batch: ``{"scenes": [<plan body>, ...],
    "pipeline_depth": int}`` through the pipelined runner."""
    specs = body.get("scenes")
    if not isinstance(specs, list) or not specs:
        return 400, {"error": "scenes: non-empty list required"}
    cfg, err = _request_cfg(body, base_cfg)
    if err is not None:
        return err
    device = resolve_device(device)
    try:
        scenes = [(i, _build_scene(cfg, s, device))
                  for i, s in enumerate(specs)]
    except (KeyError, ValueError) as e:
        return 400, {"error": str(e)}
    depth = max(1, int(body.get("pipeline_depth", 4)))
    t0 = time.time()
    results = []
    for _sid, _sc, res, dt in plan_pipelined(scenes, cfg, depth=depth):
        if res is None:
            results.append({"flag": False, "no_goals": True})
            continue
        results.append({
            "flag": bool(res.flag),
            "steps_used": int(res.steps_used),
            "goal_idx": int(res.goal_idx),
            "traj": np.asarray(res.traj).tolist(),
            "wall_s": round(dt, 4),
        })
    wall = time.time() - t0
    return 200, {"results": results, "batch_wall_s": round(wall, 4),
                 "plans_per_s": round(len(results) / wall, 3)}


def _device_label(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def make_server(port: int, cfg: OMGConfig, device=None) -> HTTPServer:
    """The service on ``127.0.0.1:port``, planning on ``device`` (``cuda``
    unless the caller names another; raises without a GPU)."""
    device = resolve_device(device)
    state = {"requests": 0}

    class Handler(BaseHTTPRequestHandler):
        def _send(self, code: int, payload: dict):
            data = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {"ok": True, "device": _device_label(device),
                                 "requests": state["requests"]})
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            routes = {"/plan": plan_request,
                      "/plan_batch": plan_batch_request,
                      "/execute": execute_request}
            if self.path not in routes:
                self._send(404, {"error": "unknown path"})
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError as e:
                self._send(400, {"error": f"bad json: {e}"})
                return
            try:
                code, payload = routes[self.path](body, cfg, device)
            except Exception as e:  # keep the server alive
                code, payload = 500, {"error": f"{type(e).__name__}: {e}"}
            state["requests"] += 1
            self._send(code, payload)

        def log_message(self, fmt, *args):  # quiet
            pass

    return HTTPServer(("127.0.0.1", port), Handler)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8009)
    ap.add_argument("--cpu", action="store_true",
                    help="plan on the CPU instead of cuda")
    args = ap.parse_args(argv)
    srv = make_server(args.port, OMGConfig(silent=True),
                      device="cpu" if args.cpu else None)
    print(f"planning service on http://127.0.0.1:{args.port}")
    srv.serve_forever()


if __name__ == "__main__":
    main()
