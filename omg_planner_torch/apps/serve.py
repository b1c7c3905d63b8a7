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
  stages and plans in one call (``PlanningScene.plan_fresh``); ``stage_s``
  runs to the plan loop's start (the host mark ``plan_fresh`` keeps, no
  device synchronise) and ``plan_s`` from there through the harvest, on
  the fresh path as on the warm one.  The result comes back through the
  runner's flat pack: one copy into pinned host memory behind one CUDA
  event, not one read per field.
* ``POST /plan_cloud`` -> body::

      {"points": [[x, y, z], ...],  (the observed obstacle cloud, world)
       "grasps": [[16 floats], ...]  (world panda_hand poses, row-major
                                      4x4; or [K, 4, 4])
       "start": [9 floats]          (optional)
       "cfg": {field: value, ...}}  (optional)

  plans from an observed cloud, as the reference's perception mode
  (``omg/core.py:826-867``, ``python -m omg_planner_torch -p``): a
  ``PointEnv`` with the cloud's 0.02 m distance grid (0.24 m margin) and
  the grasps as external grasps, through ``/plan``'s core, cache and
  harvest (external grasps take the general path: ``build_problem``, then
  ``plan_fast``).  ``/plan``'s response, and its 400 / 422 / 500 rules:
  400 also for points that are not [N, 3] or grasps that are not [K, 16]
  or [K, 4, 4].  The cache keys a cloud by a digest of its points' and
  grasps' float32 bytes.
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

Each handler's work is a ``request`` span of ``utils/timing.py`` (on while
tracing is), with the scene build (``scene_build``; for a cloud its
``scene_build.cloud``: the body's arrays, the distance grid and its read
back, the ``PointEnv``), the goal-set build and the plan loop (in
``planner/``) and the harvest inside it.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
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
from ..planner.scene import PlanningScene, PointEnv
from ..utils import timing

def _build_scene(cfg: OMGConfig, spec: dict, device) -> PlanningScene:
    with timing.span("scene_build"):
        objs = []
        target = None
        with timing.span("scene_build.objects"):
            for o in spec["objects"]:
                pose = np.asarray(o["pose"], np.float64).reshape(4, 4)
                obj = make_primitive(
                    o["name"], o.get("kind", "box"),
                    o.get("extents", [0.06]), pose,
                    target=bool(o.get("target", False)),
                    compute_grasp=bool(o.get("target", False))
                    or o.get("compute_grasp", False))
                objs.append(obj)
                if o.get("target"):
                    target = o["name"]
        if target is None:
            raise ValueError("no object marked target=true")
        with timing.span("scene_build.scene"):
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


def _cached(key, build) -> PlanningScene:
    """The scene cached under ``key``, or ``build()``'s, kept (the oldest
    entry dropped past the cap)."""
    scene = _SCENE_CACHE.get(key)
    if scene is None:
        scene = build()
        if len(_SCENE_CACHE) >= _SCENE_CACHE_CAP:
            _SCENE_CACHE.pop(next(iter(_SCENE_CACHE)))
        _SCENE_CACHE[key] = scene
    return scene


def _cached_scene(cfg: OMGConfig, body: dict, device) -> PlanningScene:
    key = (json.dumps(body.get("objects"), sort_keys=True),
           tuple(body.get("start", ())), cfg.jit_key(), str(device))
    return _cached(key, lambda: _build_scene(cfg, body, device))


def _cloud_arrays(body: dict) -> tuple:
    """(points [N, 3], grasps [K, 4, 4]) of a ``/plan_cloud`` body as
    float32 arrays; ValueError where they are not those shapes of finite
    numbers.  An empty cloud is [0, 3] (``pointsdf.grid_layout`` places
    its grid as the reference does)."""
    try:
        points = np.asarray(body["points"], np.float32)
        grasps = np.asarray(body["grasps"], np.float32)
    except (TypeError, ValueError) as e:
        raise ValueError(f"points and grasps must be arrays of numbers: "
                         f"{e}") from None
    if points.shape == (0,):
        points = points.reshape(0, 3)
    if points.ndim != 2 or points.shape[1] != 3:
        raise ValueError(f"points must be [N, 3], got {list(points.shape)}")
    if grasps.ndim == 2 and grasps.shape[1] == 16:
        grasps = grasps.reshape(-1, 4, 4)
    if grasps.ndim != 3 or grasps.shape[1:] != (4, 4) or not len(grasps):
        raise ValueError(f"grasps must be [K, 16] or [K, 4, 4] with K > 0, "
                         f"got {list(grasps.shape)}")
    if not (np.isfinite(points).all() and np.isfinite(grasps).all()):
        raise ValueError("points and grasps must be finite")
    return points, grasps


def _build_cloud_scene(cfg: OMGConfig, points, grasps, start,
                       device) -> PlanningScene:
    """The perception scene of a cloud (``__main__.perception_plan`` once
    its cloud and grasps are made): a ``PointEnv`` with the cloud's
    distance grid at the reference's 0.02 m and 0.24 m margin, the grasps
    as external grasps."""
    env = PointEnv(cfg, device=device)
    env.compute_sdf_from_points(points)
    scene = PlanningScene(cfg, env)
    scene.external_grasps = grasps
    if start is not None:
        scene.start = np.asarray(start, np.float64)
    return scene


def _cloud_scene(cfg: OMGConfig, body: dict, device) -> PlanningScene:
    """The cached scene of a ``/plan_cloud`` body, keyed by a digest of
    its points' and grasps' float32 bytes.  The body's arrays are needed
    for the key, so the span holds their parse on a repeat too."""
    with timing.span("scene_build"), timing.span("scene_build.cloud"):
        points, grasps = _cloud_arrays(body)
        digest = hashlib.blake2b(digest_size=16)
        digest.update(points.tobytes())
        digest.update(grasps.tobytes())
        key = ("cloud", len(points), digest.hexdigest(),
               tuple(body.get("start", ())), cfg.jit_key(), str(device))
        return _cached(key, lambda: _build_cloud_scene(
            cfg, points, grasps, body.get("start"), device))


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
    with timing.request():
        return _plan(body, base_cfg, device)


def plan_cloud_request(body: dict, base_cfg: OMGConfig,
                       device=None) -> tuple[int, dict]:
    """Handle one /plan_cloud body (an observed cloud and grasps);
    returns (http_status, response_dict) as :func:`plan_request`."""
    with timing.request():
        return _plan(body, base_cfg, device, _cloud_scene)


def _plan(body: dict, base_cfg: OMGConfig, device,
          scene_of=_cached_scene) -> tuple[int, dict]:
    """The plan of a body whose scene ``scene_of(cfg, body, device)``
    gives (cached), and the response."""
    cfg, err = _request_cfg(body, base_cfg)
    if err is not None:
        return err
    device = resolve_device(device)
    try:
        t0 = time.perf_counter_ns()
        scene = scene_of(cfg, body, device)
        fused = None if scene.has_staged() else scene.plan_fresh()
        if fused is not None:
            res, goal_mask = fused
            t_plan = timing.marked("plan_fresh.plan")
        else:
            # staged repeat (or a scene the fresh path does not cover):
            # assume_goals leaves the empty-goal-set check to the harvest
            problem = scene.build_problem(assume_goals=True)
            t_plan = time.perf_counter_ns()
            res = plan_fast(scene.model, scene.cfg, problem)
            goal_mask = problem.goal_set.mask
    except (KeyError, ValueError) as e:
        return 400, {"error": str(e)}
    res, n_goals = PackedResult(res, goal_mask).result()
    stage_s = (t_plan - t0) * 1e-9
    plan_s = (time.perf_counter_ns() - t_plan) * 1e-9
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
    with timing.request():
        return _execute(body, base_cfg, device)


def _execute(body: dict, base_cfg: OMGConfig, device) -> tuple[int, dict]:
    retries = int(body.get("exec_retries", 0))
    code, payload = _plan(body, base_cfg, device)
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
    with timing.request():
        return _plan_batch(body, base_cfg, device)


def _plan_batch(body: dict, base_cfg: OMGConfig,
                device) -> tuple[int, dict]:
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
                      "/plan_cloud": plan_cloud_request,
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
