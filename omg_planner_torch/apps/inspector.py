"""Interactive scene inspector: click-to-pick / click-to-place in a browser
(counterpart of ``omg_planner_tpu/apps/inspector.py``).

Capability parity with the reference's mouse-driven trial loop
(``real_world/trial_mouse.py:347-419``: render scene, click an object to
grasp it, click a location to place it) without the 9k-line GL stack: a
stdlib ``http.server`` serves one self-contained HTML page that draws the
scene (top-down XY + side XZ canvases) from ``/state`` JSON and posts
clicks to ``/plan``, which drives the SAME task layer
(:mod:`omg_planner_torch.planner.tasks`) the scripted flows use.

Run:  ``python -m omg_planner_torch.apps.inspector [--port 8008] [--hard]
[--cpu]`` (plans on ``cuda`` unless ``--cpu``) then open
http://localhost:8008 .  Click an object = plan a grasp of it;
shift-click anywhere = place the current target at that (x, y) on the
support surface.  The end-effector path of the last plan is drawn in both
views; goal-set ghosts (valid grasp hand positions) render as rings.
Each request computes its robot geometry in one batched call on the
scene's device and reads it to the host once; ``/render.png`` is the
software rasterizer's frame, encoded with the standard library (no
matplotlib needed).
"""

from __future__ import annotations

import json
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..models import panda
from ..planner import tasks
from ..planner.scene import PlanningScene


def _robot_geometry(scene, q, qs=None):
    """Collision points of configuration ``q`` [L * P, 3] and the
    panda_hand positions of ``qs [N, 9]`` [N, 3]: one batched FK call on
    the scene's device, one host copy."""
    model = scene.model
    allq = np.asarray(q, np.float32)[None]
    if qs is not None:
        allq = np.concatenate([allq, np.asarray(qs, np.float32)])
    poses = panda.forward_kinematics_batch(
        model, torch.as_tensor(allq, device=scene.device),
        apply_offset=False)
    pts = panda.collision_point_positions(
        model, poses[0] @ model.center_offset).reshape(-1, 3)
    out = torch.cat([pts, poses[1:, 7, :3, 3]]).cpu().numpy()
    return out[:len(pts)], out[len(pts):]


def _png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of ``rgb [H, W, 3] uint8``."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, -1)], 1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


_PAGE = """<!DOCTYPE html>
<html><head><title>omg_planner_torch inspector</title><style>
 body { font-family: sans-serif; background: #16161a; color: #eee;
        margin: 1em; }
 canvas { background: #202028; border: 1px solid #444; margin-right: 1em; }
 #msg { margin-top: .6em; color: #9cf; min-height: 1.2em; }
 .lbl { color: #888; font-size: .8em; }
</style></head><body>
<h3>omg_planner_torch — scene inspector</h3>
<div class="lbl">click object = plan grasp &nbsp;|&nbsp; shift-click = place
 target at (x, y) &nbsp;|&nbsp; ee path of last plan in orange</div>
<div>
 <canvas id="top" width="520" height="520"></canvas>
 <canvas id="side" width="520" height="380"></canvas>
 <img id="r3d" width="320" height="240" style="border:1px solid #444;
      vertical-align: top" alt="shaded view"/>
</div>
<div id="msg">loading…</div>
<script>
const W = {xmin: -0.2, xmax: 1.1, ymin: -0.65, ymax: 0.65,
           zmin: -0.1, zmax: 1.2};
let state = null;
const top = document.getElementById('top'), side =
      document.getElementById('side');
function sxT(x){ return (x - W.xmin) / (W.xmax - W.xmin) * top.width; }
function syT(y){ return (1 - (y - W.ymin) / (W.ymax - W.ymin)) * top.height; }
function sxS(x){ return (x - W.xmin) / (W.xmax - W.xmin) * side.width; }
function szS(z){ return (1 - (z - W.zmin) / (W.zmax - W.zmin)) * side.height; }
function draw(){
  if (!state) return;
  const t = top.getContext('2d'), s = side.getContext('2d');
  t.clearRect(0, 0, top.width, top.height);
  s.clearRect(0, 0, side.width, side.height);
  for (const o of state.objects){
    const col = o.target ? '#e4c662' : '#5c7cba';
    const [x, y, z] = o.position;
    const r = Math.max(o.radius, 0.02);
    t.fillStyle = col; t.globalAlpha = 0.75;
    t.beginPath();
    t.arc(sxT(x), syT(y), r / (W.xmax - W.xmin) * top.width, 0, 7);
    t.fill(); t.globalAlpha = 1;
    t.fillStyle = '#ccc'; t.font = '11px sans-serif';
    t.fillText(o.name, sxT(x) + 4, syT(y) - 4);
    s.fillStyle = col; s.globalAlpha = 0.75;
    const h = Math.max(o.height, 0.04);
    s.fillRect(sxS(x) - 6, szS(z + h / 2),
               12, h / (W.zmax - W.zmin) * side.height);
    s.globalAlpha = 1;
  }
  // robot collision points (current configuration)
  t.fillStyle = '#7ad08a'; s.fillStyle = '#7ad08a';
  for (const p of state.robot_points){
    t.fillRect(sxT(p[0]) - 1, syT(p[1]) - 1, 2, 2);
    s.fillRect(sxS(p[0]) - 1, szS(p[2]) - 1, 2, 2);
  }
  // goal ghosts
  t.strokeStyle = '#c27ad0'; s.strokeStyle = '#c27ad0';
  for (const g of state.goal_ghosts){
    t.beginPath(); t.arc(sxT(g[0]), syT(g[1]), 4, 0, 7); t.stroke();
    s.beginPath(); s.arc(sxS(g[0]), szS(g[2]), 4, 0, 7); s.stroke();
  }
  // ee path
  if (state.ee_path.length){
    t.strokeStyle = '#e2873a'; s.strokeStyle = '#e2873a';
    t.beginPath(); s.beginPath();
    state.ee_path.forEach((p, i) => {
      if (i == 0){ t.moveTo(sxT(p[0]), syT(p[1]));
                   s.moveTo(sxS(p[0]), szS(p[2])); }
      else { t.lineTo(sxT(p[0]), syT(p[1]));
             s.lineTo(sxS(p[0]), szS(p[2])); }
    });
    t.stroke(); s.stroke();
  }
}
async function refresh(){
  state = await (await fetch('state')).json();
  document.getElementById('msg').textContent = state.message || 'ready';
  document.getElementById('r3d').src = 'render.png?' + Date.now();
  draw();
}
top.addEventListener('click', async ev => {
  const rect = top.getBoundingClientRect();
  const x = W.xmin + (ev.clientX - rect.left) / top.width * (W.xmax - W.xmin);
  const y = W.ymin + (1 - (ev.clientY - rect.top) / top.height)
            * (W.ymax - W.ymin);
  document.getElementById('msg').textContent = 'planning…';
  const body = ev.shiftKey ? {action: 'place', x: x, y: y}
                           : {action: 'pick', x: x, y: y};
  await fetch('plan', {method: 'POST', body: JSON.stringify(body)});
  await refresh();
});
refresh();
</script></body></html>
"""


class InspectorApp:
    """The planning scene + derived view state behind the HTTP handlers."""

    def __init__(self, scene: PlanningScene):
        self.scene = scene
        self.message = "ready"
        self.last_traj: np.ndarray | None = None
        self.lock = threading.Lock()

    # -- view state -------------------------------------------------------

    def state(self) -> dict:
        env = self.scene.env
        objects = []
        for o in env.objects:
            ext = (np.resize(np.asarray(o.extents, float), 3)
                   if o.extents is not None else np.full(3, 0.05))
            objects.append({
                "name": o.name,
                "target": bool(o.target),
                "position": [float(v) for v in o.pose_mat[:3, 3]],
                "radius": float(max(ext[0], ext[1]) / 2),
                "height": float(ext[-1]),
            })
        gs = self.scene.goal_set
        g = np.zeros((0, 9), np.float32)
        if gs is not None:
            g = gs.grasps.cpu().numpy()[gs.mask.cpu().numpy()][:24]
        ee_q = np.zeros((0, 9), np.float32)
        if self.last_traj is not None:
            ee_q = self.last_traj[:: max(len(self.last_traj) // 30, 1)]
        pts, hands = _robot_geometry(self.scene, self.scene.start,
                                     np.concatenate([g, ee_q]))
        robot_points = pts[::4]
        ghosts = hands[:len(g)].tolist()
        ee = hands[len(g):].tolist()
        return {
            "objects": objects,
            "robot_points": robot_points.tolist(),
            "goal_ghosts": ghosts,
            "ee_path": ee,
            "message": self.message,
        }

    def render_png(self) -> bytes:
        """Shaded 3-D view (software rasterizer) of the scene + the robot
        at the last plan's final configuration, as a PNG."""
        from ..viz.raster import render_rgb

        q = (self.last_traj[-1] if self.last_traj is not None
             else self.scene.start)
        rgb, _, _ = render_rgb(self.scene.env.objects, width=320, height=240,
                               robot_points=_robot_geometry(self.scene,
                                                            q)[0])
        return _png(rgb)

    # -- actions ----------------------------------------------------------

    def _nearest_object(self, x: float, y: float) -> str | None:
        best, best_d = None, 0.15
        for o in self.scene.env.objects:
            d = float(np.hypot(o.pose_mat[0, 3] - x, o.pose_mat[1, 3] - y))
            if d < best_d:
                best, best_d = o.name, d
        return best

    def plan(self, req: dict) -> dict:
        with self.lock:
            if req.get("action") == "pick":
                name = req.get("target") or self._nearest_object(
                    float(req["x"]), float(req["y"]))
                if name is None:
                    self.message = "no object near click"
                    return {"ok": False, "message": self.message}
                res = tasks.plan_to_target(
                    self.scene, self.scene.start, name, fast=True)
                if res is None:
                    self.message = f"{name}: no reachable grasps"
                    return {"ok": False, "message": self.message}
                self.last_traj = np.asarray(res.traj)
                verdict = "SUCCESS" if bool(res.flag) else "FAIL"
                self.message = (f"pick {name}: {verdict}, "
                                f"{int(res.steps_used)} steps")
                return {"ok": bool(res.flag), "message": self.message,
                        "steps": int(res.steps_used),
                        "traj": self.last_traj.tolist()}
            if req.get("action") == "place":
                t = self.scene.env.target
                if self.last_traj is None:
                    self.message = "pick first, then place"
                    return {"ok": False, "message": self.message}
                place = np.array(t.pose_mat)
                place[0, 3] = float(req["x"])
                place[1, 3] = float(req["y"])
                if "z" in req:
                    place[2, 3] = float(req["z"])
                res, achieved = tasks.place_target(
                    self.scene, self.last_traj[-1], place, fast=True)
                if res is None:
                    self.message = "place: no placement IK"
                    return {"ok": False, "message": self.message}
                self.last_traj = np.asarray(res.traj)
                verdict = "SUCCESS" if bool(res.flag) else "FAIL"
                self.message = (f"place {t.name} at "
                                f"({place[0, 3]:.2f}, {place[1, 3]:.2f}): "
                                f"{verdict}")
                return {"ok": bool(res.flag), "message": self.message,
                        "traj": self.last_traj.tolist(),
                        "achieved": np.asarray(achieved).tolist()}
            self.message = f"unknown action {req.get('action')!r}"
            return {"ok": False, "message": self.message}


def make_server(app: InspectorApp, host: str = "127.0.0.1",
                port: int = 8008) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def _send(self, body: bytes, ctype: str):
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path.rstrip("/") in ("", "/index.html"):
                self._send(_PAGE.encode(), "text/html")
            elif self.path.lstrip("/") == "state":
                self._send(json.dumps(app.state()).encode(),
                           "application/json")
            elif self.path.lstrip("/").split("?")[0] == "render.png":
                self._send(app.render_png(), "image/png")
            else:
                self.send_error(404)

        def do_POST(self):
            if self.path.lstrip("/") != "plan":
                self.send_error(404)
                return
            n = int(self.headers.get("Content-Length", 0))
            req = json.loads(self.rfile.read(n) or b"{}")
            self._send(json.dumps(app.plan(req)).encode(),
                       "application/json")

        def log_message(self, *a):  # quiet
            pass

    return ThreadingHTTPServer((host, port), Handler)


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=8008)
    ap.add_argument("--scene", type=int, default=0)
    ap.add_argument("--hard", action="store_true",
                    help="a hard-suite scene instead of the simple tabletop")
    ap.add_argument("--obstacles", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="plan on the CPU instead of cuda")
    args = ap.parse_args(argv)

    from .. import resolve_device
    from ..config import OMGConfig

    cfg = OMGConfig(silent=True)
    device = resolve_device("cpu" if args.cpu else None)
    scene = (PlanningScene.hard(cfg, scene_id=args.scene, device=device)
             if args.hard else
             PlanningScene.synthetic(cfg, scene_id=args.scene,
                                     n_obstacles=args.obstacles,
                                     device=device))
    app = InspectorApp(scene)
    srv = make_server(app, port=args.port)
    print(f"inspector on http://127.0.0.1:{args.port} "
          f"({len(scene.env.objects)} objects; first plan compiles, "
          f"be patient)")
    srv.serve_forever()


if __name__ == "__main__":
    main()
