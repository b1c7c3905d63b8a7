"""The port's scene inspector (``apps/inspector.py``) on the CPU: the JAX
package's four server tests (``tests/test_inspector.py``) on the port's
server, and ``/state``'s view geometry against JAX's app on the same
scene.

Tolerances, and why: ``robot_points``, ``goal_ghosts`` and ``ee_path``
against JAX's app given the same start, goal set and last trajectory:
1e-4 m (float32 FK in both packages, batched in the port);
``/render.png`` decodes to exactly the port's raster frame."""

import io
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.apps.inspector import InspectorApp as JApp
from omg_planner_tpu.config import OMGConfig as JConfig
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch.apps.inspector import InspectorApp, make_server
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.ops.chomp import GoalSet
from omg_planner_torch.planner.scene import PlanningScene

torch.set_num_threads(2)

KW = dict(silent=True, optim_steps=15, extra_smooth_steps=5,
          goal_set_max_num=12, ik_seed_num=3, ik_max_iters=30,
          learner_interp_steps=10)


@pytest.fixture(scope="module")
def server():
    scene = PlanningScene.synthetic(OMGConfig(**KW), scene_id=0,
                                    n_obstacles=1, device="cpu")
    app = InspectorApp(scene)
    srv = make_server(app, port=0)  # ephemeral port
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", app
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _get(url):
    with urllib.request.urlopen(url, timeout=600) as r:
        return r.status, r.read(), r.headers["Content-Type"]


def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, json.loads(r.read())


def test_page_and_state(server):
    base, app = server
    status, page, _ = _get(base + "/")
    assert status == 200 and b"scene inspector" in page
    assert b"omg_planner_torch inspector" in page
    status, raw, _ = _get(base + "/state")
    state = json.loads(raw)
    assert status == 200
    assert any(o["target"] for o in state["objects"])
    assert len(state["robot_points"]) > 10
    assert state["message"] == "ready"


def test_click_pick_then_place(server):
    base, app = server
    target = app.scene.env.target
    x, y = float(target.pose_mat[0, 3]), float(target.pose_mat[1, 3])
    status, res = _post(base + "/plan", {"action": "pick", "x": x, "y": y})
    assert status == 200
    assert res["ok"], res["message"]
    traj = np.asarray(res["traj"])
    assert traj.ndim == 2 and np.isfinite(traj).all()

    # the ee path of the plan and the goal ghosts show up in /state
    _, raw, _ = _get(base + "/state")
    state = json.loads(raw)
    assert len(state["ee_path"]) > 3 and len(state["goal_ghosts"]) >= 1

    status, res2 = _post(base + "/plan",
                         {"action": "place", "x": x + 0.08, "y": y - 0.1})
    assert status == 200
    # placement may legitimately fail on a cluttered draw, but the request
    # must round-trip with a coherent message
    assert "message" in res2
    if res2["ok"]:
        assert np.isfinite(np.asarray(res2["achieved"])).all()


def test_click_far_from_objects(server):
    base, _ = server
    _, res = _post(base + "/plan", {"action": "pick", "x": -5.0, "y": 5.0})
    assert not res["ok"]
    assert "no object" in res["message"]


def test_render_png_endpoint(server):
    from omg_planner_torch.apps.inspector import _robot_geometry
    from omg_planner_torch.viz.raster import render_rgb

    base, app = server
    status, data, ctype = _get(f"{base}/render.png")
    assert status == 200 and ctype == "image/png"
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 500
    mpimg = pytest.importorskip("matplotlib.image")
    img = mpimg.imread(io.BytesIO(data), format="png")
    q = (app.last_traj[-1] if app.last_traj is not None
         else app.scene.start)
    rgb, _, _ = render_rgb(app.scene.env.objects, width=320, height=240,
                           robot_points=_robot_geometry(app.scene, q)[0])
    np.testing.assert_array_equal(
        np.round(img[..., :3] * 255).astype(np.uint8), rgb)


def test_state_geometry_matches_jax():
    """``/state`` of the two apps on synthetic scene 0 with the same start,
    the JAX app's goal set after a pick and its last trajectory."""
    js = JScene.synthetic(JConfig(**KW), scene_id=0, n_obstacles=1)
    japp = JApp(js)
    tscene = PlanningScene.synthetic(OMGConfig(**KW), scene_id=0,
                                     n_obstacles=1, device="cpu")
    tapp = InspectorApp(tscene)
    j0, t0 = japp.state(), tapp.state()
    assert j0["objects"] == t0["objects"]
    assert t0["goal_ghosts"] == t0["ee_path"] == []
    np.testing.assert_allclose(t0["robot_points"], j0["robot_points"],
                               atol=1e-4, rtol=0)

    out = japp.plan({"action": "pick", "target": js.env.target.name})
    assert out["ok"], out["message"]
    gs = js.goal_set
    tscene.goal_set = GoalSet(*(torch.as_tensor(np.array(f))
                                for f in gs))
    tscene.start = np.asarray(js.start)
    tapp.last_traj = japp.last_traj
    j, t = japp.state(), tapp.state()
    assert len(t["goal_ghosts"]) == min(int(jnp.sum(gs.mask)), 24) >= 1
    for k in ("robot_points", "goal_ghosts", "ee_path"):
        np.testing.assert_allclose(t[k], j[k], atol=1e-4, rtol=0,
                                   err_msg=k)
