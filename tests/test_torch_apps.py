"""The port's apps (``apps/kitchen.py``, ``apps/gen_demos.py``,
``apps/sdf_inspect.py``, ``apps/process_shape.py``, ``apps/vis_demos.py``)
against the JAX package on the CPU, at ``tests/test_apps.py``'s configs.

Both packages plan with their IK lanes in lane-index order, and the port's
goal sampling draws the Gumbel noise that JAX draws from its scene key
(split once per goal-set build), as ``tests/test_torch_tasks.py`` sets it
up: float rounding decides the lane order otherwise (``ROADMAP.md``
section 3).

Tolerances, and why:
* ``parse_script``, the saved scene layout and observations,
  ``sdf_inspect``'s info line and volume, ``process_shape``'s outputs:
  exactly equal (the same host code);
* plans: the same verdicts, goals and steps, trajectories and goal sets
  within 2e-3 (``tests/test_golden.py``'s bar); the kitchen placement and
  the move after it are chaotic in the JAX package itself (a 1e-7 rad
  start moves JAX's plan by more than 2e-3 rad), so there the verdict,
  steps and goal are held, not the trajectory;
* executions: the same rewards and ``carried``, the pick's ``lifted_m``
  within 1e-3 m (the rollouts replay trajectories that agree within 2e-3,
  not bit for bit).  Placements run with ``sub_plan=6`` instead of 24 in
  both packages, so the file stays near two minutes on the CPU."""

import functools
import glob
import os

import jax
import numpy as np
import pytest
import torch

import omg_planner_torch.physics as tphysics
import omg_planner_tpu.physics as jphysics
from omg_planner_tpu.apps import gen_demos as jgen
from omg_planner_tpu.apps import kitchen as jkitchen
from omg_planner_tpu.config import OMGConfig as JConfig
from omg_planner_tpu.ops import ik as jik
from omg_planner_torch.apps import gen_demos as tgen
from omg_planner_torch.apps import kitchen as tkitchen
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.ops import ik as tik
from omg_planner_torch.planner import scene as tscene

torch.set_num_threads(2)

SMALL = dict(optim_steps=4, extra_smooth_steps=2, goal_set_max_num=6,
             ik_seed_num=2, ik_max_iters=20, learner_interp_steps=5,
             silent=True)
KITCHEN = dict(silent=True, optim_steps=12, extra_smooth_steps=4,
               goal_set_max_num=10, ik_seed_num=2, ik_max_iters=25,
               learner_interp_steps=8)


@pytest.fixture
def jax_lanes(monkeypatch):
    """IK lanes in index order in both packages; each goal-set build of a
    port scene draws the Gumbel noise of the JAX scene's key stream
    (``PRNGKey(233)``, split per build)."""
    j_solve, t_solve = jik.solve_goal_set, tik.solve_goal_set

    def j_sorted(*a, **kw):
        out = j_solve(*a, **kw)
        order = jax.numpy.argsort(out[3])
        return tuple(x[order] for x in out)

    def t_sorted(*a, **kw):
        out = t_solve(*a, **kw)
        order = torch.argsort(out[3])
        return tuple(x[order] for x in out)

    monkeypatch.setattr(jik, "solve_goal_set", j_sorted)
    monkeypatch.setattr(tik, "solve_goal_set", t_sorted)
    scene_build = tscene.PlanningScene.build_goal_set
    build = tscene.gs.build_goal_set
    noise = {}

    def build_goal_set(self):
        key = getattr(self, "_jax_key", jax.random.PRNGKey(233))
        self._jax_key, sub = jax.random.split(key)

        def gumbel_fn(tag, n):
            k = jax.random.fold_in(sub, 0x9d5) if tag == "prune" else sub
            return torch.as_tensor(np.array(jax.random.gumbel(k, (n,))))

        noise["fn"] = gumbel_fn
        return scene_build(self)

    monkeypatch.setattr(tscene.PlanningScene, "build_goal_set",
                        build_goal_set)
    monkeypatch.setattr(tscene.gs, "build_goal_set", lambda *a, **kw: build(
        *a, gumbel_fn=noise["fn"], **kw))


@pytest.fixture
def short_placements(monkeypatch):
    for mod in (jphysics, tphysics):
        monkeypatch.setattr(mod, "execute_place", functools.partial(
            mod.execute_place, sub_plan=6))


def test_parse_script_matches_jax(tmp_path):
    p = tmp_path / "s.txt"
    p.write_text("# demo\nONCE\nT mug\nP 0.0,0.25,0.0,1\n\nE 2\nX junk\n")
    steps = tkitchen.parse_script(str(p))
    assert steps == jkitchen.parse_script(str(p))
    assert steps == [("ONCE",), ("T", "mug"), ("P", [0.0, 0.25, 0.0, 1.0]),
                     ("E", 2)]


def _same_step(t, j, traj: bool = True):
    """The same kind, verdict, steps and goal; the trajectory (and a
    placement's achieved pose) within the bars above when ``traj``."""
    assert t[0] == j[0]
    tres, jres = t[2], j[2]
    assert (tres is None) == (jres is None), t[0]
    if jres is None:
        return
    assert bool(tres.flag) == bool(jres.flag), t[0]
    assert int(tres.steps_used) == int(jres.steps_used), t[0]
    assert int(tres.goal_idx) == int(jres.goal_idx), t[0]
    assert np.isfinite(tres.traj).all()
    if traj:
        np.testing.assert_allclose(tres.traj, np.asarray(jres.traj),
                                   atol=2e-3, err_msg=t[0])
        if t[0] == "place":
            np.testing.assert_allclose(t[1][:3, 3], np.asarray(j[1])[:3, 3],
                                       atol=5e-3)


def _near_commanded(achieved):
    """The mug landed near the commanded displacement (the check of
    ``tests/test_apps.py``)."""
    return np.linalg.norm(np.asarray(achieved)[:2, 3]
                          - np.array([0.52, -0.18 + 0.25])) < 0.15


def test_kitchen_script_matches_jax(jax_lanes):
    """Pick -> place -> move through the synthetic cabinet (the grammar
    test of ``tests/test_apps.py``) in both packages.  The pick is held to
    2e-3; the place and the move from its end are chaotic in the JAX
    package itself (``test_kitchen_placement_is_chaotic_in_jax``), so they
    are held to the same verdict, steps and goal, and the place to JAX's
    own bar on the achieved pose."""
    steps = [("ONCE",), ("T", "mug"), ("P", [0.0, 0.25, 0.0]), ("E", 3)]
    jres = jkitchen.run_script(jkitchen.kitchen_scene(JConfig(**KITCHEN)),
                               steps, fast=True)
    tres = tkitchen.run_script(
        tkitchen.kitchen_scene(OMGConfig(**KITCHEN), device="cpu"), steps,
        fast=True)
    assert [r[0] for r in tres] == ["pick", "place", "move"]
    assert tres[0][2] is not None and bool(tres[0][2].flag)
    _same_step(tres[0], jres[0])
    _same_step(tres[1], jres[1], traj=False)
    _same_step(tres[2], jres[2], traj=False)
    assert _near_commanded(tres[1][1]) and _near_commanded(jres[1][1])


def test_kitchen_placement_is_chaotic_in_jax(jax_lanes):
    """Why the kitchen placement's trajectory is not held to 2e-3: in the
    JAX package, moving the grasp configuration it starts from by 1e-7 rad
    moves the placement plan (the hand wrapped round the mug) by more than
    2e-3 rad, with the same verdict, steps and goal."""
    from omg_planner_tpu.planner import tasks as jtasks

    scene = jkitchen.kitchen_scene(JConfig(**KITCHEN))
    pick = jkitchen.run_script(scene, [("T", "mug")], fast=True)[0][2]
    conf = np.asarray(pick.traj[-1], np.float64)
    place = scene.env.target.pose_mat.copy()
    place[:3, 3] += [0.0, 0.25, 0.0]
    out = []
    for eps in (0.0, 1e-7):
        s = jkitchen.kitchen_scene(JConfig(**KITCHEN))
        s.env.set_target("mug")
        res, _ = jtasks.place_target(
            s, conf + eps * np.r_[np.ones(7), 0, 0], place, fast=True)
        out.append(res)
    a, b = out
    assert (bool(a.flag), int(a.steps_used), int(a.goal_idx)) == \
        (bool(b.flag), int(b.steps_used), int(b.goal_idx))
    assert np.abs(np.asarray(a.traj) - np.asarray(b.traj)).max() > 2e-3


def test_kitchen_exec_matches_jax(jax_lanes, short_placements):
    """``run_script(execute=True)``: the pick and the place scored in each
    package's stepper (the place replays its chaotic plan: same
    ``carried``)."""
    steps = [("T", "mug"), ("P", [0.0, 0.25, 0.0])]
    jres, jrep = jkitchen.run_script(
        jkitchen.kitchen_scene(JConfig(**KITCHEN)), steps, fast=True,
        execute=True)
    tres, trep = tkitchen.run_script(
        tkitchen.kitchen_scene(OMGConfig(**KITCHEN), device="cpu"), steps,
        fast=True, execute=True)
    _same_step(tres[0], jres[0])
    _same_step(tres[1], jres[1], traj=False)
    assert sorted(trep) == sorted(jrep) == [0, 1]
    assert trep[0]["reward"] == jrep[0]["reward"] == 1
    assert abs(trep[0]["lifted_m"] - jrep[0]["lifted_m"]) < 1e-3
    assert trep[1]["carried"] == jrep[1]["carried"] == 1


def test_gen_demos_matches_jax(jax_lanes, tmp_path):
    """``generate(2, ...)`` at ``tests/test_apps.py``'s config, with the
    simulated-lift filter and the raster observations."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jk = jgen.generate(2, str(jdir), cfg=JConfig(**SMALL), n_obstacles=1,
                       observations=True)
    tk = tgen.generate(2, str(tdir), cfg=OMGConfig(**SMALL), n_obstacles=1,
                       observations=True, device="cpu")
    assert tk == jk >= 1
    names = sorted(os.path.basename(p)
                   for p in glob.glob(str(tdir / "demo_*.npz")))
    assert names == sorted(os.path.basename(p)
                           for p in glob.glob(str(jdir / "demo_*.npz")))
    for name in names:
        t = dict(np.load(tdir / name, allow_pickle=True))
        j = dict(np.load(jdir / name, allow_pickle=True))
        assert sorted(t) == sorted(j)
        assert t["traj"].shape[1] == 9 and len(t["goals"]) >= 1
        np.testing.assert_allclose(t["traj"], j["traj"], atol=2e-3)
        np.testing.assert_allclose(t["goals"], j["goals"], atol=2e-3)
        assert int(t["scene_sim_reward"]) == int(j["scene_sim_reward"]) == 1
        assert float(t["scene_sim_lifted_m"]) > 0.05
        for k in ("scene_poses", "scene_names", "scene_target", "obs_rgb",
                  "obs_depth", "obs_seg"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_process_shape_and_sdf_inspect_match_jax(tmp_path, capsys):
    from omg_planner_torch.apps import process_shape, sdf_inspect
    from omg_planner_torch.io.meshsdf import save_compound_obj
    from omg_planner_tpu.apps import process_shape as jprocess_shape
    from omg_planner_tpu.apps import sdf_inspect as jsdf_inspect

    outs = {}
    for tag, ps, si in (("jax", jprocess_shape, jsdf_inspect),
                        ("port", process_shape, sdf_inspect)):
        d = tmp_path / tag
        d.mkdir()
        obj = d / "block.obj"
        save_compound_obj(str(obj),
                          np.array([[0.0, 0.0, 0.0, 0.03, 0.02, 0.04]]))
        ps.main(["-f", str(obj), "-a", "--target-dim", "16",
                 "--padding", "4"])
        shape_line = capsys.readouterr().out.strip().splitlines()[-1]
        si.main(["-f", str(d / "block_chomp.pkl"), "-e", str(d / "re.pkl")])
        info = capsys.readouterr().out.strip().splitlines()[0]
        outs[tag] = (shape_line, info, si.load_any(str(d / "re.pkl")))
    assert "surface points" in outs["port"][0]
    assert outs["port"][0] == outs["jax"][0]
    assert outs["port"][1].startswith("sdf info:")
    assert outs["port"][1] == outs["jax"][1]
    t, j = outs["port"][2], outs["jax"][2]
    np.testing.assert_array_equal(np.asarray(t.data), np.asarray(j.data))
    np.testing.assert_array_equal(t.origin, np.asarray(j.origin))
    assert t.delta == float(j.delta)
    for name in ("block_chomp.pkl", "block.xyz", "block.extent.txt",
                 "block_convex.obj", "re.pkl"):
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


def test_sdf_inspect_slice_montage(tmp_path):
    pytest.importorskip("matplotlib")
    from omg_planner_torch.apps import sdf_inspect
    from omg_planner_torch.ops.sdf import SignedDensityField

    path = str(tmp_path / "ball.pkl")
    SignedDensityField.from_analytic("sphere", [0.05]).dump(path)
    png = tmp_path / "m.png"
    sdf_inspect.main(["-f", path, "-v", str(png)])
    assert png.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"


def test_vis_demos_replays_port_demo(tmp_path):
    """A demo in the layout ``gen_demos`` saves replays to a video of one
    frame every second waypoint, objects as box proxies."""
    pytest.importorskip("matplotlib")
    from omg_planner_torch.apps import vis_demos
    from omg_planner_torch.io import scene_io
    from omg_planner_torch.io.assets import pose_at

    traj = np.linspace([0, -1.2, 0, -2.3, 0, 1.5, 0.8, 0.04, 0.04],
                       [0.3, -0.9, 0, -2.0, 0, 1.7, 0.8, 0.04, 0.04], 6)
    meta = {"poses": np.stack([pose_at([0.5, 0.0, 0.05])]),
            "names": np.array(["mug"]), "target": np.array("mug")}
    scene_io.save_demonstration(str(tmp_path / "demo_0.npz"), traj,
                                traj[-1:], meta)
    out = vis_demos.main(["-d", str(tmp_path), "--cpu"])
    assert out == [str(tmp_path / "demo_0.avi")]
    written = glob.glob(out[0] + "*")
    assert len(written) == 1
    if written[0].endswith(".npz"):
        assert len(np.load(written[0])["frames"]) == 3
    else:
        import cv2
        cap = cv2.VideoCapture(written[0])
        assert int(cap.get(cv2.CAP_PROP_FRAME_COUNT)) == 3
        cap.release()
