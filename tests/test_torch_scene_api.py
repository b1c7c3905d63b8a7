"""The JAX API remnants of the port against the JAX package on the CPU:
``Env.remove_object``/``clear``/``add_table``/``add_plane``,
``viz/camera.py::back_project``, ``GoalSet.num_valid`` and the
``SignedDensityField`` readers, ``resize`` and ``dump`` (the cases of
``tests/test_sdf.py`` and ``tests/test_peripherals.py``).

Bars: the same object names, target, version bumps and staged cost
parameters after the same edits; host arrays equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.config import OMGConfig as JConfig
from omg_planner_tpu.io.assets import \
    synthetic_tabletop_scene as jsynthetic_scene
from omg_planner_tpu.ops.chomp import GoalSet as JGoalSet
from omg_planner_tpu.ops.sdf import SignedDensityField as JField
from omg_planner_tpu.planner.scene import Env as JEnv
from omg_planner_tpu.viz import camera as jcamera
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.io.assets import make_primitive, pose_at
from omg_planner_torch.io.assets import synthetic_tabletop_scene
from omg_planner_torch.ops.chomp import GoalSet
from omg_planner_torch.ops.sdf import SignedDensityField
from omg_planner_torch.planner.scene import Env
from omg_planner_torch.viz import camera

VIEW = np.array([[-0.9351, 0.3518, 0.0428, 0.3037],
                 [0.2065, 0.639, -0.741, 0.132],
                 [-0.2881, -0.684, -0.6702, 1.8803],
                 [0, 0, 0, 1.0]])


def _envs(n_obstacles=2):
    tenv = Env(TConfig(silent=True), device="cpu")
    jenv = JEnv(JConfig(silent=True))
    for env, scene in ((tenv, synthetic_tabletop_scene),
                       (jenv, jsynthetic_scene)):
        objects, target = scene(3, n_obstacles=n_obstacles)
        for o in objects:
            env.add_object(o)
        env.set_target(target)
    return tenv, jenv


def _same_env(tenv, jenv):
    assert tenv.names == jenv.names
    assert tenv.target_idx == jenv.target_idx
    assert tenv.version == jenv.version
    if not tenv.objects:
        return
    tp, jp = tenv.cost_params(), jenv.cost_params()
    for f in tp._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


@pytest.mark.parametrize("edit", ["remove_target", "remove_before_target",
                                  "remove_after_target", "remove_all_but_one",
                                  "clear", "table_and_plane"])
def test_env_edits_match_jax(edit):
    tenv, jenv = _envs()
    for env in (tenv, jenv):
        names = env.names
        if edit == "remove_target":
            env.remove_object(env.target.name)
        elif edit == "remove_before_target":
            env.set_target(names[1])
            env.remove_object(names[0])
        elif edit == "remove_after_target":
            env.remove_object(names[-1])
        elif edit == "remove_all_but_one":
            env.set_target(names[-1])
            for name in names[:-1]:
                env.remove_object(name)
        elif edit == "clear":
            env.clear()
        else:
            env.add_table([0.9, 0.0, 0.0], extents=(0.5, 0.8, 0.3))
            env.add_plane(z=0.02)
    _same_env(tenv, jenv)
    if edit == "table_and_plane":
        assert tenv.names[-2:] == ["table", "floor"]
        # the floor is collision-disabled by name
        assert float(tenv.cost_params().disables[-1]) == 1.0
        for t, j in zip(tenv.objects[-2:], jenv.objects[-2:]):
            np.testing.assert_array_equal(t.pose_mat, j.pose_mat)
            np.testing.assert_array_equal(t.extents, j.extents)
            assert t.sdf.delta == j.sdf.delta
    if edit == "clear":
        assert tenv.objects == [] and tenv._scene_sdf is None


def test_back_project_matches_jax():
    objects = [make_primitive("mug", "cylinder", [0.032, 0.1],
                              pose_at([0.5, 0.0, 0.3]), compute_grasp=False),
               make_primitive("box", "box", [0.05, 0.05, 0.1],
                              pose_at([0.5, 0.2, 0.3]), compute_grasp=False)]
    _, _, depth, _ = camera.render_point_observation(objects)
    assert np.isfinite(depth).sum() > 50
    bp = camera.back_project(depth, VIEW, 131.25, 131.25)
    np.testing.assert_array_equal(
        bp, jcamera.back_project(depth, VIEW, 131.25, 131.25))
    # the back-projected cloud sits on the observed objects
    assert np.linalg.norm(bp.mean(0) - [0.5, 0.1, 0.3]) < 0.25


@pytest.mark.parametrize("n_valid", [0, 3, 8])
def test_goal_set_num_valid_matches_jax(n_valid):
    mask = np.arange(8) < n_valid
    tgs = GoalSet(grasps=torch.zeros(8, 9), reach_grasps=torch.zeros(8, 5, 9),
                  mask=torch.as_tensor(mask), potentials=torch.zeros(8))
    jgs = JGoalSet(grasps=jnp.zeros((8, 9)), reach_grasps=jnp.zeros((8, 5, 9)),
                   mask=jnp.asarray(mask), potentials=jnp.zeros(8))
    assert int(tgs.num_valid) == int(jgs.num_valid) == n_valid
    assert tgs.num_valid.shape == ()


def _same_field(t, j):
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.origin, j.origin)
    assert t.delta == j.delta


@pytest.mark.parametrize("kind,extents", [("sphere", [0.1]),
                                          ("box", [0.1, 0.2, 0.05]),
                                          ("cylinder", [0.04, 0.12])])
def test_resize_matches_jax(kind, extents):
    for lazy in (True, False):
        t = SignedDensityField.from_analytic(kind, extents, delta=0.01)
        j = JField.from_analytic(kind, extents, delta=0.01)
        if not lazy:  # build the host grids first
            t.data = t.data
            j.data = j.data
        t.penalize_inside(5.0).resize(1.5)
        j.penalize_inside(5.0).resize(1.5)
        assert (t._data is None) == (j._data is None) == lazy
        assert t.delta == j.delta
        assert t.analytic[0] == j.analytic[0]
        np.testing.assert_array_equal(t.analytic[1], j.analytic[1])
        assert t.analytic[2] == j.analytic[2]
        _same_field(t, j)


def test_sdf_text_and_pth_readers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    vals = rng.normal(size=(4, 3, 2))
    # .sdf text: x-fastest value order (sdf_tools.py:168-184)
    lines = ["4 3 2", "-0.1 -0.2 -0.3", "0.05"]
    for k in range(2):
        for j in range(3):
            for i in range(4):
                lines.append(str(float(vals[i, j, k])))
    p = tmp_path / "vol.sdf"
    p.write_text("\n".join(lines) + "\n")
    f = SignedDensityField.from_sdf_file(str(p))
    _same_field(f, JField.from_sdf_file(str(p)))
    np.testing.assert_allclose(f.data, vals, atol=1e-6)
    assert f.delta == 0.05

    # .pth: stored [1,1,X,Y,Z], loaded with the reference's (1,0,2) permute
    vol = torch.from_numpy(rng.normal(size=(1, 1, 5, 4, 3)).astype(np.float32))
    torch.save({"sdf_torch": vol, "min_coords": torch.zeros(3),
                "max_coords": torch.ones(3), "delta": torch.tensor([0.01])},
               tmp_path / "v.pth")
    g = SignedDensityField.from_pth(str(tmp_path / "v.pth"))
    _same_field(g, JField.from_pth(str(tmp_path / "v.pth")))
    np.testing.assert_array_equal(g.data, vol[0, 0].permute(1, 0, 2).numpy())


def test_dump_and_from_pkl_round_trip_match_jax(tmp_path):
    t = SignedDensityField.from_analytic("cylinder", [0.04, 0.12],
                                         delta=0.01).penalize_inside(5.0)
    j = JField.from_analytic("cylinder", [0.04, 0.12],
                             delta=0.01).penalize_inside(5.0)
    t.dump(str(tmp_path / "t.pkl"))
    j.dump(str(tmp_path / "j.pkl"))
    back = SignedDensityField.from_pkl(str(tmp_path / "t.pkl"))
    _same_field(back, t)
    _same_field(back, JField.from_pkl(str(tmp_path / "j.pkl")))
    # each package reads the other's file
    _same_field(SignedDensityField.from_pkl(str(tmp_path / "j.pkl")),
                JField.from_pkl(str(tmp_path / "t.pkl")))
