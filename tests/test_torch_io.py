"""The port's host I/O (``omg_planner_torch/io/``: ``scene_io``,
``scene_gen.random_settled_scene``, ``meshrepair``, ``meshsdf``,
``reference_data``, ``ref_fixtures``) against the JAX package's, on the
same inputs.

Bars: the host numpy code is a copy, so its outputs are equal to JAX's
(arrays bit for bit, the same keys and names).  ``meshsdf`` builds its own
copy of ``native/meshsdf.cpp`` under ``build/`` and must agree with the
JAX package's library on the cases of ``tests/test_meshsdf.py``.  The
reference-format tree is written by the port's ``ref_fixtures`` into
``tmp_path``; no reference checkout is needed.
"""

import os
import shutil

import numpy as np
import pytest
import scipy.io as sio

from omg_planner_tpu.io import meshrepair as jrepair
from omg_planner_tpu.io import meshsdf as jmeshsdf
from omg_planner_tpu.io import ref_fixtures as jfixtures
from omg_planner_tpu.io import reference_data as jref
from omg_planner_tpu.io import scene_gen as jgen
from omg_planner_tpu.io import scene_io as jio
from omg_planner_tpu.config import OMGConfig as JConfig
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.io import meshrepair as trepair
from omg_planner_torch.io import meshsdf as tmeshsdf
from omg_planner_torch.io import ref_fixtures as tfixtures
from omg_planner_torch.io import reference_data as tref
from omg_planner_torch.io import scene_gen as tgen
from omg_planner_torch.io import scene_io as tio
from omg_planner_torch.io.assets import make_primitive, pose_at
from test_meshrepair import _cube
from test_meshsdf import lshape_mesh, unit_cube_mesh

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no C++ toolchain")


def assert_same_dict(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], (list, str)):
            assert a[k] == b[k], k
        else:
            np.testing.assert_array_equal(np.asarray(a[k]),
                                          np.asarray(b[k]), err_msg=k)


# ---------------------------------------------------------------------------
# scene_io
# ---------------------------------------------------------------------------

def test_load_mat_scene_matches_jax_on_a_fixture(tmp_path):
    mat = tfixtures.make_fixture_tree(str(tmp_path))
    got = tio.load_mat_scene(mat)
    assert_same_dict(got, jio.load_mat_scene(mat))
    assert got["target_name"] == "fixture_box"
    assert got["path"] == ["data/objects/fixture_box",
                           "data/objects/fixture_cyl"]
    assert got["pose"].shape == (2, 4, 4)


def test_load_mat_scene_optional_fields(tmp_path):
    path = str(tmp_path / "s.mat")
    sio.savemat(path, {"pose": np.tile(np.eye(4), (2, 1, 1)),
                       "path": ["data/objects/mug ", "data/objects/table "],
                       "goals": np.arange(27.0).reshape(3, 9),
                       "reach_grasps": np.ones((3, 5, 9)),
                       "target_name": "mug"})
    got = tio.load_mat_scene(path)
    assert_same_dict(got, jio.load_mat_scene(path))
    assert got["goals"].shape == (3, 9)
    assert got["reach_grasps"].shape == (3, 5, 9)


def _objects():
    return [make_primitive("mug", "cylinder", [0.032, 0.10],
                           pose_at([0.5, 0.1, 0.23]), target=True),
            make_primitive("box", "box", [0.05, 0.05, 0.1],
                           pose_at([0.45, -0.1, 0.23], 0.4),
                           compute_grasp=False),
            make_primitive("ball", "sphere", [0.03], pose_at([0.6, 0, 0.21]),
                           compute_grasp=False)]


@pytest.mark.parametrize("with_goals", [False, True])
def test_save_npz_scene_round_trip(tmp_path, with_goals):
    goals = np.arange(18.0).reshape(2, 9) if with_goals else None
    tails = np.ones((2, 5, 9)) if with_goals else None
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tio.save_npz_scene(tpath, _objects(), "mug", goals=goals,
                       reach_grasps=tails)
    jio.save_npz_scene(jpath, _objects(), "mug", goals=goals,
                       reach_grasps=tails)
    tdata, jdata = tio.load_npz_scene(tpath), jio.load_npz_scene(jpath)
    assert_same_dict(tdata, jdata)
    objects, target = tio.objects_from_npz(tdata)
    assert target == "mug"
    for o, ref in zip(objects, _objects()):
        assert o.name == ref.name and o.kind == ref.kind
        np.testing.assert_array_equal(o.pose_mat, ref.pose_mat)
        assert o.sdf.delta == ref.sdf.delta
        assert o.compute_grasp == (o.name == "mug")


def test_save_demonstration_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    args = dict(traj=rng.normal(size=(30, 9)), goals=rng.normal(size=(4, 9)),
                scene_meta={"names": ["mug", "box"],
                            "poses": rng.normal(size=(2, 4, 4))},
                observations={"depth": rng.normal(size=(6, 8))})
    tio.save_demonstration(str(tmp_path / "t.npz"), **args)
    jio.save_demonstration(str(tmp_path / "j.npz"), **args)
    t = dict(np.load(tmp_path / "t.npz"))
    assert_same_dict(t, dict(np.load(tmp_path / "j.npz")))
    assert sorted(t) == ["goals", "obs_depth", "scene_names", "scene_poses",
                         "traj"]


# ---------------------------------------------------------------------------
# scene_gen
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_obstacles", [(0, 4), (7, 2), (123, 6)])
def test_random_settled_scene_matches_jax(seed, n_obstacles):
    tobj, ttarget = tgen.random_settled_scene(seed, n_obstacles)
    jobj, jtarget = jgen.random_settled_scene(seed, n_obstacles)
    assert ttarget == jtarget
    assert [o.name for o in tobj] == [o.name for o in jobj]
    for a, b in zip(tobj, jobj):
        assert a.kind == b.kind and a.target == b.target
        np.testing.assert_array_equal(a.pose_mat, b.pose_mat)
        np.testing.assert_array_equal(a.extents, b.extents)
        np.testing.assert_array_equal(a.grasps_poses, b.grasps_poses)


# ---------------------------------------------------------------------------
# meshrepair (the cases of tests/test_meshrepair.py)
# ---------------------------------------------------------------------------

def _repair_cases():
    v, f = _cube()
    rng = np.random.default_rng(0)
    flips = rng.random(len(f)) < 0.5
    flipped = f.copy()
    flipped[flips] = flipped[flips][:, ::-1]
    dup_v = np.concatenate([v, v + 1e-9])
    dup_f = np.concatenate([f, f + 8, [[0, 0, 1]]])
    two_v = np.concatenate([v, v + 5.0])
    two_f = np.concatenate([f[:, ::-1], f + len(v)])
    return {"doubles": (dup_v, dup_f), "random_flips": (v, flipped),
            "inside_out": (v, f[:, ::-1]), "two_components": (two_v, two_f)}


@pytest.mark.parametrize("case", sorted(_repair_cases()))
def test_meshrepair_matches_jax(case):
    v, f = _repair_cases()[case]
    for a, b in zip(trepair.remove_doubles(v, f, eps=1e-6),
                    jrepair.remove_doubles(v, f, eps=1e-6)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trepair.orient_faces(v, f),
                                  jrepair.orient_faces(v, f))
    tv, tf, tstats = trepair.repair_mesh(v, f)
    jv, jf, jstats = jrepair.repair_mesh(v, f)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tstats == jstats


def test_meshrepair_save_obj_matches_jax(tmp_path):
    v, f = _cube()
    trepair.save_obj(str(tmp_path / "t.obj"), v, f)
    jrepair.save_obj(str(tmp_path / "j.obj"), v, f)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()


# ---------------------------------------------------------------------------
# meshsdf (the cases of tests/test_meshsdf.py)
# ---------------------------------------------------------------------------

@needs_gxx
def test_meshsdf_builds_under_build_dir():
    tmeshsdf._load()
    so = tmeshsdf._lib_path()
    assert os.path.exists(so)
    assert os.path.dirname(so) == tmeshsdf.BUILD_DIR
    assert os.path.basename(os.path.dirname(os.path.dirname(so))) == "build"


@needs_gxx
def test_mesh_to_sdf_and_surface_points_match_jax():
    v, f = unit_cube_mesh(0.1)
    t = tmeshsdf.mesh_to_sdf(v, f, delta=0.005, padding=10)
    j = jmeshsdf.mesh_to_sdf(v, f, delta=0.005, padding=10)
    np.testing.assert_array_equal(t.data, j.data)
    np.testing.assert_array_equal(t.origin, j.origin)
    assert t.delta == j.delta
    assert abs(t.get_distance(np.zeros(3)) - (-0.05)) < 0.01
    np.testing.assert_array_equal(tmeshsdf.surface_points(v, f, 50),
                                  jmeshsdf.surface_points(v, f, 50))


@needs_gxx
@pytest.mark.parametrize("shape", ["cube", "lshape"])
def test_convex_decompose_matches_jax(tmp_path, shape):
    v, f = unit_cube_mesh(0.1) if shape == "cube" else lshape_mesh()
    boxes = tmeshsdf.convex_decompose(v, f, voxel=0.01)
    np.testing.assert_array_equal(
        boxes, jmeshsdf.convex_decompose(v, f, voxel=0.01))
    p = str(tmp_path / "c.obj")
    tmeshsdf.save_compound_obj(p, boxes)
    verts, faces = tmeshsdf.load_obj(p)
    jverts, jfaces = jmeshsdf.load_obj(p)
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    assert len(faces) == 12 * len(boxes)


@needs_gxx
def test_process_mesh_matches_jax(tmp_path):
    v, f = unit_cube_mesh(0.08)
    obj = tmp_path / "cube.obj"
    with open(obj, "w") as fh:
        for vv in v:
            fh.write(f"v {vv[0]} {vv[1]} {vv[2]}\n")
        for ff in f:
            fh.write(f"f {ff[0]+1} {ff[1]+1} {ff[2]+1}\n")
    outs = {}
    for name, mod in (("t", tmeshsdf), ("j", jmeshsdf)):
        out = tmp_path / name
        out.mkdir()
        outs[name] = mod.process_mesh(str(obj), out_dir=str(out),
                                      delta=0.005, padding=8, repair=True)
    (tsdf, tpts, text), (jsdf, jpts, jext) = outs["t"], outs["j"]
    np.testing.assert_array_equal(tsdf.data, jsdf.data)
    np.testing.assert_array_equal(tpts, jpts)
    np.testing.assert_array_equal(text, jext)
    for fname in ("cube.xyz", "cube.extent.txt"):
        assert (tmp_path / "t" / fname).read_text() == \
            (tmp_path / "j" / fname).read_text()
    from omg_planner_torch.ops.sdf import SignedDensityField
    back = SignedDensityField.from_pkl(str(tmp_path / "t" / "cube_chomp.pkl"))
    np.testing.assert_array_equal(back.data, tsdf.data)


# ---------------------------------------------------------------------------
# reference-format data: ref_fixtures + reference_data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    t = str(tmp_path_factory.mktemp("port_tree"))
    j = str(tmp_path_factory.mktemp("jax_tree"))
    return (t, tfixtures.make_fixture_tree(t)), (j, jfixtures.make_fixture_tree(j))


def test_fixture_tree_matches_jax(trees):
    (t, tmat), (j, jmat) = trees
    assert os.path.relpath(tmat, t) == os.path.relpath(jmat, j)
    for rel in ("data/objects/fixture_box/model_normalized.xyz",
                "data/objects/fixture_box/model_normalized.extent.txt",
                "data/objects/fixture_cyl/model_normalized.xyz"):
        with open(os.path.join(t, rel)) as a, open(os.path.join(j, rel)) as b:
            assert a.read() == b.read(), rel
    rel = "data/grasps/simulated/fixture_box.npy"
    np.testing.assert_array_equal(
        np.load(os.path.join(t, rel), allow_pickle=True).item()["transforms"],
        np.load(os.path.join(j, rel), allow_pickle=True).item()["transforms"])
    for obj in ("fixture_box", "fixture_cyl"):
        rel = f"data/objects/{obj}/model_normalized_chomp.pth"
        a = tref.SignedDensityField.from_pth(os.path.join(t, rel))
        b = jref.SignedDensityField.from_pth(os.path.join(j, rel))
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.origin, b.origin)


def test_make_parity_tree_matches_jax(tmp_path):
    tpaths = tfixtures.make_parity_tree(str(tmp_path / "t"), n_scenes=4)
    jpaths = jfixtures.make_parity_tree(str(tmp_path / "j"), n_scenes=4)
    assert len(tpaths) == len(jpaths) == 4
    for a, b in zip(tpaths, jpaths):
        assert_same_dict(tio.load_mat_scene(a), jio.load_mat_scene(b))


def test_load_grasp_db_matches_jax(trees):
    (t, _), _ = trees
    path = os.path.join(t, "data/grasps/simulated/fixture_box.npy")
    for name in ("fixture_box", "025_mug", "037_scissors"):
        np.testing.assert_array_equal(tref.load_grasp_db(path, name),
                                      jref.load_grasp_db(path, name))


@pytest.mark.parametrize("penalize", [True, False])
def test_env_from_mat_scene_matches_jax(trees, penalize):
    (t, tmat), _ = trees
    tcfg, jcfg = TConfig(silent=True), JConfig(silent=True)
    tenv, tscene = tref.env_from_mat_scene(tcfg, tmat, t, penalize=penalize,
                                           device="cpu")
    jenv, jscene = jref.env_from_mat_scene(jcfg, tmat, t, penalize=penalize)
    assert_same_dict(tscene, jscene)
    assert tenv.names == jenv.names
    assert tenv.target_idx == jenv.target_idx
    for a, b in zip(tenv.objects, jenv.objects):
        np.testing.assert_array_equal(a.sdf.data, b.sdf.data)
        np.testing.assert_array_equal(a.sdf.origin, b.sdf.origin)
        assert a.sdf.delta == b.sdf.delta
        np.testing.assert_array_equal(a.pose_mat, b.pose_mat)
        np.testing.assert_array_equal(a.points, b.points)
        np.testing.assert_array_equal(a.extents, b.extents)
        np.testing.assert_array_equal(a.grasps_poses, b.grasps_poses)
    np.testing.assert_array_equal(tenv.grasp_poses_world(),
                                  jenv.grasp_poses_world())


@needs_gxx
def test_mesh_object_grasp_plan():
    """A triangle mesh through the port's offline pipeline (voxelize,
    surface points, convex pieces) into a plan on the grid backend, at
    the configuration and bars of ``tests/test_mesh_object_plan.py``: a
    successful plan whose grasp closes on the mesh with no swept
    collision."""
    from omg_planner_torch.io.assets import SceneObject, synthetic_grasp_db
    from omg_planner_torch.planner.scene import Env, PlanningScene
    from omg_planner_torch.planner.validate import validate_execution
    from omg_planner_tpu.viz.raster import primitive_mesh

    cfg = TConfig(silent=True, optim_steps=20, extra_smooth_steps=6,
                  goal_set_max_num=15, ik_seed_num=3, ik_max_iters=35,
                  learner_interp_steps=10)
    v, f = primitive_mesh("box", [0.055, 0.055, 0.16])
    v, f = v.astype(np.float32), f.astype(np.int32)
    sdf = tmeshsdf.mesh_to_sdf(v, f, delta=0.0075, padding=12)
    sdf.penalize_inside(5.0)
    extents = v.max(0) - v.min(0)
    assert len(tmeshsdf.convex_decompose(v, f, voxel=0.015)) >= 1
    obj = SceneObject("mesh_can", sdf, pose_at([0.52, 0.05, 0.08]),
                      target=True, grasps_poses=synthetic_grasp_db(
                          "box", extents), extents=extents,
                      points=tmeshsdf.surface_points(v, f, max_points=500))
    obj.kind = "box"
    env = Env(cfg, device="cpu")
    env.add_object(make_primitive(
        "table", "box", [0.9, 1.2, 0.04], pose_at([0.5, 0.0, -0.02]),
        compute_grasp=False))
    env.add_object(obj)
    env.set_target("mesh_can")
    scene = PlanningScene(cfg, env)
    res = scene.step(fast=True)
    assert res is not None, "goal set empty for the mesh target"
    assert bool(res.flag), int(res.info.collide)
    rep = validate_execution(scene, np.asarray(res.traj))
    assert rep.grasp_ok
    assert rep.swept_collision_points == 0
