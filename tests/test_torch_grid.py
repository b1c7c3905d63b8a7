"""The port's voxel-grid backend against the JAX package on the CPU.

* ``stage_scene_sdfs`` (the device synthesis of a primitive scene's padded
  stack), baked and unbaked, on suite scenes 0 and 1 at the suite-wide
  padded shape: atol 1e-5;
* the exact query (``sdf_potentials`` on an unbaked ``SceneSDF``) at 2,000
  seeded points inside, outside and out of volume: potentials and
  gradients within atol 1e-5, collide flags equal;
* ``pad_objects`` for analytic, baked and unbaked scenes: arrays equal;
  and a padded plan equal to the unpadded one (atol 1e-5);
* ``bake_world_potential_analytic`` (the learner field of a primitive
  scene on the grid backend): atol 1e-5;
* ``synthetic_hard_scene``: names, kinds, extents and poses exact;
* the staged caches key on ``cfg.jit_key()``: a host-only cfg change
  re-stages nothing."""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from omg_planner_tpu.io import scene_gen as jgen
from omg_planner_tpu.ops import sdf as jsdf
from omg_planner_tpu.parallel import batch as jbatch
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.io import scene_gen as tgen
from omg_planner_torch.io.scene_io import load_npz_scene, objects_from_npz
from omg_planner_torch.ops import sdf as tsdf
from omg_planner_torch.parallel import batch as tbatch
from omg_planner_torch.planner import plan as tplan
from omg_planner_torch.planner import scene as tscene
from test_golden import CFG

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE = os.path.join(ROOT, "data", "suite_v2")


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


def _fields(i):
    objects, _ = objects_from_npz(load_npz_scene(
        os.path.join(SUITE, f"scene_{i}.npz")))
    return [o.sdf for o in objects]


@pytest.fixture(scope="module")
def suite_pad_to():
    shapes = [f.shape for i in range(100) for f in _fields(i)]
    return tuple(int(v) for v in np.max(shapes, axis=0))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("sid", [0, 1])
@pytest.mark.parametrize("baked", [False, True])
def test_stage_scene_sdfs_matches_jax(sid, baked, suite_pad_to):
    fields = _fields(sid)
    j = _np(jsdf.stage_scene_sdfs(fields, baked=baked, pad_to=suite_pad_to))
    t = tsdf.stage_scene_sdfs(fields, "cpu", baked=baked,
                              pad_to=suite_pad_to)
    assert type(t).__name__ == type(j).__name__
    jdata = j.data4 if baked else j.data
    tdata = (t.data4 if baked else t.data).numpy()
    assert tdata.shape == jdata.shape
    assert tdata.shape[1:4] == tuple(-(-v // 16) * 16 for v in suite_pad_to)
    np.testing.assert_allclose(tdata, jdata, atol=1e-5, rtol=0)
    np.testing.assert_allclose(t.limits.numpy(), j.limits, atol=1e-5, rtol=0)


def test_exact_query_matches_jax():
    js = JScene.from_npz(CFG.replace(sdf_analytic=False, sdf_baked=False),
                         os.path.join(SUITE, "scene_0.npz"))
    jscene = js.env.scene_sdf()
    assert isinstance(jscene, jsdf.SceneSDF)
    params = _np(js.env.cost_params())
    rng = np.random.default_rng(0)
    centres = np.stack([o.pose_mat[:3, 3] for o in js.env.objects])
    inside = centres[rng.integers(len(centres), size=700)] \
        + rng.normal(scale=0.01, size=(700, 3))
    near = centres[rng.integers(len(centres), size=700)] \
        + rng.normal(scale=0.08, size=(700, 3))
    far = rng.uniform(-2.0, 2.0, size=(600, 3)) + np.array([0, 0, 2.5])
    pts = np.concatenate([inside, near, far]).astype(np.float32)
    args = (params.inv_poses, pts, params.epsilons, params.padding_scales,
            params.clearances, params.disables)
    jpot, jgrad, jcol = _np(jsdf.sdf_potentials(jscene, *args))
    tscn = interop.scene(_np(jscene), "cpu")
    assert isinstance(tscn, tsdf.SceneSDF)
    tpot, tgrad, tcol = tsdf.sdf_potentials(
        tscn, *(torch.as_tensor(np.array(a)) for a in args))
    # the three families are each exercised
    assert (jcol > 0).sum() > 100 and (jpot == 0).sum() > 100
    assert (jpot > 0).sum() > 100
    np.testing.assert_allclose(tpot.numpy(), jpot, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tcol.numpy(), jcol)


@pytest.fixture(scope="module")
def staged_problems():
    """Suite scene 0 staged by JAX on each backend, padded to 11 objects."""
    out = {}
    for name, over in (("analytic", {}),
                       ("baked", {"sdf_analytic": False}),
                       ("unbaked", {"sdf_analytic": False,
                                    "sdf_baked": False})):
        cfg = CFG.replace(**over)
        js = JScene.from_npz(cfg, os.path.join(SUITE, "scene_0.npz"))
        out[name] = (cfg, js, js.build_problem())
    return out


@pytest.mark.parametrize("backend", ["analytic", "baked", "unbaked"])
def test_pad_objects_matches_jax(backend, staged_problems):
    _, _, jprob = staged_problems[backend]
    jpad = _np(jbatch.pad_objects(jprob, 11))
    tpad = tbatch.pad_objects(interop.plan_problem(_np(jprob), "cpu"), 11)
    for f in type(tpad.scene)._fields:
        np.testing.assert_array_equal(getattr(tpad.scene, f).numpy(),
                                      getattr(jpad.scene, f))
    for f in type(tpad.cost_params)._fields:
        np.testing.assert_array_equal(getattr(tpad.cost_params, f).numpy(),
                                      getattr(jpad.cost_params, f))
    n = (tpad.scene.kinds if backend == "analytic"
         else tpad.scene.limits).shape[0]
    assert n == 11 > len(staged_problems[backend][1].env.objects)


@pytest.mark.parametrize("backend", ["analytic", "unbaked"])
def test_padded_plan_equals_unpadded(backend, staged_problems):
    cfg, js, jprob = staged_problems[backend]
    model = interop.panda_model(_np(js.model), "cpu")
    prob = interop.plan_problem(_np(jprob), "cpu")
    a = tplan.plan_fast(model, tcfg(cfg), prob)
    b = tplan.plan_fast(model, tcfg(cfg), tbatch.pad_objects(prob, 11))
    assert int(a.goal_idx) == int(b.goal_idx)
    assert bool(a.flag) == bool(b.flag)
    assert int(a.steps_used) == int(b.steps_used)
    np.testing.assert_allclose(b.traj.numpy(), a.traj.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("sid", range(6))
def test_synthetic_hard_scene_matches_jax(sid):
    jobj, jt = jgen.synthetic_hard_scene(sid)
    tobj, tt = tgen.synthetic_hard_scene(sid)
    assert tt == jt
    assert [o.name for o in tobj] == [o.name for o in jobj]
    assert [o.kind for o in tobj] == [o.kind for o in jobj]
    for a, b in zip(tobj, jobj):
        np.testing.assert_array_equal(a.extents, b.extents)
        np.testing.assert_array_equal(a.pose_mat, b.pose_mat)
        assert a.target == b.target and a.compute_grasp == b.compute_grasp


def test_host_only_cfg_change_restages_nothing(monkeypatch):
    """Flipping ``silent`` keeps the staged goal set, collision scene,
    cost parameters and learner field: the same tensors, no new IK."""
    cfg = tcfg(CFG.replace(sdf_analytic=False))
    scene = tscene.PlanningScene.from_npz(
        cfg, os.path.join(SUITE, "scene_0.npz"), device="cpu")
    builds = []
    real = tscene.gs.build_goal_set
    monkeypatch.setattr(tscene.gs, "build_goal_set",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    p1 = scene.build_problem()
    assert len(builds) == 1 and scene.has_staged()
    scene.cfg = scene.cfg.replace(silent=not scene.cfg.silent)
    assert scene.cfg != cfg and scene.cfg.jit_key() == cfg.jit_key()
    p2 = scene.build_problem()
    assert len(builds) == 1
    assert p2.goal_set is p1.goal_set
    assert p2.scene is p1.scene
    assert p2.cost_params is p1.cost_params
    assert p2.world_potential is p1.world_potential
    # a device-relevant change does re-stage
    scene.cfg = scene.cfg.replace(clearance=0.02)
    p3 = scene.build_problem()
    assert len(builds) == 2 and p3.goal_set is not p1.goal_set


def test_analytic_world_potential_matches_jax():
    """The learner field of a primitive scene on the grid backend."""
    js = JScene.from_npz(CFG.replace(sdf_analytic=False),
                         os.path.join(SUITE, "scene_1.npz"))
    fields = [o.sdf for o in js.env.objects]
    p = _np(js.env.cost_params())
    kinds, halfs, pens, _, _, dims, limits, _ = jsdf.analytic_prim_arrays(
        fields)
    jwp = _np(jsdf.bake_world_potential_analytic(
        kinds, halfs, pens, limits, p.inv_poses, p.epsilons,
        p.padding_scales, p.disables, dims, snap=False))
    def T(a):
        return torch.as_tensor(np.array(a))

    twp = tsdf.bake_world_potential_analytic(
        tsdf.make_analytic_scene(fields, "cpu"), T(p.inv_poses),
        T(p.epsilons), T(p.padding_scales), T(p.disables))
    assert (jwp.data > 0).sum() > 1000
    np.testing.assert_allclose(twp.data.numpy(), jwp.data, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(twp.origin.numpy(), jwp.origin)
    assert float(twp.delta) == float(jwp.delta)
