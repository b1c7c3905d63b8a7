"""The fused world field (``cfg.sdf_fused``) of the port against the JAX
package on the CPU, at ``world_field_resolution`` 0.04 m (a 38 x 45 x 35
grid).

* The bakes on a primitive scene of four axis-aligned objects (box,
  cylinder, sphere, table) placed so that no world cell centre lies within
  0.1 object cell of a face of its nearest object cell (checked here in
  float64): ``bake_world_field`` (nearest cell of the baked stack) and
  ``bake_world_field_analytic`` with ``snap=True`` and ``snap=False``,
  each against JAX's ``data5``, with some and with all objects disabled.
  Bars: atol 1e-5 on the potential and min-distance channels, 1e-4 on
  the gradient channels (a difference of values over 2h).  Measured:
  potential 6.0e-7, min distance 6.0e-7, gradients 1.5e-5 (``snap=False``;
  the nearest and snapped bakes 8.6e-6 and below).  The suite's tables sit
  exactly on world cell faces, where the nearest cell is decided by float
  rounding; this scene keeps the nearest-cell bakes away from such ties.
* ``world_field_query`` on JAX's field at 4,096 points inside and outside
  the grid: atol 1e-5, collide flags equal, zero outside.
* A fused-backend plan of a JAX-staged grid problem (suite scene 0,
  ``sdf_analytic=False, sdf_fused=True``), both loops: goal, verdict and
  steps equal, trajectory within atol 2e-3.
* ``PlanningScene`` staging under ``sdf_fused``: the field equals JAX's
  staged field (the production ``snap=False`` bake, bars as above), the
  learner field is a view of its potential channel, an analytic scene
  gives None, a host-only cfg change re-bakes nothing; the cascade's
  ``fused`` backend plans."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.ops import sdf as jsdf
from omg_planner_tpu.planner import plan as jplan
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.ops import sdf as tsdf
from omg_planner_torch.planner import cascade as tcascade
from omg_planner_torch.planner import plan as tplan
from omg_planner_torch.planner.scene import PlanningScene as TScene
from test_golden import CFG

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE0 = os.path.join(ROOT, "data", "suite_v2", "scene_0.npz")
RES = 0.04
POT_TOL, GRAD_TOL = 1e-5, 1e-4
FUSED_CFG = CFG.replace(sdf_analytic=False, sdf_fused=True,
                        world_field_resolution=RES)
# (kind, extents, delta, translation): axis aligned, off the world grid
OBJECTS = [("box", [0.06, 0.05, 0.12], 0.0075, [0.5538, 0.09, 0.2438]),
           ("cylinder", [0.04, 0.2], 0.0075, [0.4424, -0.1949, 0.3076]),
           ("sphere", [0.05], 0.0075, [0.5987, -0.0562, 0.4487]),
           ("box", [1.0, 1.6, 0.36], 0.02, [0.6704, 0.0097, 0.0007])]


def T(a):
    return torch.as_tensor(np.array(a))


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _check_field(t, j):
    t = t.data5.numpy() if hasattr(t, "data5") else t
    j = np.asarray(j.data5 if hasattr(j, "data5") else j)
    assert t.shape == j.shape
    for ch, tol in ((0, POT_TOL), (slice(1, 4), GRAD_TOL), (4, POT_TOL)):
        np.testing.assert_allclose(t[..., ch], j[..., ch], atol=tol, rtol=0)


@pytest.fixture(scope="module")
def prims():
    fields, inv = [], []
    for kind, ext, delta, t in OBJECTS:
        f = jsdf.SignedDensityField.from_analytic(kind, ext, delta=delta)
        fields.append(f.penalize_inside(5.0))
        m = np.eye(4)
        m[:3, 3] = t
        inv.append(np.linalg.inv(m))
    params = dict(inv=np.asarray(inv, np.float32),
                  eps=np.array([0.2, 0.2, 0.1, 0.05], np.float32),
                  pad=np.array([1.0, 1.0, 1.0, 0.5], np.float32),
                  clear=np.array([0.01, 0.01, 0.0, 0.0], np.float32))
    return fields, params


def test_scene_keeps_off_cell_faces(prims):
    """The premise of the nearest-cell comparisons: every (world cell,
    object, axis) grid coordinate is at least 0.1 from an integer."""
    fields, p = prims
    lo, hi = jsdf.WORLD_BOUNDS
    limits = jsdf.scene_limits(fields)[0].astype(np.float64)
    dims = [int(np.ceil((hi[i] - lo[i]) / RES)) for i in range(3)]
    assert dims == [38, 45, 35]
    for o in range(len(fields)):
        t = -p["inv"][o, :3, 3].astype(np.float64)
        for a in range(3):
            x = lo[a] + (np.arange(dims[a]) + 0.5) * RES
            pg = (x - t[a] - limits[o, a]) / limits[o, 9]
            assert np.abs(pg - np.round(pg)).min() > 0.1


@pytest.mark.parametrize("disabled", ["table", "all"])
@pytest.mark.parametrize("mode", ["nearest", "snap", "true"])
def test_bakes_match_jax(prims, mode, disabled):
    fields, p = prims
    dis = (np.array([0, 0, 0, 1], np.float32) if disabled == "table"
           else np.ones(4, np.float32))
    args = (p["inv"], p["eps"], p["pad"], p["clear"], dis)
    if mode == "nearest":
        stack = jsdf.stage_scene_sdfs(fields, baked=True)
        j = jax.jit(lambda s: jsdf.bake_world_field(
            s, *args, resolution=RES))(stack)
        t = tsdf.bake_world_field(interop.scene(_np(stack), "cpu"),
                                  *(T(a) for a in args), resolution=RES)
    else:
        kinds, halfs, pens, _, _, dims, limits, _ = \
            jsdf.analytic_prim_arrays(fields)
        j = jax.jit(lambda: jsdf.bake_world_field_analytic(
            kinds, halfs, pens, jnp.asarray(limits), *args, dims,
            resolution=RES, snap=mode == "snap"))()
        t = tsdf.bake_world_field_analytic(
            T(kinds), T(halfs), T(pens), T(limits), *(T(a) for a in args),
            T(dims), resolution=RES, snap=mode == "snap")
    j = _np(j)
    if disabled == "all":
        assert (j.data5[..., 0] == 0).all() and (j.data5[..., 4] == 1e3).all()
    else:
        assert (j.data5[..., 0] > 0).sum() > 500
    _check_field(t, j)
    np.testing.assert_array_equal(t.origin.numpy(), j.origin)
    assert float(t.delta) == float(j.delta)


@pytest.fixture(scope="module")
def jax_fused():
    """Suite scene 0 staged by JAX on the fused backend."""
    js = JScene.from_npz(FUSED_CFG, SUITE0)
    return js, js.build_problem()


def test_world_field_query_matches_jax(jax_fused):
    _, jprob = jax_fused
    wf = jprob.world_field
    assert wf is not None and wf.data5.shape == (38, 45, 35, 5)
    rng = np.random.default_rng(21)
    pts = np.concatenate([
        rng.uniform([0.2, -0.4, 0.1], [0.9, 0.4, 0.6], (3072, 3)),
        rng.uniform([-0.7, -1.2, -0.4], [1.4, 1.2, 1.5], (1024, 3)),
    ]).astype(np.float32)
    jpot, jgrad, jcol = _np(jsdf.world_field_query(wf, jnp.asarray(pts)))
    tpot, tgrad, tcol = tsdf.world_field_query(
        interop.world_field(_np(wf), "cpu"), T(pts))
    lo = np.asarray(jsdf.WORLD_BOUNDS[0])
    outside = ((pts < lo + RES / 2)
               | (pts > lo + RES * (np.array(wf.data5.shape[:3]) - 0.5))
               ).any(1)
    assert outside.sum() > 100 and (jpot > 0).sum() > 100
    assert (jcol > 0).sum() > 10
    np.testing.assert_allclose(tpot.numpy(), jpot, atol=POT_TOL, rtol=0)
    np.testing.assert_allclose(tgrad.numpy(), jgrad, atol=POT_TOL, rtol=0)
    np.testing.assert_array_equal(tcol.numpy(), jcol)
    assert (tpot.numpy()[outside] == 0).all()
    assert (tcol.numpy()[outside] == 0).all()


@pytest.mark.parametrize("loop", ["plan_fast", "plan"])
def test_fused_plan_matches_jax(jax_fused, loop):
    js, jprob = jax_fused
    jfn, tfn = getattr(jplan, loop), getattr(tplan, loop)
    jres = _np(jax.jit(lambda m, p: jfn(m, FUSED_CFG, p))(js.model, jprob))
    tprob = interop.plan_problem(_np(jprob), "cpu")
    assert tprob.world_field is not None
    tres = tfn(interop.panda_model(_np(js.model), "cpu"), tcfg(FUSED_CFG),
               tprob)
    assert int(tres.goal_idx) == int(jres.goal_idx)
    assert bool(tres.flag) == bool(jres.flag)
    assert int(tres.steps_used) == int(jres.steps_used)
    np.testing.assert_allclose(tres.traj.numpy(), jres.traj, atol=2e-3)


def test_scene_fused_staging(jax_fused):
    js, _ = jax_fused
    scene = TScene.from_npz(tcfg(FUSED_CFG), SUITE0, device="cpu")
    wf = scene._world_field()
    _check_field(wf, _np(js._world_field()))
    # the learner field is a view of the potential channel, not a bake
    wp = scene._world_potential()
    assert wp.data.data_ptr() == wf.data5.data_ptr()
    assert wp.data.shape == wf.data5.shape[:3]
    assert torch.equal(wp.data, wf.data5[..., 0])
    # a host-only cfg change re-bakes nothing
    scene.cfg = scene.cfg.replace(silent=not scene.cfg.silent)
    assert scene._world_field() is wf
    # an edit re-bakes
    scene.env.update_pose(scene.env.names[1],
                          scene.env.objects[1].pose_mat)
    assert scene._world_field() is not wf
    # the analytic backend ignores the flag, as in the JAX package
    an = TScene.from_npz(tcfg(FUSED_CFG.replace(sdf_analytic=True)), SUITE0,
                         device="cpu")
    assert isinstance(an.env.scene_sdf(), tsdf.AnalyticScene)
    assert an._world_field() is None


def test_cascade_fused_backend_plans():
    scene = TScene.from_npz(tcfg(FUSED_CFG.replace(sdf_fused=False)),
                            SUITE0, device="cpu")
    out = tcascade.plan_cascade(scene, backends=("fused",), goal_retries=0)
    assert out is not None and out.backend == "fused" and out.attempts == 1
    assert np.isfinite(out.result.traj).all()
    assert scene._wf_cache is not None
    assert not scene.cfg.sdf_fused  # the session cfg is restored
