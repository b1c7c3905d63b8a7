"""Collision query of the port against the JAX package on the CPU.

Scene: synthetic scene 5 (target, two corridor obstacles, table), staged
by each package from its own copy of the scene generator.  Query points are
drawn with numpy around every primitive, so they fall inside, in the
hinge band and outside.

Tolerances: potentials and gradients atol 1e-4 (float32 arithmetic on
values up to ~2.5 with the inside penalty of 5; the two CPU backends
contract and order a few multiply-adds differently); collide counts are
exact except where a point sits within float rounding of a clearance
surface, which the seeds here avoid.  World potentials atol 1e-4 except
at cells whose nearest-cell index straddles a cell face by rounding
(allowed: at most 0.1% of cells)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.config import OMGConfig as JConfig
from omg_planner_tpu.ops import sdf as jsdf
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.ops import sdf as tsdf
from omg_planner_torch.planner.scene import PlanningScene as TScene

torch.set_num_threads(2)

ATOL = 1e-4


def T(a):
    return torch.tensor(np.array(a, np.float32))


@pytest.fixture(scope="module")
def scenes():
    js = JScene.synthetic(JConfig(silent=True), scene_id=5, n_obstacles=2)
    ts = TScene.synthetic(TConfig(silent=True), scene_id=5, n_obstacles=2,
                          device="cpu")
    return js, ts


def _points_around(objects, n_per, seed):
    """World points in a box 1.6x each primitive's half extents."""
    rng = np.random.default_rng(seed)
    out = []
    for o in objects:
        half = np.asarray(o.sdf.analytic[1], np.float64)
        local = rng.uniform(-1.6, 1.6, (n_per, 3)) * (half + 0.02)
        out.append(local @ o.pose_mat[:3, :3].T + o.pose_mat[:3, 3])
    return np.concatenate(out).astype(np.float32)


def _params(js, disables=None):
    p = jax.tree.map(np.asarray, js.env.cost_params())
    if disables is not None:
        p = p._replace(disables=np.asarray(disables, np.float32))
    return p


def _query_both(jscene, tscene, p, pts):
    jout = jsdf.sdf_potentials(jscene, jnp.asarray(p.inv_poses),
                               jnp.asarray(pts), jnp.asarray(p.epsilons),
                               jnp.asarray(p.padding_scales),
                               jnp.asarray(p.clearances),
                               jnp.asarray(p.disables))
    tp = interop.cost_params(p, "cpu")
    tout = tsdf.sdf_potentials(tscene, tp.inv_poses, T(pts), tp.epsilons,
                               tp.padding_scales, tp.clearances, tp.disables)
    return [np.asarray(a) for a in jout], [a.numpy() for a in tout]


def test_staged_scene_and_cost_params_equal(scenes):
    js, ts = scenes
    ja = jax.tree.map(np.asarray, js.env.scene_sdf())
    ta = ts.env.scene_sdf()
    assert isinstance(ta, tsdf.AnalyticScene)
    for name in ja._fields:
        np.testing.assert_array_equal(getattr(ta, name).numpy(),
                                      getattr(ja, name), name)
    jp = _params(js)
    tp = ts.env.cost_params()
    for name in jp._fields:
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      getattr(jp, name), name)


@pytest.mark.parametrize("disables", [None, [0, 1, 0, 0], [1, 0, 1, 1]])
def test_analytic_potentials(scenes, disables):
    js, ts = scenes
    pts = _points_around(js.env.objects, 300, seed=11)
    p = _params(js, disables)
    (jpot, jgrad, jcol), (tpot, tgrad, tcol) = _query_both(
        js.env.scene_sdf(), ts.env.scene_sdf(), p, pts)
    # the sample really covers all three hinge regimes
    assert (jpot > 0.5 * 0.2).any() and ((jpot > 0) & (jpot < 0.05)).any()
    assert (jpot == 0).any()
    np.testing.assert_allclose(tpot, jpot, atol=ATOL)
    np.testing.assert_allclose(tgrad, jgrad, atol=ATOL)
    np.testing.assert_array_equal(tcol, jcol)


def _grid_fields(objects, sdf_mod):
    """Data-backed copies of the primitives' voxel grids (the path a
    point-cloud or mesh scene takes)."""
    return [sdf_mod.SignedDensityField(o.sdf.data, o.sdf.origin, o.sdf.delta)
            for o in objects]


@pytest.fixture(scope="module")
def baked(scenes):
    js, ts = scenes
    jstack = jsdf.stage_scene_sdfs(_grid_fields(js.env.objects, jsdf),
                                   baked=True)
    tstack = tsdf.bake_scene(tsdf.combine_sdfs(
        _grid_fields(ts.env.objects, tsdf), "cpu"))
    return jstack, tstack


def test_bake_scene_equal(baked):
    jstack, tstack = baked
    np.testing.assert_array_equal(tstack.limits.numpy(),
                                  np.asarray(jstack.limits))
    np.testing.assert_allclose(tstack.data4.numpy(),
                               np.asarray(jstack.data4), atol=1e-5)
    # the interop path carries the JAX stack across unchanged
    c = interop.scene(jax.tree.map(np.asarray, jstack), "cpu")
    assert isinstance(c, tsdf.BakedSceneSDF)
    assert torch.equal(c.data4, T(np.asarray(jstack.data4)))


@pytest.mark.parametrize("disables", [None, [0, 0, 1, 0]])
def test_baked_potentials(scenes, baked, disables):
    js, _ = scenes
    jstack, _ = baked
    tstack = interop.scene(jax.tree.map(np.asarray, jstack), "cpu")
    pts = _points_around(js.env.objects, 300, seed=12)
    p = _params(js, disables)
    (jpot, jgrad, jcol), (tpot, tgrad, tcol) = _query_both(
        jstack, tstack, p, pts)
    assert (jpot > 0).any() and (jpot == 0).any()
    np.testing.assert_allclose(tpot, jpot, atol=ATOL)
    np.testing.assert_allclose(tgrad, jgrad, atol=ATOL)
    np.testing.assert_array_equal(tcol, jcol)
    # the per-object form the JAX package vmaps
    o = 1
    pts_obj = (p.inv_poses[o, :3, :3] @ pts.T).T + p.inv_poses[o, :3, 3]
    jv, jg = jsdf._query_one_object_baked(
        jnp.asarray(jstack.data4[o]).reshape(-1, 4), jnp.asarray(
            jstack.limits[o]), jnp.asarray(pts_obj))
    tv, tg = tsdf._query_one_object_baked(tstack, o, T(pts_obj))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=ATOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=ATOL)


def test_world_potential_bake_and_lookups(scenes, baked):
    js, _ = scenes
    jstack, _ = baked
    tstack = interop.scene(jax.tree.map(np.asarray, jstack), "cpu")
    p = _params(js)
    tp = interop.cost_params(p, "cpu")
    res = 0.03
    jwp = jsdf.bake_world_potential(
        jstack, jnp.asarray(p.inv_poses), jnp.asarray(p.epsilons),
        jnp.asarray(p.padding_scales), jnp.asarray(p.clearances),
        jnp.asarray(p.disables), resolution=res)
    twp = tsdf.bake_world_potential(
        tstack, tp.inv_poses, tp.epsilons, tp.padding_scales, tp.clearances,
        tp.disables, resolution=res)
    jd, td = np.asarray(jwp.data), twp.data.numpy()
    assert td.shape == jd.shape and (jd > 0).sum() > 100
    bad = np.abs(td - jd) > ATOL
    assert bad.mean() <= 1e-3, bad.sum()
    np.testing.assert_array_equal(twp.origin.numpy(), np.asarray(jwp.origin))
    assert float(twp.delta) == float(jwp.delta)

    # lookups on one field (carried across), inside and outside the grid
    wp = interop.world_potential(jax.tree.map(np.asarray, jwp), "cpu")
    rng = np.random.default_rng(13)
    pts = np.concatenate([
        _points_around(js.env.objects, 200, seed=14),
        rng.uniform([-0.6, -1.1, -0.3], [1.3, 1.1, 1.4], (400, 3)),
    ]).astype(np.float32)
    lo = np.asarray(jsdf.WORLD_BOUNDS[0])
    hi = lo + res * np.array(jd.shape)
    outside = ((pts < lo) | (pts > hi)).any(1)
    assert outside.sum() > 20
    for jfn, tfn in ((jsdf.world_potential_lookup_nearest,
                      tsdf.world_potential_lookup_nearest),
                     (jsdf.world_potential_lookup,
                      tsdf.world_potential_lookup)):
        jv = np.asarray(jfn(jwp, jnp.asarray(pts)))
        tv = tfn(wp, T(pts)).numpy()
        np.testing.assert_allclose(tv, jv, atol=ATOL)
        assert (tv[outside] == 0).all()
