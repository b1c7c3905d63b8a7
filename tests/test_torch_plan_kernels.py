"""The plan step's kernels (``ops/kernels.py``: ``panda_fk``, ``sdf_query``)
as the CPU runs them, through their plain versions, against the JAX
package; their vmap rules, gradients, dispatch and builds; and the plan
through the routed ``models/api.py`` and ``ops/sdf.py``.

Inputs are made with numpy from a seed and handed to both packages.

Bars:
* ``sdf_query`` against ``omg_planner_tpu/ops/sdf.py::sdf_potentials``:
  potentials and gradients atol 1e-4, collision counts exact (the bars of
  ``tests/test_torch_sdf.py``: float32 on values up to ~2.5, the two CPU
  backends contract and order a few multiply-adds differently);
* ``panda_fk`` against the JAX package's batched FK and
  ``collision_point_positions``: atol 1e-5 on poses, origins, axes and
  points (``tests/test_torch_panda.py``'s bar);
* each vmap rule over S = 3 rows: bit for bit a loop of single calls;
* the plans: ``tests/test_torch_plan.py``'s and
  ``tests/test_torch_batched.py``'s bars (goal, verdict and steps equal,
  the trajectory within 2e-3 of JAX's)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.config import OMGConfig as JConfig
from omg_planner_tpu.models import panda as jpanda
from omg_planner_tpu.ops import sdf as jsdf
from omg_planner_tpu.parallel import batch as jbatch
from omg_planner_tpu.planner import plan as jplan
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.models import api as tapi
from omg_planner_torch.models import panda as tpanda
from omg_planner_torch.ops import kernels
from omg_planner_torch.ops import sdf as tsdf
from omg_planner_torch.parallel import batch as tbatch
from omg_planner_torch.planner import plan as tplan

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE = os.path.join(ROOT, "data", "suite_v2")
ATOL_SDF = 1e-4
ATOL_FK = 1e-5
JAX_TOL = 2e-3
# a small plan (tests/test_torch_batched.py's configuration)
CFG = JConfig(silent=True, optim_steps=8, extra_smooth_steps=3,
              goal_set_max_num=10, ik_seed_num=2, ik_max_iters=25,
              learner_interp_steps=8, sdf_analytic=True)


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def T(a):
    return torch.tensor(np.array(a, np.float32))


@pytest.fixture(scope="module")
def scene():
    """Synthetic scene 5 staged by the JAX package, its analytic scene and
    baked grid stack (the primitives' own voxel grids), both carried to
    the port, and its cost parameters."""
    js = JScene.synthetic(JConfig(silent=True), scene_id=5, n_obstacles=2)
    fields = [jsdf.SignedDensityField(o.sdf.data, o.sdf.origin, o.sdf.delta)
              for o in js.env.objects]
    jbaked = jsdf.stage_scene_sdfs(fields, baked=True)
    janalytic = js.env.scene_sdf()
    return dict(
        js=js, jscenes={"analytic": janalytic, "baked": jbaked},
        tscenes={"analytic": interop.scene(np_tree(janalytic), "cpu"),
                 "baked": interop.scene(np_tree(jbaked), "cpu")},
        params=np_tree(js.env.cost_params()))


def _points(objects, n_per, seed):
    """World points in a box 1.6x each primitive's half extents: inside,
    in the hinge band and outside."""
    rng = np.random.default_rng(seed)
    out = []
    for o in objects:
        half = np.asarray(o.sdf.analytic[1], np.float64)
        local = rng.uniform(-1.6, 1.6, (n_per, 3)) * (half + 0.02)
        out.append(local @ o.pose_mat[:3, :3].T + o.pose_mat[:3, 3])
    return np.concatenate(out).astype(np.float32)


def _cost(p, disables=None):
    """(inv_poses, epsilons, padding_scales, clearances, disables) as
    float32 numpy."""
    dis = p.disables if disables is None else disables
    return tuple(np.asarray(a, np.float32) for a in (
        p.inv_poses, p.epsilons, p.padding_scales, p.clearances, dis))


@pytest.mark.parametrize("kind", ["analytic", "baked"])
@pytest.mark.parametrize("disables", [None, [0, 1, 0, 1]])
def test_sdf_query_matches_jax(scene, kind, disables):
    pts = _points(scene["js"].env.objects, 200, seed=21)
    inv, eps, pad, clr, dis = _cost(scene["params"], disables)
    jout = jsdf.sdf_potentials(scene["jscenes"][kind], jnp.asarray(inv),
                               jnp.asarray(pts), jnp.asarray(eps),
                               jnp.asarray(pad), jnp.asarray(clr),
                               jnp.asarray(dis))
    tout = kernels.sdf_query(scene["tscenes"][kind], T(inv), T(pts), T(eps),
                             T(pad), T(clr), T(dis))
    jpot, jgrad, jcol = (np.asarray(a) for a in jout)
    assert (jpot > 0).any() and (jpot == 0).any() and (jcol > 0).any()
    np.testing.assert_allclose(tout[0].numpy(), jpot, atol=ATOL_SDF)
    np.testing.assert_allclose(tout[1].numpy(), jgrad, atol=ATOL_SDF)
    np.testing.assert_array_equal(tout[2].numpy(), jcol)


@pytest.fixture(scope="module")
def models():
    return jpanda.load_panda(collision_point_num=15), \
        tpanda.load_panda(15, "cpu")


def _configs(n, seed):
    rng = np.random.default_rng(seed)
    lo = np.asarray(jpanda.load_panda().joint_lower)
    hi = np.asarray(jpanda.load_panda().joint_upper)
    return rng.uniform(lo, hi, (n, 9)).astype(np.float32)


def _fk(tm, q, apply_offset=True, with_points=True):
    return kernels.panda_fk(q, tapi.kernel_tables(tm).fk, apply_offset,
                            with_points)


@pytest.mark.parametrize("apply_offset", [True, False])
def test_panda_fk_matches_jax(models, apply_offset):
    jm, tm = models
    q = _configs(48, 3)
    jp, jo, ja = jax.jit(lambda m, q: jpanda.forward_kinematics_batch(
        m, q, return_joint_info=True, apply_offset=apply_offset))(
            jm, jnp.asarray(q))
    jx = jpanda.collision_point_positions(jm, jp)
    got = _fk(tm, torch.as_tensor(q), apply_offset)
    for name, a, b in zip(("poses", "origins", "axes", "points"), got,
                          (jp, jo, ja, jx)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL_FK,
                                   err_msg=name)
    no_pts = _fk(tm, torch.as_tensor(q), apply_offset, with_points=False)
    assert no_pts[3].shape == (48, 10, 0, 3)
    for a, b in zip(no_pts[:3], got[:3]):
        assert torch.equal(a, b)


def test_panda_fk_vmap_rule_folds_rows(models):
    _, tm = models
    qs = torch.as_tensor(_configs(3 * 20, 4).reshape(3, 20, 9))
    mapped = torch.func.vmap(lambda q: _fk(tm, q))(qs)
    for i in range(3):
        for a, b in zip(mapped, _fk(tm, qs[i])):
            assert torch.equal(a[i], b)
    # nested: rows of rows, and a single configuration per call
    nested = torch.func.vmap(torch.func.vmap(lambda q: _fk(tm, q[None])))(qs)
    for a, b in zip(nested, mapped):
        assert torch.equal(a[:, :, 0], b)


def test_panda_fk_vmap_refuses_mapped_tables(models):
    _, tm = models
    tables = tapi.kernel_tables(tm).fk[None].expand(3, -1)
    q = torch.as_tensor(_configs(4, 5))
    with pytest.raises(ValueError, match="tables"):
        torch.func.vmap(lambda t: kernels.panda_fk(q, t))(tables)


def _rows3(scene, kind):
    """Three rows of query inputs: the scene's objects moved by a few cm
    per row, its points, and the scene tensors stacked per row."""
    inv, eps, pad, clr, dis = (T(a) for a in _cost(scene["params"]))
    invs = inv[None].repeat(3, 1, 1, 1)
    invs[1, :, :3, 3] += 0.03
    invs[2, :, :3, 3] -= 0.02
    pts = torch.stack([T(_points(scene["js"].env.objects, 60, seed=s))
                       for s in (31, 32, 33)])
    sc = scene["tscenes"][kind]
    stacked = type(sc)(*(t[None].repeat(3, *([1] * t.ndim)) for t in sc))
    return sc, stacked, invs, pts, (eps, pad, clr, dis)


@pytest.mark.parametrize("kind", ["analytic", "baked"])
@pytest.mark.parametrize("scene_mapped", [False, True])
def test_sdf_query_vmap_rule_folds_rows(scene, kind, scene_mapped):
    sc, stacked, invs, pts, rest = _rows3(scene, kind)
    if scene_mapped:
        mapped = torch.func.vmap(lambda s, i, p: kernels.sdf_query(
            s, i, p, *rest))(stacked, invs, pts)
    else:
        mapped = torch.func.vmap(lambda i, p: kernels.sdf_query(
            sc, i, p, *rest))(invs, pts)
    for r in range(3):
        one = kernels.sdf_query(sc, invs[r], pts[r], *rest)
        for a, b in zip(mapped, one):
            assert torch.equal(a[r], b)


def test_kernels_have_no_gradient(models, scene):
    _, tm = models
    q = torch.as_tensor(_configs(4, 6)).requires_grad_()
    with pytest.raises(RuntimeError, match="autograd"):
        _fk(tm, q)[3].sum().backward()
    inv, eps, pad, clr, dis = (T(a) for a in _cost(scene["params"]))
    pts = T(_points(scene["js"].env.objects, 10, seed=7)).requires_grad_()
    with pytest.raises(RuntimeError, match="autograd"):
        kernels.sdf_query(scene["tscenes"]["analytic"], inv, pts, eps, pad,
                          clr, dis)[0].sum().backward()


@pytest.mark.parametrize("op", ["panda_fk", "sdf_query_analytic",
                                "sdf_query_baked"])
def test_ops_dispatch_plain_on_cpu_kernel_on_cuda(op):
    """The CPU key runs the plain version, the CUDA key the launch; no
    catch-all kernel, so a tensor on another device finds none."""
    name = f"omg_torch::{op}"
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    assert has(name, "CPU") and has(name, "CUDA")
    assert not has(name, "CompositeImplicitAutograd")
    assert not has(name, "CompositeExplicitAutograd")


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(kernels, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(kernels, "_nvcc", lambda: "false")
    monkeypatch.setattr(kernels, "_ENTRIES", {})
    for lib, entry in (("panda_fk", "omg_panda_fk"),
                       ("sdf_query", "omg_sdf_query_baked")):
        with pytest.raises(RuntimeError, match=f"nvcc failed on {lib}"):
            kernels._entry(lib, entry)


def test_library_name_hashes_included_headers(monkeypatch, tmp_path):
    """An edit to the shared header renames (so rebuilds) both libraries
    that include it and no other."""
    before = {lib: kernels._lib_path(lib) for lib in kernels._LIBS}
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in os.listdir(kernels.CSRC):
        (csrc / name).write_bytes(
            open(os.path.join(kernels.CSRC, name), "rb").read())
    with open(csrc / "sdf_point.cuh", "a") as f:
        f.write("\n// edited\n")
    monkeypatch.setattr(kernels, "CSRC", str(csrc))
    after = {lib: kernels._lib_path(lib) for lib in kernels._LIBS}
    changed = {lib for lib in before if before[lib] != after[lib]}
    assert changed == {"rigid_rollout", "rigid_rollout_cycles", "sdf_query"}


@pytest.fixture
def counted(monkeypatch):
    """Counts of the wrappers' calls (the routed path reaches them)."""
    calls = {"panda_fk": 0, "sdf_query": 0}
    for name in calls:
        orig = getattr(kernels, name)

        def wrapper(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(kernels, name, wrapper)
    return calls


def test_routed_plan_fast_matches_jax(counted):
    js = JScene.synthetic(CFG, scene_id=5, n_obstacles=2)
    jprob = js.build_problem()
    jres = np_tree(jax.jit(lambda m, p: jplan.plan_fast(m, CFG, p))(
        js.model, jprob))
    tres = tplan.plan_fast(interop.panda_model(np_tree(js.model), "cpu"),
                           tcfg(CFG), interop.plan_problem(np_tree(jprob),
                                                           "cpu"))
    steps = int(tres.steps_used)
    assert int(tres.goal_idx) == int(jres.goal_idx)
    assert bool(tres.flag) == bool(jres.flag)
    assert steps == int(jres.steps_used)
    np.testing.assert_allclose(tres.traj.numpy(), jres.traj, atol=JAX_TOL)
    # one FK (with points) and one query a CHOMP step at least
    assert counted["panda_fk"] >= steps and counted["sdf_query"] >= steps


def test_routed_plan_batch_vmap_matches_jax(counted):
    sids = (0, 2)
    jprobs = [JScene.from_npz(CFG, os.path.join(
        SUITE, f"scene_{sid}.npz")).build_problem() for sid in sids]
    n_obj = max(p.cost_params.inv_poses.shape[0] for p in jprobs)
    jprobs = [jbatch.pad_objects(p, n_obj) for p in jprobs]
    model = JScene.from_npz(CFG, os.path.join(SUITE, "scene_0.npz")).model
    jres = np_tree(jax.jit(jbatch.plan_batch_vmap, static_argnums=(1,))(
        model, CFG.jit_key(), jbatch.stack_problems(jprobs)))
    tres = tbatch.plan_batch_vmap(
        interop.panda_model(np_tree(model), "cpu"), tcfg(CFG),
        tbatch.stack_problems([interop.plan_problem(np_tree(p), "cpu")
                               for p in jprobs]))
    for i in range(len(sids)):
        assert int(tres.goal_idx[i]) == int(jres.goal_idx[i])
        assert bool(tres.flag[i]) == bool(jres.flag[i])
        assert int(tres.steps_used[i]) == int(jres.steps_used[i])
        np.testing.assert_allclose(tres.traj[i].numpy(), jres.traj[i],
                                   atol=JAX_TOL, rtol=0)
    assert counted["panda_fk"] > 0 and counted["sdf_query"] > 0
