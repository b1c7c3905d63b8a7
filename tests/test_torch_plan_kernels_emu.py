"""The plan step's kernels' own sources (``omg_planner_torch/csrc/panda_fk.cu``
and ``csrc/sdf_query.cu``) compiled with g++ against ``csrc/cuda_emu.h``
and run on the CPU, against their plain versions on the same inputs.

The emulation runs one fiber per CUDA thread (as
``tests/test_torch_rollout_emu.py`` says), so it executes each kernel's
indexing, block split, barrier and batch strides as written.  Arguments
are packed by the wrappers' own packers (``ops/kernels.py::_panda_fk_pack``,
``_sdf_query_pack``) from CPU tensors.  Cases, at small sizes:

* ``panda_fk``: N = 8, 37 (the last block of 4 ragged) and 40 in-limit
  configurations, with and without the mesh offsets and the points, and
  8 configurations alone against their rows of the N = 40 launch; N = 1,
  3, 30 and 61 (not multiples of a block's 4 configurations), with and
  without the points, bit for bit against the plain version computed
  with the host's ``cosf`` and ``sinf``, and the rows of the N = 61
  launch against launches of 1 and 3 configurations;
* ``sdf_query``: B = 2 scene rows, P = 200 points (a ragged last tile of
  32) around O = 3 objects (analytic: a box, a sphere and a cylinder;
  baked: random 4-channel grids whose dims are smaller than the padded
  stack's), ``disables`` on and off, one case with the scene rows shared
  (scene-axis stride 0), and each row alone against its row of the B = 2
  launch; O = 1, 10 and 20 objects (20: more than a block's 16 warps, so
  the warps loop), analytic and baked, ``disables`` on and off, each row
  alone and the rows reversed against the B = 2 launch; B = 2 rows of
  33,001-40,001 points (the loop layout) against launches of one row and
  at most 25,000 points (the spread one), bit for bit.

Bars: ``panda_fk`` 1e-6 on poses, origins, axes and points of O(1) size
against the plain version (the same float32 operations in the same order;
only the host's ``cosf`` and ``sinf`` may differ from torch's in the last
bit), and bit for bit where both take the host's; ``sdf_query`` 1e-5 on
potentials and gradients (the plain version sums the frame change in
another order), collision counts exact; the row-alone checks bit for
bit."""

import ctypes
import ctypes.util
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from omg_planner_torch.models import api, panda
from omg_planner_torch.ops import kernels
from omg_planner_torch.ops import sdf

torch.set_num_threads(2)


def _compile(out_dir, src):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    lib = os.path.join(out_dir, f"lib{src}_emu.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-DOMG_CUDA_EMU", "-x", "c++",
                    os.path.join(kernels.CSRC, f"{src}.cu"), "-o", lib],
                   check=True, capture_output=True)
    return ctypes.CDLL(lib)


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("plan_kernels_emu"))
    fk, query = _compile(out, "panda_fk"), _compile(out, "sdf_query")
    fns = {"fk": fk.omg_panda_fk,
           "analytic": query.omg_sdf_query_analytic,
           "baked": query.omg_sdf_query_baked}
    for name, fn in fns.items():
        fn.argtypes = kernels._LIBS[
            "panda_fk" if name == "fk" else "sdf_query"][2][fn.__name__]
        fn.restype = ctypes.c_int
    return fns


@pytest.fixture(scope="module")
def model():
    return panda.load_panda(15, "cpu")


def _configs(model, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = model.joint_lower.numpy(), model.joint_upper.numpy()
    return torch.as_tensor(rng.uniform(lo, hi, (n, 9)).astype(np.float32))


def _fk_args(model, q, apply_offset, with_points):
    return (q, api.kernel_tables(model).fk, apply_offset, with_points)


def _fk_emu(fn, args):
    keep, outs, ptrs, dims = kernels._panda_fk_pack(*args)
    assert fn(ptrs, dims, None) == 0
    del keep
    return outs


@pytest.mark.parametrize("n", [8, 37, 40])
@pytest.mark.parametrize("apply_offset,with_points",
                         [(True, True), (False, True), (True, False)])
def test_panda_fk_matches_plain(libs, model, n, apply_offset, with_points):
    args = _fk_args(model, _configs(model, n, n), apply_offset, with_points)
    got = _fk_emu(libs["fk"], args)
    want = kernels._panda_fk_op(*args)
    for name, a, b in zip(("poses", "origins", "axes", "x"), got, want):
        assert a.shape == b.shape, name
        err = float((a - b).abs().max()) if a.numel() else 0.0
        assert err <= 1e-6, (name, err)
    assert got[3].shape[2] == (15 if with_points else 0)


def test_panda_fk_rows_do_not_depend_on_the_batch(libs, model):
    q = _configs(model, 40, 7)
    full = _fk_emu(libs["fk"], _fk_args(model, q, True, True))
    part = _fk_emu(libs["fk"], _fk_args(model, q[30:38].clone(), True, True))
    for a, b in zip(full, part):
        assert torch.equal(a[30:38], b)


def _libm_trig(name):
    """``torch.<name>`` of float32 tensors through the host C library's
    ``cosf``/``sinf``, which the emulated kernel calls."""
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), f"{name}f")
    fn.argtypes, fn.restype = [ctypes.c_float], ctypes.c_float

    def trig(t):
        flat = [fn(float(v)) for v in t.reshape(-1).tolist()]
        return torch.tensor(flat, dtype=t.dtype).reshape(t.shape)
    return trig


@pytest.mark.parametrize("n", [1, 3, 30, 61])
@pytest.mark.parametrize("with_points", [False, True])
def test_panda_fk_bit_equal_to_plain(libs, model, monkeypatch, n,
                                     with_points):
    """Element-parallel chains, the offsets and the points in shared memory
    give the plain version's bits, given the same cos and sin."""
    args = _fk_args(model, _configs(model, n, 100 + n), True, with_points)
    got = _fk_emu(libs["fk"], args)
    with monkeypatch.context() as m:
        m.setattr(torch, "cos", _libm_trig("cos"))
        m.setattr(torch, "sin", _libm_trig("sin"))
        want = kernels.panda_fk_plain(
            args[0], *kernels.fk_table_parts(args[1]), *args[2:])
    for name, a, b in zip(("poses", "origins", "axes", "x"), got, want):
        assert a.shape == b.shape, name
        assert torch.equal(a, b), (name, float((a - b).abs().max()))
    if n == 61:                      # rows alone: the same bits
        q = args[0]
        for lo, hi in ((0, 1), (29, 32), (60, 61)):
            part = _fk_emu(libs["fk"], (q[lo:hi].clone(),) + args[1:])
            for a, b in zip(got, part):
                assert torch.equal(a[lo:hi], b)


def _spread(n):
    """The side of the cube that ``n`` objects and the points fill, as a
    multiple of three objects': the same density for every n, so a point
    meets as many objects as in the three-object cases (where ten
    penalised objects overlap, float32 sums of gradients ~10 of both
    versions stand ~2e-5 from float64)."""
    return max(1.0, (n / 3) ** (1 / 3))


def _objects(seed, n=3):
    """``n`` objects (box, sphere, cylinder, box, ...) near the origin:
    their analytic scene, world -> object poses [n, 4, 4] and query points
    [200, 3] inside, in the hinge band and outside."""
    rng = np.random.default_rng(seed)
    scene = sdf.AnalyticScene(
        kinds=torch.as_tensor(np.arange(n) % 3, dtype=torch.int32),
        halfs=torch.as_tensor(rng.uniform(0.04, 0.12, (n, 3)),
                              dtype=torch.float32),
        penals=torch.full((n,), 5.0),
        rounds=torch.as_tensor(np.resize([0.01, 0.02, 0.005], n),
                               dtype=torch.float32))
    poses = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        a = rng.normal(size=3)
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        th = np.linalg.norm(a)
        k /= th
        poses[i, :3, :3] = (np.eye(3) + np.sin(th) * k
                            + (1 - np.cos(th)) * k @ k)
        poses[i, :3, 3] = rng.uniform(-0.15, 0.15, 3) * _spread(n)
    inv = torch.as_tensor(np.linalg.inv(poses), dtype=torch.float32)
    pts = torch.as_tensor(rng.uniform(-0.3, 0.3, (200, 3)) * _spread(n),
                          dtype=torch.float32)
    return scene, inv, pts


def _baked(seed, n=3):
    """A baked stack of ``n`` objects, padded to 6 x 7 x 5 cells, whose
    own dims (from ``limits``) are 6 x 7 x 5, 4 x 5 x 5, 5 x 4 x 3, 6 x 7
    x 5, ..."""
    rng = np.random.default_rng(seed)
    dims = np.resize([[6, 7, 5], [4, 5, 5], [5, 4, 3]], (n, 3))
    data4 = rng.uniform(-0.2, 0.4, (n, 6, 7, 5, 4)).astype(np.float32)
    lo = rng.uniform(-0.25, -0.15, (n, 3))
    delta = np.resize([0.07, 0.1, 0.09], n)
    limits = np.concatenate([lo, lo + dims * delta[:, None], dims,
                             delta[:, None]], axis=1)
    return sdf.BakedSceneSDF(
        data4=torch.as_tensor(data4),
        limits=torch.as_tensor(limits, dtype=torch.float32))


def _params(disable: bool, n=3):
    """(epsilons, padding_scales, clearances, disables) of ``n`` objects;
    ``disable`` drops objects 1, 4, 7, ... (object 0 when it is alone)."""
    dis = torch.zeros(n)
    if disable:
        dis[min(1, n - 1)::3] = 1.0

    def per_object(values):
        return torch.as_tensor(np.resize(values, n), dtype=torch.float32)
    return (per_object([0.2, 0.15, 0.25]), per_object([1.0, 0.5, 2.0]),
            per_object([0.01, 0.0, 0.03]), dis)


def _query_rows(kind, seeds, disable, n=3):
    """Row inputs ``[B, ...]`` and scene inputs ``[B, O, ...]`` of B scene
    rows (one per seed) of ``n`` objects each."""
    rows, scenes = [], []
    for s in seeds:
        scene, inv, pts = _objects(s, n)
        if kind == "baked":
            scene = _baked(s, n)
        rows.append((inv, pts) + _params(disable, n))
        scenes.append(tuple(scene))
    return ([torch.stack(t) for t in zip(*rows)],
            [torch.stack(t) for t in zip(*scenes)])


def _query_emu(fn, row_args, scene_args):
    keep, outs, ptrs, dims = kernels._sdf_query_pack(row_args, scene_args)
    assert fn(ptrs, dims, None) == 0
    del keep
    return outs


def _query_plain(kind, row_args, scene_args):
    op = (kernels._sdf_baked_op if kind == "baked"
          else kernels._sdf_analytic_op)
    return op(*row_args, *scene_args)


def _close(got, want):
    for name, a, b in zip(("pot", "grad"), got[:2], want[:2]):
        err = float((a - b).abs().max())
        assert err <= 1e-5, (name, err)
    assert torch.equal(got[2], want[2])


@pytest.mark.parametrize("kind", ["analytic", "baked"])
@pytest.mark.parametrize("disable", [False, True])
def test_sdf_query_matches_plain(libs, kind, disable):
    row_args, scene_args = _query_rows(kind, (1, 2), disable)
    got = _query_emu(libs[kind], row_args, scene_args)
    want = _query_plain(kind, row_args, scene_args)
    _close(got, want)
    # the points reach every branch: inside, the band, outside
    assert float((want[0] > 0).float().mean()) > 0.05
    assert float(want[2].sum()) > 0 and float((want[0] == 0).sum()) > 0
    for b in range(2):                   # each row alone: the same bits
        one = _query_emu(libs[kind], [t[b:b + 1] for t in row_args],
                         [t[b:b + 1] for t in scene_args])
        for a, c in zip(one, got):
            assert torch.equal(a[0], c[b])


@pytest.mark.parametrize("kind", ["analytic", "baked"])
def test_sdf_query_shared_scene_rows(libs, kind):
    """Scene inputs expanded over the rows (stride 0, as the vmap rule
    leaves an unmapped scene) read the one row every time."""
    row_args, scene_args = _query_rows(kind, (3, 4), False)
    shared = [t[:1].expand(t.shape) for t in scene_args]
    dims = kernels._sdf_query_pack(row_args, shared)[3]
    scene_strides = (10, 11, 12, 13) if kind == "analytic" else (14, 15)
    assert all(dims[i] == 0 for i in scene_strides) and dims[4] > 0
    got = _query_emu(libs[kind], row_args, shared)
    want = _query_plain(kind, row_args,
                        [t.contiguous() for t in shared])
    _close(got, want)


@pytest.mark.parametrize("kind", ["analytic", "baked"])
@pytest.mark.parametrize("n_obj", [1, 10, 20])
@pytest.mark.parametrize("disable", [False, True])
def test_sdf_query_object_counts(libs, kind, n_obj, disable):
    """One warp an object, up to 16 a block: one object, the plan's ten,
    and twenty (the warps loop); the rows alone and in reverse order give
    the bits of the B = 2 launch."""
    row_args, scene_args = _query_rows(kind, (5, 6), disable, n_obj)
    got = _query_emu(libs[kind], row_args, scene_args)
    _close(got, _query_plain(kind, row_args, scene_args))
    if not (disable and n_obj == 1):     # the lone object is dropped
        assert float(got[2].sum()) > 0 and float((got[0] > 0).sum()) > 0
    rev = _query_emu(libs[kind], [t.flip(0) for t in row_args],
                     [t.flip(0) for t in scene_args])
    for b in range(2):
        one = _query_emu(libs[kind], [t[b:b + 1] for t in row_args],
                         [t[b:b + 1] for t in scene_args])
        for a, c, r in zip(one, got, rev):
            assert torch.equal(a[0], c[b]) and torch.equal(r[1 - b], c[b])


@pytest.mark.parametrize("kind", ["analytic", "baked"])
@pytest.mark.parametrize("n_obj,p", [(1, 40_001), (10, 33_001), (20, 33_001)])
def test_sdf_query_layouts_agree(libs, kind, n_obj, p):
    """From 2,048 tiles of 32 points (the learner sweeps' sizes) a thread
    takes a point and loops over the objects; a point's result never
    depends on the layout: the B = 2 launch gives the bits of launches of
    one row and at most 25,000 points (the spread layout, which the other
    cases hold to the plain version)."""
    row_args, scene_args = _query_rows(kind, (7, 8), n_obj > 1, n_obj)
    gen = torch.Generator().manual_seed(p)
    row_args[1] = (torch.rand(2, p, 3, generator=gen) - 0.5) * (
        0.6 * _spread(n_obj))
    assert 2 * -(-p // 32) >= 2048 > -(-25_000 // 32)
    got = _query_emu(libs[kind], row_args, scene_args)
    assert float(got[2].sum()) > 0 and float((got[0] > 0).sum()) > 0
    for b in range(2):
        parts = []
        for lo in range(0, p, 25_000):
            rows = [t[b:b + 1] for t in row_args]
            rows[1] = rows[1][:, lo:lo + 25_000]
            parts.append(_query_emu(libs[kind], rows,
                                    [t[b:b + 1] for t in scene_args]))
        for a, c in zip(zip(*parts), got):
            assert torch.equal(torch.cat(a, 1)[0], c[b])
