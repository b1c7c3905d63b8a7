"""The plan step's kernels' own sources (``omg_planner_torch/csrc/panda_fk.cu``
and ``csrc/sdf_query.cu``) compiled with g++ against ``csrc/cuda_emu.h``
and run on the CPU, against their plain versions on the same inputs.

The emulation runs one fiber per CUDA thread (as
``tests/test_torch_rollout_emu.py`` says), so it executes each kernel's
indexing, block split, barrier and batch strides as written.  Arguments
are packed by the wrappers' own packers (``ops/kernels.py::_panda_fk_pack``,
``_sdf_query_pack``) from CPU tensors.  Cases, at small sizes:

* ``panda_fk``: N = 8, 37 (the last block of 8 ragged) and 40 in-limit
  configurations, with and without the mesh offsets and the points, and
  8 configurations alone against their rows of the N = 40 launch;
* ``sdf_query``: B = 2 scene rows, P = 200 points around O = 3 objects
  (analytic: a box, a sphere and a cylinder; baked: random 4-channel grids
  whose dims are smaller than the padded stack's), ``disables`` on and
  off, one case with the scene rows shared (scene-axis stride 0), and each
  row alone against its row of the B = 2 launch.

Bars: ``panda_fk`` 1e-6 on poses, origins, axes and points of O(1) size
(the same float32 operations in the same order; only the host's ``cosf``
and ``sinf`` may differ from torch's in the last bit); ``sdf_query`` 1e-5
on potentials and gradients (the plain version sums the frame change in
another order), collision counts exact; the row-alone checks bit for
bit."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from omg_planner_torch.models import panda
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
    return (q, panda.pqr_table(model.pose_0, model.chain_post), model.pose_0,
            model.center_offset, model.collision_points, apply_offset,
            with_points)


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


def _objects(seed):
    """Three objects (box, sphere, cylinder) near the origin: their
    analytic scene, world -> object poses [3, 4, 4] and query points
    [200, 3] inside, in the hinge band and outside."""
    rng = np.random.default_rng(seed)
    scene = sdf.AnalyticScene(
        kinds=torch.tensor([0, 1, 2], dtype=torch.int32),
        halfs=torch.as_tensor(rng.uniform(0.04, 0.12, (3, 3)),
                              dtype=torch.float32),
        penals=torch.tensor([5.0, 5.0, 5.0]),
        rounds=torch.tensor([0.01, 0.02, 0.005]))
    poses = np.tile(np.eye(4), (3, 1, 1))
    for i in range(3):
        a = rng.normal(size=3)
        k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        th = np.linalg.norm(a)
        k /= th
        poses[i, :3, :3] = (np.eye(3) + np.sin(th) * k
                            + (1 - np.cos(th)) * k @ k)
        poses[i, :3, 3] = rng.uniform(-0.15, 0.15, 3)
    inv = torch.as_tensor(np.linalg.inv(poses), dtype=torch.float32)
    pts = torch.as_tensor(rng.uniform(-0.3, 0.3, (200, 3)),
                          dtype=torch.float32)
    return scene, inv, pts


def _baked(seed):
    """A baked stack of three objects, padded to 6 x 7 x 5 cells, whose
    own dims (from ``limits``) are 6 x 7 x 5, 4 x 5 x 5 and 5 x 4 x 3."""
    rng = np.random.default_rng(seed)
    dims = np.array([[6, 7, 5], [4, 5, 5], [5, 4, 3]])
    data4 = rng.uniform(-0.2, 0.4, (3, 6, 7, 5, 4)).astype(np.float32)
    lo = rng.uniform(-0.25, -0.15, (3, 3))
    delta = np.array([0.07, 0.1, 0.09])
    limits = np.concatenate([lo, lo + dims * delta[:, None], dims,
                             delta[:, None]], axis=1)
    return sdf.BakedSceneSDF(
        data4=torch.as_tensor(data4),
        limits=torch.as_tensor(limits, dtype=torch.float32))


def _params(disable: bool):
    dis = torch.tensor([0.0, 1.0 if disable else 0.0, 0.0])
    return (torch.tensor([0.2, 0.15, 0.25]), torch.tensor([1.0, 0.5, 2.0]),
            torch.tensor([0.01, 0.0, 0.03]), dis)


def _query_rows(kind, seeds, disable):
    """Row inputs ``[B, ...]`` and scene inputs ``[B, O, ...]`` of B scene
    rows (one per seed)."""
    rows, scenes = [], []
    for s in seeds:
        scene, inv, pts = _objects(s)
        if kind == "baked":
            scene = _baked(s)
        rows.append((inv, pts) + _params(disable))
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
