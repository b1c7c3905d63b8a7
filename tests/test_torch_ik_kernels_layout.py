"""How the goal-set build hands its IK kernels their inputs
(``omg_planner_torch/ops/kernels.py::_ik_prefilter_pack``,
``_ik_chain_pack``; ``ops/ik.py::ik_batch_fixed``,
``_solve_chain_fused``), on the CPU.

* The prefilter's targets are one standoff stage of the chain's poses, a
  strided view (``tgt[:, -1]``, and ``tgt[:, :, -1]`` flattened for a
  wave of scenes): the packer passes the view itself and its lane stride,
  so the card copies nothing.  A tensor whose lanes do not lie one stride
  apart is copied once.
* A single scene's chain (and a wave whose scenes share one budget) hands
  the operator its budget as an int: the solve makes no tensor for it, so
  the card gets no host-to-device copy.  A wave of different budgets
  keeps a per-lane tensor.
* Suite scene 1's goal-set IK gives the same results, bit for bit, as
  when the kernels get contiguous targets and a budget tensor: through
  the plain versions (the CPU path), and through the kernel source
  compiled with g++ against ``csrc/cuda_emu.h`` on a slice of the
  build's own calls.
"""

import ctypes
import os
import shutil
import subprocess

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from omg_planner_torch.config import OMGConfig
from omg_planner_torch.models import api
from omg_planner_torch.ops import ik as tik
from omg_planner_torch.ops import kernels
from omg_planner_torch.planner import goal_set as tgs
from omg_planner_torch.planner.scene import PlanningScene

torch.set_num_threads(2)

CFG = OMGConfig(silent=True)
SCENE_1 = os.path.join(os.path.dirname(__file__), "..", "data", "suite_v2",
                       "scene_1.npz")


class _Ops(TorchDispatchMode):
    """The operators called under it, outermost only."""

    def __init__(self):
        super().__init__()
        self.calls = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls.append((func, args))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def build():
    """Suite scene 1's goal-set IK inputs, as ``build_goal_set`` gives
    them to ``ops/ik.py::solve_goal_set``, and the IK calls it makes."""
    sc = PlanningScene.from_npz(CFG, SCENE_1, device="cpu")
    model = sc.model
    lo, hi = model.soft_limits(CFG.soft_joint_limit_padding)
    grasps = torch.as_tensor(sc.env.grasp_poses_world(),
                             dtype=torch.float32)
    seeds = torch.cat([torch.as_tensor(sc.start[None, :7]), torch.as_tensor(
        tgs.ANCHOR_SEEDS[:CFG.ik_seed_num, :7])]).float()
    calls = []

    class Recorder:
        def __getattr__(self, name):
            return getattr(kernels, name)

        def ik_prefilter(self, *args):
            calls.append(("ik_prefilter", args))
            return kernels.ik_prefilter(*args)

        def ik_chain(self, *args):
            calls.append(("ik_chain", args))
            return kernels.ik_chain(*args)

    tik.kernels = Recorder()
    try:
        out = tik.solve_goal_set(model, CFG, grasps, seeds, lo[:7], hi[:7])
    finally:
        tik.kernels = kernels
    return dict(model=model, lo=lo[:7], hi=hi[:7], grasps=grasps,
                seeds=seeds, out=out, calls=dict(calls),
                tables=api.kernel_tables(model).fk)


def test_prefilter_reads_the_standoff_view_in_place(build):
    st = build
    tgt = st["calls"]["ik_prefilter"][0]
    assert not tgt.is_contiguous()
    keep, _, ptrs, dims = kernels._ik_prefilter_pack(
        tgt, st["calls"]["ik_prefilter"][1], st["tables"], st["lo"],
        st["hi"], CFG.ik_prefilter_iters)
    assert keep[0].data_ptr() == tgt.data_ptr() == ptrs[0]
    assert list(dims) == [tgt.shape[0], CFG.ik_prefilter_iters,
                          16 * (CFG.reach_tail_length)]


def test_prefilter_wave_view_and_other_layouts(build):
    st = build
    n = 6
    chain = torch.randn(2, n, 5, 4, 4)
    seeds = torch.zeros(2 * n, 7)
    rest = (st["tables"], st["lo"], st["hi"], 3)
    # a wave's far standoffs, flattened over its scenes: one stride
    wave = chain[:, :, -1].reshape(-1, 4, 4)
    keep, _, _, dims = kernels._ik_prefilter_pack(wave, seeds, *rest)
    assert keep[0].data_ptr() == wave.data_ptr() and dims[2] == 80
    # the same targets broadcast to every lane: stride 0, read in place
    one = chain[0, 0, -1].expand(2 * n, 4, 4)
    keep, _, _, dims = kernels._ik_prefilter_pack(one, seeds, *rest)
    assert keep[0].data_ptr() == one.data_ptr() and dims[2] == 0
    # lanes at two strides (a stage of a [2, n] batch whose scenes lie
    # apart) and a transposed pose: copied once, contiguous
    for odd in (torch.randn(2, n + 1, 4, 4)[:, :n].reshape(2, n, 4, 4),
                chain[:, :, -1].transpose(-1, -2)):
        keep, _, _, dims = kernels._ik_prefilter_pack(
            odd, seeds.reshape(2, n, 7), *rest)
        assert keep[0].is_contiguous() and dims[2] == 16
        assert torch.equal(keep[0], odd.reshape(-1, 4, 4))


def _chain_ops(st, scene_budgets):
    b = st["calls"]["ik_chain"][0].shape[0]
    args = [st["calls"]["ik_chain"][i] for i in (0, 1)]
    active = st["calls"]["ik_chain"][2]
    cfg = tik._chain_cfg(CFG)
    tik._solve_chain_fused(st["model"], cfg, *args, st["lo"], st["hi"],
                           active, scene_budgets)   # warm the caches
    with _Ops() as ops:
        out = tik._solve_chain_fused(st["model"], cfg, *args, st["lo"],
                                     st["hi"], active, scene_budgets)
    assert b % 2 == 0
    return ops.calls, out


def test_single_scene_chain_makes_no_budget_tensor(build):
    st = build
    budget = tik._chain_cfg(CFG).ik_chain_total_budget
    for scene_budgets in (None, [budget, budget]):
        calls, _ = _chain_ops(st, scene_budgets)
        assert [f for f, _ in calls] == [torch.ops.omg_torch.ik_chain.default]
        args = calls[0][1]
        assert args[3] is None and args[-1] == budget
    # two different budgets: a per-lane tensor, the scene batch's
    calls, _ = _chain_ops(st, [budget, 0])
    assert calls[-1][0] == torch.ops.omg_torch.ik_chain.default
    assert torch.is_tensor(calls[-1][1][3]) and calls[-1][1][-1] == 0


def test_build_equals_contiguous_targets_and_budget_tensor(build):
    """The plain path: suite scene 1's goal-set IK with the kernels' inputs
    laid out as before (contiguous targets, a budget tensor)."""
    st = build

    class OldLayout:
        def __getattr__(self, name):
            return getattr(kernels, name)

        def ik_prefilter(self, targets, *rest):
            return kernels.ik_prefilter(targets.contiguous(), *rest)

        def ik_chain(self, tgts, seeds, active, budgets, *rest):
            budgets = torch.full(seeds.shape[:-1], budgets,
                                 dtype=torch.int32)
            return kernels.ik_chain(tgts, seeds, active, budgets, *rest)

    tik.kernels = OldLayout()
    try:
        old = tik.solve_goal_set(st["model"], CFG, st["grasps"], st["seeds"],
                                 st["lo"], st["hi"])
    finally:
        tik.kernels = kernels
    assert all(torch.equal(a, b) for a, b in zip(st["out"], old))
    assert 20 < int(st["out"][2].sum()) < 256


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    out = os.path.join(str(tmp_path_factory.mktemp("ik_layout_emu")),
                       "libik_newton_emu.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-DOMG_CUDA_EMU", "-x", "c++",
                    os.path.join(kernels.CSRC, "ik_newton.cu"), "-o", out],
                   check=True, capture_output=True)
    dll = ctypes.CDLL(out)
    fns = {}
    for name, argtypes in kernels._LIBS["ik_newton"][2].items():
        fn = getattr(dll, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        fns[name] = fn
    return fns


def _emu(lib, kind, pa):
    if kind == "ik_prefilter":
        *lanes, damping, iters = pa
        keep, outs, ptrs, dims = kernels._ik_prefilter_pack(*lanes, iters)
        assert lib["omg_ik_prefilter"](ptrs, dims, damping, None) == 0
    else:
        *lanes, damping, pos_tol, rot_tol, max_iters, window = pa
        keep, outs, ptrs, dims = kernels._ik_chain_pack(*lanes, max_iters,
                                                        window)
        assert lib["omg_ik_chain"](ptrs, dims, damping, pos_tol,
                                   pos_tol * 10, rot_tol * 10, None) == 0
    del keep
    return outs


def test_kernel_source_reads_both_layouts_alike(lib, build):
    """The kernel source on 48 of the build's own prefilter lanes (the
    strided view) and 24 of its chain lanes (the int budget), against the
    same lanes laid out as before: bit for bit."""
    st = build
    tgt, seeds = st["calls"]["ik_prefilter"][:2]
    rows = slice(100, 148)
    view = tgt[rows]
    assert view.stride(0) == 80
    pa = [view, seeds[rows], st["tables"], st["lo"], st["hi"],
          CFG.ik_damping, CFG.ik_prefilter_iters]
    a = _emu(lib, "ik_prefilter", pa)
    b = _emu(lib, "ik_prefilter", [view.contiguous()] + pa[1:])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    c = st["calls"]["ik_chain"]
    assert isinstance(c[3], int)
    rows = slice(0, 24)
    pa = [c[0][rows], c[1][rows], c[2][rows], c[3], st["tables"],
          st["lo"], st["hi"]] + list(c[7:])
    a = _emu(lib, "ik_chain", pa)
    b = _emu(lib, "ik_chain", pa[:3] + [torch.full((24,), c[3],
                                                   dtype=torch.int32)]
             + pa[4:])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert bool(a[1].any())
