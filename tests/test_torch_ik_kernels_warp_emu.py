"""The IK kernels' warp layout (``omg_planner_torch/csrc/ik_newton.cu``: one
warp a lane, four lanes a block), run from the kernel's own source compiled
with g++ against ``csrc/cuda_emu.h`` on the CPU.

The emulator runs every CUDA thread as a fiber and every ``__syncwarp``
and ``__syncthreads`` as a barrier, and aborts on a barrier that some
thread of its warp or block never reaches, so a lane whose warp leaves
the loop early, or a warp past the last lane that returns before the
block's barrier, fails here instead of hanging on the card.  Cases:

* ragged last blocks: the prefilter and the chain at B = 5 and 37 (one
  lane in the last block of four);
* blocks whose lanes part ways: in each block of the chain one lane has
  no budget, one is not active, one is cut by a budget of 3 and one has
  the build's budget, and a lane that fails a stage ends early; the
  lanes' counts of evaluations differ within a block;
* a chain of one stage (no tail to record) and a prefilter of no step;
* every row alone, and the lanes in reverse order, against the launch:
  bit for bit.

Each launch is also held to the plain version (``ops/kernels.py::
ik_prefilter_plain``, ``ik_chain_plain``).  The prefilter on
near-solution lanes: q and the twist norm no farther from the float64
plain version than max(1e-6, 2 x the float32 plain version's own
distance), lane by lane (the kernel takes cosf and sinf from the host's
libm here, so the two float32 results stand on either side of float64
and apart by up to 1.7e-6 on these lanes).  The chain, with
``tests/test_torch_ik_kernels_emu.py``'s bars: ``ok`` equal and ``qs``
within 1e-4 rad.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from omg_planner_torch.config import OMGConfig
from omg_planner_torch.models import api, panda
from omg_planner_torch.ops import ik as tik
from omg_planner_torch.ops import kernels
from omg_planner_torch.planner import goal_set as tgs
from omg_planner_torch.planner.scene import PlanningScene
from omg_planner_torch.utils.linalg import top_k

torch.set_num_threads(2)

CFG = OMGConfig(silent=True)
CHAIN_CFG = tik._chain_cfg(CFG)
SCENE_1 = os.path.join(os.path.dirname(__file__), "..", "data", "suite_v2",
                       "scene_1.npz")
LANES_A_BLOCK = 4


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    out = os.path.join(str(tmp_path_factory.mktemp("ik_warp_emu")),
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


@pytest.fixture(scope="module")
def scene():
    """Suite scene 1's model, limits and its first 48 chain survivors (the
    build's ranking of its prefilter lanes)."""
    sc = PlanningScene.from_npz(CFG, SCENE_1, device="cpu")
    model = sc.model
    lo, hi = model.soft_limits(CFG.soft_joint_limit_padding)
    grasps = torch.as_tensor(sc.env.grasp_poses_world(),
                             dtype=torch.float32)
    seeds = torch.cat([torch.as_tensor(sc.start[None, :7]), torch.as_tensor(
        tgs.ANCHOR_SEEDS[:CFG.ik_seed_num, :7])]).float()
    s = seeds.shape[0]
    tgt = torch.repeat_interleave(tik._standoff_targets(CFG, grasps), s, 0)
    pqr = panda.pqr_table(model.pose_0, model.chain_post)
    q_pre, err_pre = kernels.ik_prefilter_plain(
        tgt[:, -1], seeds.repeat(grasps.shape[0], 1), pqr, model.pose_0,
        lo[:7], hi[:7], CFG.ik_damping, CFG.ik_prefilter_iters)
    keep = top_k(-err_pre, CFG.ik_survivor_cap)[1][:48]
    return dict(model=model, pqr=pqr, tables=api.kernel_tables(model).fk,
                lo=lo[:7], hi=hi[:7],
                chain_tgts=torch.cat([tgt[:, -1:], tgt], 1)[keep],
                chain_seeds=q_pre[keep])


def _prefilter(lib, st, tgts, seeds, iters):
    keep, outs, ptrs, dims = kernels._ik_prefilter_pack(
        tgts, seeds, st["tables"], st["lo"], st["hi"], iters)
    assert lib["omg_ik_prefilter"](ptrs, dims, CFG.ik_damping, None) == 0
    del keep
    return outs


def _chain(lib, st, tgts, seeds, active, budgets):
    keep, outs, ptrs, dims = kernels._ik_chain_pack(
        tgts, seeds, active, budgets, st["tables"], st["lo"], st["hi"],
        CHAIN_CFG.ik_max_iters, CFG.ik_stall_window)
    tol = CFG.ik_pos_tol
    assert lib["omg_ik_chain"](ptrs, dims, CFG.ik_damping, tol, tol * 10,
                               CFG.ik_rot_tol * 10, None) == 0
    del keep
    return outs


def _chain_plain(st, tgts, seeds, active, budgets, passes=False):
    return kernels.ik_chain_plain(
        tgts, seeds, active, budgets, st["pqr"], st["model"].pose_0,
        st["lo"], st["hi"], CFG.ik_damping, CFG.ik_pos_tol, CFG.ik_rot_tol,
        CHAIN_CFG.ik_max_iters, CFG.ik_stall_window, passes=passes)


def _near_solutions(st, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = st["lo"], st["hi"]
    q_true = lo + (hi - lo) * torch.as_tensor(rng.uniform(0.3, 0.7, (n, 7)),
                                              dtype=torch.float32)
    tgts = panda.hand_pose_batch(st["model"], torch.cat(
        [q_true, torch.full((n, 2), 0.04)], 1))
    return tgts, q_true + torch.as_tensor(rng.normal(0, 0.05, (n, 7)),
                                          dtype=torch.float32)


def _rows_alone_and_reversed(run, lane_args, out):
    """Every row of the launch alone, and the launch in reverse lane
    order, bit for bit."""
    b = lane_args[0].shape[0]
    for i in range(b):
        one = run(*[a[i:i + 1] if torch.is_tensor(a) else a
                    for a in lane_args])
        assert all(torch.equal(x[0], y[i]) for x, y in zip(one, out)), i
    rev = run(*[a.flip(0) if torch.is_tensor(a) else a for a in lane_args])
    assert all(torch.equal(x.flip(0), y) for x, y in zip(rev, out))


@pytest.mark.parametrize("b", [5, 37])
def test_prefilter_ragged_last_block(lib, scene, b):
    assert b % LANES_A_BLOCK == 1
    tgts, seeds = _near_solutions(scene, b, seed=100 + b)
    q, err = _prefilter(lib, scene, tgts, seeds, CFG.ik_prefilter_iters)
    args = [tgts, seeds, scene["pqr"], scene["model"].pose_0, scene["lo"],
            scene["hi"]]
    qp, ep = kernels.ik_prefilter_plain(*args, CFG.ik_damping,
                                        CFG.ik_prefilter_iters)
    q64, e64 = kernels.ik_prefilter_plain(*[a.double() for a in args],
                                          CFG.ik_damping,
                                          CFG.ik_prefilter_iters)
    for mine, own in (((q.double() - q64).abs().amax(1),
                       (qp.double() - q64).abs().amax(1)),
                      ((err.double() - e64).abs(),
                       (ep.double() - e64).abs())):
        assert bool((mine <= torch.clamp(2 * own, min=1e-6)).all())
    assert float(ep.max()) < 1e-4        # the lanes converged
    _rows_alone_and_reversed(
        lambda t, s: _prefilter(lib, scene, t, s, CFG.ik_prefilter_iters),
        [tgts, seeds], (q, err))


def test_prefilter_no_step(lib, scene):
    """iters = 0: the twist error at the seeds, q the seeds."""
    tgts, seeds = _near_solutions(scene, 6, seed=7)
    q, err = _prefilter(lib, scene, tgts, seeds, 0)
    _, ep = kernels.ik_prefilter_plain(
        tgts, seeds, scene["pqr"], scene["model"].pose_0, scene["lo"],
        scene["hi"], CFG.ik_damping, 0)
    assert torch.equal(q, seeds)
    assert float((err - ep).abs().max()) <= 1e-6


def _mixed_lanes(st, b):
    """b survivors in blocks of four whose lanes part ways: no budget, not
    active, a budget of 3, the chain's own budget."""
    active = torch.ones(b, dtype=torch.bool)
    active[1::LANES_A_BLOCK] = False
    budgets = torch.tensor(
        [0, 0, 3, CFG.ik_chain_total_budget], dtype=torch.int32
    ).repeat(b)[:b]
    return (st["chain_tgts"][:b], st["chain_seeds"][:b], active, budgets)


@pytest.mark.parametrize("b", [5, 37])
def test_chain_lanes_part_ways_within_a_block(lib, scene, b):
    args = _mixed_lanes(scene, b)
    qs, ok = _chain(lib, scene, *args)
    qsp, okp, evals, _ = _chain_plain(scene, *args, passes=True)
    assert torch.equal(ok, okp)
    both = ok & okp
    assert float((qs - qsp).abs().amax((1, 2))[both].max()) <= 1e-4
    active, budgets = args[2], args[3]
    assert not bool(ok[~active].any()) and bool((qs[~active] == 0).all())
    assert not bool(ok[budgets == 3].any())
    assert bool(ok.any())
    # the lanes of a block run different counts of evaluations
    block = evals[:LANES_A_BLOCK]
    assert len(set(block.tolist())) >= 3
    _rows_alone_and_reversed(
        lambda *a: _chain(lib, scene, *a), list(args), (qs, ok))


def test_chain_one_budget_for_every_lane(lib, scene):
    """The budget as an int: the same bits as the tensor of it."""
    b = 9
    tgts, seeds, active, _ = _mixed_lanes(scene, b)
    for budget in (0, 5, CFG.ik_chain_total_budget):
        a = _chain(lib, scene, tgts, seeds, active, budget)
        t = _chain(lib, scene, tgts, seeds, active,
                   torch.full((b,), budget, dtype=torch.int32))
        assert all(torch.equal(x, y) for x, y in zip(a, t))
        assert torch.equal(a[1], _chain_plain(scene, tgts, seeds, active,
                                              budget)[1])


def test_chain_of_one_stage(lib, scene):
    """K = 1, the far standoff alone: no tail to record, ok as graded."""
    b = 6
    tgts = scene["chain_tgts"][:b, :1]
    seeds = scene["chain_seeds"][:b]
    active = torch.ones(b, dtype=torch.bool)
    active[2] = False
    qs, ok = _chain(lib, scene, tgts, seeds, active, 0)
    qsp, okp = _chain_plain(scene, tgts, seeds, active, 0)
    assert qs.shape == (b, 0, 7) and torch.equal(ok, okp)
    assert bool(ok.any()) and not bool(ok[2])
