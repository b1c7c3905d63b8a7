"""The goal-set build's IK kernels' own source (``omg_planner_torch/csrc/
ik_newton.cu``) compiled with g++ against ``csrc/cuda_emu.h`` and run on
the CPU, against their plain versions (``ops/kernels.py::
ik_prefilter_plain``, ``ik_chain_plain``) on the same inputs.

The emulation runs one fiber per CUDA thread (as
``tests/test_torch_rollout_emu.py`` says), so it executes the kernels'
indexing, ragged blocks and per-lane loops as written.  Arguments are
packed by the wrappers' own packers (``_ik_prefilter_pack``,
``_ik_chain_pack``) from CPU tensors.

Inputs, from seeds and from suite scene 1 (its 48 grasps x 13 seeds, the
build's 624 prefilter lanes, then its 256 survivors, as
``ops/ik.py::solve_goal_set`` ranks them):

* the prefilter at B = 1, 37 and 256 on near-solution lanes (targets at a
  seeded q within the limits, seeds 0.05 rad from it), and on the suite
  scene's 624 lanes;
* the chain at B = 1, 37 and 256 of the suite scene's survivors, with a
  third of the lanes not active and budgets that mix 26, 0 (none) and 9;
* every fifth row alone against its row of the launch.

Bars.  The kernel takes cosf, sinf and acosf from the host's libm here
(libdevice's on the card) where the plain version takes torch's, so
results part by an ulp of a joint's cosine and the iterations carry it:

* the prefilter within 1e-6 of its plain version on the near-solution
  lanes (q and the twist norm), where the damped Newton step contracts;
* on the suite scene's lanes its 12 steps from far seeds are chaotic on
  about 1% of the lanes (the redundant arm's null space, and ``so3_log``
  near pi where one ulp of the angle moves the twist by 1e-3): the
  float32 plain version itself stands up to 2.6e-2 from the float64 one,
  and which lanes stand farthest changes with every ulp, so no lane-wise
  or largest-distance bar holds.  There, at each of 1e-6, 1e-5, 1e-4,
  1e-3 and 1e-2, the kernel has at most 2 x + 3 as many lanes (q, and the
  twist norm) beyond it from the float64 plain version as the float32
  plain version has (``chip_smoke.py`` phase 3d's bar), and the flags
  that the build takes from the prefilter (twist norm under
  ``ik_prefilter_tol``) equal the plain version's;
* the chain: ``ok`` equal on every lane, and ``qs`` within 1e-4 rad of the
  plain version on the lanes ok in both (the stages end at a twist norm of
  1e-4, and the arm's null space keeps an ulp's difference; measured at
  most 6.4e-6 on suite scenes 0-2's builds);
* rows alone: bit for bit.

Where a lane's flag or ``ok`` differs, the test prints the lane's margin:
its float64 twist norm's distance to the threshold, or the chain's
acceptance ratios at its recorded stages (1 is the threshold)."""

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
SCENE_1 = os.path.join(os.path.dirname(__file__), "..", "data", "suite_v2",
                       "scene_1.npz")
CHAIN_CFG = tik._chain_cfg(CFG)
QS_BAR = 1e-4
DIST_STEPS = (1e-6, 1e-5, 1e-4, 1e-3, 1e-2)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    out = os.path.join(str(tmp_path_factory.mktemp("ik_kernels_emu")),
                       "libik_newton_emu.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
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
    """Suite scene 1's model, limits, prefilter lanes and survivors."""
    sc = PlanningScene.from_npz(CFG, SCENE_1,
                                device="cpu")
    model = sc.model
    lo, hi = model.soft_limits(CFG.soft_joint_limit_padding)
    grasps = torch.as_tensor(sc.env.grasp_poses_world(),
                             dtype=torch.float32)
    seeds = torch.cat([torch.as_tensor(sc.start[None, :7]), torch.as_tensor(
        tgs.ANCHOR_SEEDS[:CFG.ik_seed_num, :7])]).float()
    n, s = grasps.shape[0], seeds.shape[0]
    tgt = torch.repeat_interleave(tik._standoff_targets(CFG, grasps), s, 0)
    seeds_b = seeds.repeat(n, 1)
    pqr = panda.pqr_table(model.pose_0, model.chain_post)
    q_pre, err_pre = kernels.ik_prefilter_plain(
        tgt[:, -1], seeds_b, pqr, model.pose_0, lo[:7], hi[:7],
        CFG.ik_damping, CFG.ik_prefilter_iters)
    keep = top_k(-err_pre, CFG.ik_survivor_cap)[1]
    chain = torch.cat([tgt[:, -1:], tgt], 1)[keep]
    return dict(model=model, pqr=pqr, tables=api.kernel_tables(model).fk,
                lo=lo[:7], hi=hi[:7],
                pre_tgt=tgt[:, -1], seeds=seeds_b, chain_tgts=chain,
                chain_seeds=q_pre[keep],
                active=(err_pre < CFG.ik_prefilter_tol)[keep])


def _prefilter(lib, st, tgts, seeds, iters=CFG.ik_prefilter_iters):
    keep, outs, ptrs, dims = kernels._ik_prefilter_pack(
        tgts, seeds, st["tables"], st["lo"], st["hi"], iters)
    assert lib["omg_ik_prefilter"](ptrs, dims, CFG.ik_damping, None) == 0
    del keep
    return outs


def _prefilter_plain(st, tgts, seeds, dtype=torch.float32):
    args = [t.to(dtype) for t in (tgts, seeds, st["pqr"], st["model"].pose_0,
                                  st["lo"], st["hi"])]
    return kernels.ik_prefilter_plain(*args, CFG.ik_damping,
                                      CFG.ik_prefilter_iters)


def _chain_args(st, rows, budgets):
    return (st["chain_tgts"][rows], st["chain_seeds"][rows],
            st["active"][rows], budgets, st["tables"], st["lo"], st["hi"])


def _chain(lib, args):
    keep, outs, ptrs, dims = kernels._ik_chain_pack(
        *args, CHAIN_CFG.ik_max_iters, CFG.ik_stall_window)
    tol = CFG.ik_pos_tol
    assert lib["omg_ik_chain"](ptrs, dims, CFG.ik_damping, tol, tol * 10,
                               CFG.ik_rot_tol * 10, None) == 0
    del keep
    return outs


def _chain_plain(args):
    return kernels.ik_chain_plain(
        *args[:4], *kernels.fk_table_parts(args[4])[:2], *args[5:],
        CFG.ik_damping, CFG.ik_pos_tol, CFG.ik_rot_tol,
        CHAIN_CFG.ik_max_iters, CFG.ik_stall_window)


def _near_solutions(st, n, seed):
    rng = np.random.default_rng(seed)
    lo, hi = st["lo"], st["hi"]
    q_true = lo + (hi - lo) * torch.as_tensor(rng.uniform(0.3, 0.7, (n, 7)),
                                              dtype=torch.float32)
    tgts = panda.hand_pose_batch(st["model"], torch.cat(
        [q_true, torch.full((n, 2), 0.04)], 1))
    return tgts, q_true + torch.as_tensor(rng.normal(0, 0.05, (n, 7)),
                                          dtype=torch.float32)


@pytest.mark.parametrize("b", [1, 37, 256])
def test_prefilter_near_solutions(lib, scene, b):
    tgts, seeds = _near_solutions(scene, b, seed=b)
    q, err = _prefilter(lib, scene, tgts, seeds)
    qp, ep = _prefilter_plain(scene, tgts, seeds)
    assert float((q - qp).abs().max()) <= 1e-6
    assert float((err - ep).abs().max()) <= 1e-6
    assert float(ep.max()) < 1e-4        # the lanes converged
    for i in range(0, b, 5):
        q1, e1 = _prefilter(lib, scene, tgts[i:i + 1], seeds[i:i + 1])
        assert torch.equal(q1[0], q[i]) and torch.equal(e1[0], err[i])


def test_prefilter_suite_scene(lib, scene):
    st = scene
    tgts, seeds = st["pre_tgt"], st["seeds"]
    q, err = _prefilter(lib, st, tgts, seeds)
    qp, ep = _prefilter_plain(st, tgts, seeds)
    q64, e64 = _prefilter_plain(st, tgts, seeds, torch.float64)
    for name, mine, own in (
            ("q", (q.double() - q64).abs().amax(1),
             (qp.double() - q64).abs().amax(1)),
            ("twist norm", (err.double() - e64).abs(),
             (ep.double() - e64).abs())):
        m_n, o_n = ([int((d > x).sum()) for x in DIST_STEPS]
                    for d in (mine, own))
        print(f"{name}: lanes beyond {DIST_STEPS} from float64: kernel "
              f"{m_n}, plain {o_n}; largest {float(mine.max()):.3e}, "
              f"{float(own.max()):.3e}")
        assert all(m <= 2 * o + 3 for m, o in zip(m_n, o_n)), name
    tol = CFG.ik_prefilter_tol
    flips = torch.nonzero((err < tol) != (ep < tol)).flatten().tolist()
    for i in flips:
        print(f"lane {i}: twist norm kernel {float(err[i]):.6g}, plain "
              f"{float(ep[i]):.6g}, float64 {float(e64[i]):.6g}: margin "
              f"{float(e64[i]) - tol:.3g} to {tol}")
    assert not flips
    assert 100 < int((ep < tol).sum()) < 600


def _margins(st, rows, qs, lane):
    pos, rot = kernels.ik_acceptance(
        st["chain_tgts"][rows][lane:lane + 1], qs[lane:lane + 1], st["pqr"],
        st["model"].pose_0)
    return ((pos / (10 * CFG.ik_pos_tol)).numpy().round(4).tolist(),
            (rot / (10 * CFG.ik_rot_tol)).numpy().round(4).tolist())


@pytest.mark.parametrize("b", [1, 37, 256])
def test_chain_matches_plain(lib, scene, b):
    st = scene
    rows = slice(0, b) if b > 1 else slice(5, 6)
    active = st["active"].clone()
    active[1::3] = False
    st = dict(st, active=active)
    budgets = torch.tensor([26, 0, 9], dtype=torch.int32).repeat(b)[:b]
    args = _chain_args(st, rows, budgets)
    qs, ok = _chain(lib, args)
    qsp, okp = _chain_plain(args)
    for i in torch.nonzero(ok != okp).flatten().tolist():
        print(f"lane {i}: kernel ok {bool(ok[i])} {_margins(st, rows, qs, i)}"
              f", plain ok {bool(okp[i])} {_margins(st, rows, qsp, i)}")
    assert torch.equal(ok, okp)
    both = ok & okp
    gap = float((qs - qsp).abs().amax((1, 2))[both].max()) if bool(
        both.any()) else 0.0
    print(f"B = {b}: {int(ok.sum())} lanes ok, qs at most {gap:.3e} from the "
          "plain version")
    assert gap <= QS_BAR
    assert not bool(ok[~args[2]].any()) and bool((qs[~args[2]] == 0).all())
    if b == 256:     # every kind of lane occurs: ok, failed, cut by 9
        assert 20 < int(ok.sum()) < 200
        assert not bool(ok[budgets == 9].any())
    for i in range(0, b, 5):
        one = _chain(lib, tuple(a[i:i + 1] for a in args[:4]) + args[4:])
        assert torch.equal(one[0][0], qs[i]) and torch.equal(one[1][0], ok[i])


def test_chain_budget_none_against_cap(lib, scene):
    """The survivors with no budget run every stage to its end; with the
    build's 26 some lanes are cut: the kernel stops each where the plain
    version does."""
    st = scene
    rows = slice(0, 256)
    res = {}
    for cap in (0, 26):
        budgets = torch.full((256,), cap, dtype=torch.int32)
        args = _chain_args(st, rows, budgets)
        res[cap] = _chain(lib, args)
        want = _chain_plain(args)
        assert torch.equal(res[cap][1], want[1])
    assert bool((res[0][1] | ~res[26][1]).all())
    assert int(res[26][1].sum()) <= int(res[0][1].sum())
