"""The CHOMP step's kernels' own source (``omg_planner_torch/csrc/
chomp_cost.cu``: ``chomp_obstacle`` and ``chomp_step``) compiled with g++
against ``csrc/cuda_emu.h`` and run on the CPU, against their plain
versions (``ops/kernels.py::chomp_obstacle_plain``,
``chomp_step_plain``) on the same inputs.

The emulation runs one fiber per CUDA thread (as
``tests/test_torch_rollout_emu.py`` says), so it executes each kernel's
indexing, radix select, warp reductions and barriers as written.
Arguments are packed by the wrappers' own packers
(``_chomp_obstacle_pack`` with the selection outputs, ``_chomp_step_pack``)
from CPU tensors.  Inputs: three seeded trajectories of ``data/suite_v2``
scene 1 at full width (T = 30, 4,500 points), their FK and analytic query
on the CPU; the query's potentials replaced by seeded ties at the k-th
value (values of {0.5, 0.25, 0.0, -0.0}) and by NaN; the UR-like chain's
tables (6 dofs, no fingers); horizons of T = 5 and 40 (fewer warps than
32, and more timesteps than warps).  ``chomp_obstacle`` runs with the
default flags, ``ref_topk_quirks``, ``consider_finger``, the finger
softening, k = 0 and k >= T L P; ``chomp_step`` with and without the
goal-set projection, ``consider_finger``, ``pre_terminate`` off, the
weights as arguments (0-d) and a row each, trajectories past the joint
limits.

Bars: the k-th value and the selection mask bit for bit the plain
version's; obs_cost, obs_grad and the step's trajectory, each of its
packed fields and its ``cost_traj`` no farther
from the plain version in float64 than max(1e-5 of that output's largest
entry, 2 x the float32 plain version's own distance) (the kernels sum in
another order than torch); the collision counts equal; the step's flags
the plain version's; each row of a launch of three bit for bit its launch
alone."""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from omg_planner_torch.config import OMGConfig, schedule_weights
from omg_planner_torch.models import api as model_api
from omg_planner_torch.models import chain
from omg_planner_torch.ops import chomp, kernels
from omg_planner_torch.planner.scene import PlanningScene
from test_torch_chain import _ur_points, ur_urdf

torch.set_num_threads(2)

CFG = OMGConfig(silent=True)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the kernel source for the CPU")
    path = os.path.join(str(tmp_path_factory.mktemp("chomp_emu")),
                        "libchomp_cost_emu.so")
    subprocess.run([gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-DOMG_CUDA_EMU", "-x", "c++",
                    os.path.join(kernels.CSRC, "chomp_cost.cu"), "-o", path],
                   check=True, capture_output=True)
    so = ctypes.CDLL(path)
    fns = {}
    for name in ("omg_chomp_obstacle", "omg_chomp_step"):
        fn = getattr(so, name)
        fn.argtypes = kernels._LIBS["chomp_cost"][2][name]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@pytest.fixture(scope="module")
def suite():
    """Suite scene 1's model, scene and collision parameters on the CPU,
    and the query inputs of three seeded trajectories (stacked)."""
    sc = PlanningScene.from_npz(CFG, "data/suite_v2/scene_1.npz",
                                device="cpu")
    model, scene, params = sc.model, sc.env.scene_sdf(), sc.env.cost_params()
    start = torch.as_tensor(np.asarray(sc.start, np.float32))
    end = torch.as_tensor(np.asarray(sc.end, np.float32))
    rng = np.random.default_rng(31)
    base = np.linspace(start.numpy(), end.numpy(), 30)
    rows = []
    for _ in range(3):
        xi = base + rng.normal(scale=0.1, size=base.shape)
        xi[:, 7:] = 0.04
        xi = torch.as_tensor(xi.astype(np.float32))
        x, og, ax, pot, grad, col = chomp._fk_query(model, scene, params, xi,
                                                    None)
        xs, xe = model_api.end_points(model, start, end)
        rows.append((x, og, ax, xs, xe, pot, grad, col))
    return dict(model=model, start=start, end=end, lower=model.joint_lower,
                upper=model.joint_upper,
                rows=[torch.stack(a) for a in zip(*rows)])


def _f64(args):
    return [a.double() if torch.is_tensor(a) and a.is_floating_point()
            else a for a in args]


OBSTACLE_OUTPUTS = ("obs_cost", "obs_grad", "collide")
STEP_OUTPUTS = ("xi",) + kernels.INFO_SCALARS + ("cost_traj",)


def step_outputs(out):
    """``chomp_step``'s trajectory and its packed floats split into their
    fields (:data:`STEP_OUTPUTS`)."""
    n = len(kernels.INFO_SCALARS)
    return [out[0], *out[1][..., :n].unbind(-1), out[1][..., n:]]


def near_f64(got, f32, f64, names, what):
    """Each output (one of ``names``) no farther from float64 than max(1e-5
    of its own size, 2 x the float32 plain version's distance), and NaN
    where float64 is; a collision count equal to the plain version's."""
    for name, g, p, q in zip(names, got, f32, f64):
        if name == "collide":
            assert torch.equal(g, p), (what, name, g, p)
            continue
        g, p, q = g.double(), p.double(), q.double()
        nan = torch.isnan(q)
        assert torch.equal(torch.isnan(g), nan), (what, name)
        g, p, q = g[~nan], p[~nan], q[~nan]
        mine = float((g - q).abs().max()) if q.numel() else 0.0
        own = float((p - q).abs().max()) if q.numel() else 0.0
        size = float(q.abs().max()) if q.numel() else 0.0
        assert mine <= max(1e-5 * size, 2 * own), (what, name, mine, own,
                                                   size)


def same_bits(a, b) -> bool:
    """a and b bit for bit (NaN included)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def obstacle(fn, args):
    """The emulated ``chomp_obstacle``: (obs_cost, obs_grad, collide, kth,
    mask)."""
    keep, outs, ptrs, dims, consts = kernels._chomp_obstacle_pack(
        *args, selection=True)
    assert fn(ptrs, dims, consts, None) == 0
    del keep
    return outs


def check_obstacle(fn, args):
    """The emulated kernel against the plain version, and its rows against
    their launches alone."""
    got = obstacle(fn, args)
    plain = kernels.chomp_obstacle_plain(*args)
    near_f64(got[:3], plain, kernels.chomp_obstacle_plain(*_f64(args)),
             OBSTACLE_OUTPUTS, "chomp_obstacle")
    rows, (dmats, tables, dt, k, finger, soften, _) = args[:8], args[8:]
    for r in range(rows[0].shape[0]):
        one = [a[r] for a in rows]
        pot = kernels.obstacle_point_terms(*one, dmats, tables, dt,
                                           soften)[3]
        kth, sel = kernels.obstacle_selection(pot, tables, k, finger)
        if kth is None or torch.isnan(kth):
            assert torch.isnan(got[3][r])
        else:
            assert torch.equal(got[3][r], kth)
        assert torch.equal(got[4][r], sel)
        alone = obstacle(fn, [a[r:r + 1] for a in rows] + list(args[8:]))
        for a, b in zip(alone, got):
            assert same_bits(a[0], b[r])
    return got


def _obstacle_args(suite, rows=None, **flags):
    hp = CFG.horizon().on("cpu")
    spec = dict(k=CFG.top_k_collision, finger=False, soften=False,
                quirks=False)
    spec.update(flags)
    return list(rows or suite["rows"]) + [
        hp.diff_matrices, model_api.jacobian_tables(suite["model"]),
        hp.time_interval, spec["k"], spec["finger"], spec["soften"],
        spec["quirks"]]


def _ties(pot, kind, seed=5):
    """``pot``'s shape filled with seeded values of {0.5, 0.25, 0.0,
    -0.0}: the 1,000th largest of each row a 0.25 among ties
    (``"quarter"``) or a zero among +0.0 and -0.0 (``"zero"``); or NaN
    at a few points (``"nan"``)."""
    rng = np.random.default_rng(seed)
    out = np.zeros(pot.shape, np.float32)
    for r in range(pot.shape[0]):
        flat = np.zeros(pot[r].numel(), np.float32)
        order = rng.permutation(flat.size)
        hi, quarter = (400, 1400) if kind == "quarter" else (300, 500)
        flat[order[:hi]] = 0.5
        flat[order[hi:quarter]] = 0.25
        neg = order[quarter:][rng.random(flat.size - quarter) < 0.5]
        flat[neg] = -0.0
        if kind == "nan":
            flat[order[:3 + r]] = np.nan
        out[r] = flat.reshape(pot.shape[1:])
    return torch.as_tensor(out)


@pytest.mark.parametrize("flags", [
    {}, dict(quirks=True), dict(finger=True), dict(soften=True),
    dict(soften=True, quirks=True, finger=True), dict(k=0),
    dict(k=4500), dict(k=4499), dict(k=1)])
def test_obstacle_suite_rows(lib, suite, flags):
    check_obstacle(lib["omg_chomp_obstacle"], _obstacle_args(suite, **flags))


@pytest.mark.parametrize("kind,flags", [
    ("quarter", {}), ("zero", {}), ("zero", dict(quirks=True, soften=True)),
    ("nan", {}), ("nan", dict(k=4500)), ("nan", dict(k=2))])
def test_obstacle_ties_signed_zeros_nan(lib, suite, kind, flags):
    rows = list(suite["rows"])
    rows[5] = _ties(rows[5], kind)
    got = check_obstacle(lib["omg_chomp_obstacle"],
                         _obstacle_args(suite, rows, **flags))
    if kind == "zero" and not flags:
        # the k-th is a zero: every zero of either sign off the fingers
        # is selected
        assert float(got[3][0]) == 0.0
        zeros = rows[5][0, :, :8] == 0
        assert bool(got[4][0, :, :8][zeros].all())
        assert bool((rows[5][0, :, :8][zeros].signbit()).any())


def test_obstacle_generic_chain(lib):
    model = chain.load_urdf_chain(ur_urdf(), "base_link", "tool0",
                                  collision_points_per_link=8, device="cpu")
    model = chain.with_collision_points(model, _ur_points(model.num_joints))
    rng = np.random.default_rng(9)
    xi = torch.as_tensor(rng.uniform(-1, 1, (3, 30, model.num_dof))
                         .astype(np.float32))
    rows = []
    for q in xi:
        _, og, ax, x = model_api.fk_points(model, q, joint_info=True)
        xs, xe = model_api.end_points(model, q[0] * 0, q[-1])
        n = x.shape[:3]
        pot = torch.as_tensor(np.clip(rng.normal(0, 0.2, n), 0, None)
                              .astype(np.float32))
        grad = torch.as_tensor(rng.normal(size=n + (3,)).astype(np.float32))
        rows.append((x, og, ax, xs, xe, pot, grad, (pot > 0.3).float()))
    hp = CFG.horizon().on("cpu")
    args = [torch.stack(a) for a in zip(*rows)] + [
        hp.diff_matrices, model_api.jacobian_tables(model), hp.time_interval,
        300, False, True, False]
    got = check_obstacle(lib["omg_chomp_obstacle"], args)
    assert got[1].shape == (3, 30, model.num_dof)


@pytest.mark.parametrize("t", [5, 40])
def test_obstacle_other_horizons(lib, suite, t):
    """T = 5 (5 warps) and T = 40 (32 warps, some two timesteps), the
    suite's points resampled along time."""
    idx = torch.linspace(0, 29, t).round().long()
    rows = list(suite["rows"])
    for i in (0, 1, 2, 5, 6, 7):
        rows[i] = rows[i][:, idx].contiguous()
    hp = CFG.horizon(t).on("cpu")
    args = rows + [hp.diff_matrices, model_api.jacobian_tables(
        suite["model"]), hp.time_interval, 150 * t // 4, False, False,
        False]
    check_obstacle(lib["omg_chomp_obstacle"], args)


def step(fn, args):
    keep, outs, ptrs, dims, consts = kernels._chomp_step_pack(*args)
    assert fn(ptrs, dims, consts, None) == 0
    del keep
    return outs


@pytest.mark.parametrize("spec", [
    dict(proj=True), dict(proj=False), dict(proj=True, finger=True),
    dict(proj=True, pre=False), dict(proj=True, row_weights=True),
    dict(proj=False, row_weights=True, finger=True)])
def test_step_rows(lib, suite, spec):
    fn = lib["omg_chomp_step"]
    hp = CFG.horizon().on("cpu")
    obs = kernels.chomp_obstacle_plain(*_obstacle_args(suite))
    rng = np.random.default_rng(17)
    lo, hi = suite["lower"], suite["upper"]
    xi = torch.minimum(torch.maximum(suite["rows"][0].new_tensor(np.linspace(
        suite["start"].numpy(), suite["end"].numpy(), 30)[None].repeat(3, 0)
        + rng.normal(scale=0.1, size=(3, 30, 9))), lo + 0.01), hi - 0.01)
    xi[0, 3, 1] = suite["upper"][1] + 0.2   # past both limits
    xi[0, 8, 2] = suite["lower"][2] - 0.2
    xi[1, 5, 0] = suite["upper"][0] + 0.2   # past one
    goal = suite["end"][None].repeat(3, 1) + torch.as_tensor(
        rng.normal(scale=0.01, size=(3, 9)).astype(np.float32))
    goal[2] = xi[2, -1] + 0.001           # within reach of the goal
    k = CFG.reach_tail_length if spec["proj"] else 1
    tail = goal[:, None].repeat(1, k, 1) + torch.as_tensor(
        rng.normal(scale=0.01, size=(3, k, 9)).astype(np.float32))
    w = schedule_weights(CFG, 5)
    weights = (w[0], w[1], w[3])
    if spec.get("row_weights"):
        weights = tuple(x * torch.tensor([1.0, 0.5, 2.0]) for x in weights)
    pmat, mmat = ((hp.proj[k][1], hp.proj[k][0]) if spec["proj"]
                  else (hp.Ainv, None))
    args = [xi, suite["start"].expand(3, 9), goal, tail, *obs, *weights,
            suite["lower"].expand(3, 9), suite["upper"].expand(3, 9),
            hp.diff_matrices[0], hp.A, pmat, mmat,
            model_api.dof_tables(suite["model"]), hp.time_interval,
            CFG.clip_grad_scale, float(CFG.allow_collision_point),
            CFG.terminate_smooth_loss, spec["proj"], spec.get("pre", True),
            spec.get("finger", False)]
    got = step(fn, args)
    plain = kernels.chomp_step_plain(*args)
    near_f64(step_outputs(got), step_outputs(plain),
             step_outputs(kernels.chomp_step_plain(*_f64(args))),
             STEP_OUTPUTS, "chomp_step")
    assert torch.equal(got[2], plain[2])
    assert got[2][:, 3].tolist() == [True, False, False]  # violate_limit
    for r in range(3):
        one = [a[r:r + 1] if torch.is_tensor(a) and i < 12 and a.ndim
               else a for i, a in enumerate(args)]
        for a, b in zip(step(fn, one), got):
            assert same_bits(a[0], b[r])


@pytest.mark.parametrize("t,proj", [(5, False), (40, True)])
def test_step_other_horizons(lib, suite, t, proj):
    """T = 5 (d1's and A's bands cut at both ends) and T = 40, on the
    obstacle terms of the suite's points resampled along time."""
    fn = lib["omg_chomp_step"]
    idx = torch.linspace(0, 29, t).round().long()
    rows = list(suite["rows"])
    for i in (0, 1, 2, 5, 6, 7):
        rows[i] = rows[i][:, idx].contiguous()
    hp = CFG.horizon(t).on("cpu")
    obs = kernels.chomp_obstacle_plain(
        *rows, hp.diff_matrices, model_api.jacobian_tables(suite["model"]),
        hp.time_interval, 150 * t // 4, False, False, False)
    rng = np.random.default_rng(23)
    xi = (torch.as_tensor(np.linspace(suite["start"].numpy(),
                                      suite["end"].numpy(), t))[None]
          + torch.as_tensor(rng.normal(scale=0.1, size=(3, t, 9)))).float()
    k = CFG.reach_tail_length if proj else 1
    goal = suite["end"][None].repeat(3, 1)
    tail = goal[:, None].repeat(1, k, 1) + torch.as_tensor(
        rng.normal(scale=0.01, size=(3, k, 9)).astype(np.float32))
    w = schedule_weights(CFG, 5)
    pmat, mmat = ((hp.proj[k][1], hp.proj[k][0]) if proj
                  else (hp.Ainv, None))
    args = [xi, suite["start"].expand(3, 9), goal, tail, *obs, w[0], w[1],
            w[3], suite["lower"].expand(3, 9), suite["upper"].expand(3, 9),
            hp.diff_matrices[0], hp.A, pmat, mmat,
            model_api.dof_tables(suite["model"]), hp.time_interval,
            CFG.clip_grad_scale, float(CFG.allow_collision_point),
            CFG.terminate_smooth_loss, proj, True, False]
    got = step(fn, args)
    plain = kernels.chomp_step_plain(*args)
    near_f64(step_outputs(got), step_outputs(plain),
             step_outputs(kernels.chomp_step_plain(*_f64(args))),
             STEP_OUTPUTS, "chomp_step")
    assert torch.equal(got[2], plain[2])
