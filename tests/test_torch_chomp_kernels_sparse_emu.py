"""The CHOMP kernels' source (``omg_planner_torch/csrc/chomp_cost.cu``)
under ``csrc/cuda_emu.h`` on the CPU, against their plain versions, on the
rows that exercise ``chomp_obstacle``'s list of selected points: the
kernel lists the points at or above the k-th potential, less those whose
potential and gradient are both zero (every point of a row with a
non-finite input), forms one listed point a thread in rounds of one
block, and sums each timestep's contributions in list order.

Inputs: three ``chomp_obstacle`` calls of suite scene 1's plan on the
CPU at full width (T = 30, 4,500 points, k = 1,000), captured as
``ops/chomp.py`` passes them and stacked as rows: 1,400-1,700 of each
row's potentials are positive and the rest exactly zero, so the k-th
value is positive and at most k points are listed.  Cases: those rows
with every flag (quirks, ``consider_finger``, the softening), k = 1
and k >= T L P; a row of all zeros; a timestep with no selected point and
one with all 150 selected; ties at the k-th value across timesteps; NaN
or inf in the potential, the position or the gradient of a point that is
not selected; T = 5 and 40 with few points listed; the UR-like chain (D =
6, no fingers); and ``chomp_step`` with and without the goal-set
projection on rows past the joint limits.

Bars (those of ``tests/test_torch_chomp_kernels_emu.py``, whose helpers
this file uses): the k-th value and the mask bit for bit; every other
output within max(1e-5 of its size, 2 x the float32 plain version's
distance) of the float64 plain version, NaN where it has NaN; the
collision counts and the step's flags equal; each row of a launch bit for
bit its launch alone."""

import numpy as np
import pytest
import torch

from omg_planner_torch.config import OMGConfig, schedule_weights
from omg_planner_torch.models import api as model_api
from omg_planner_torch.models import chain
from omg_planner_torch.ops import kernels
from omg_planner_torch.planner.scene import PlanningScene
from test_torch_chain import _ur_points, ur_urdf
from test_torch_chomp_kernels_emu import (  # noqa: F401 (the lib fixture)
    STEP_OUTPUTS, _f64, check_obstacle, lib, near_f64, same_bits, step,
    step_outputs)

torch.set_num_threads(2)

CFG = OMGConfig(silent=True)
N_POINTS = 30 * 10 * 15
PLAN_CALLS = (0, 15, 31)


@pytest.fixture(scope="module")
def suite():
    """Suite scene 1 planned on the CPU: its model, start, end and limits,
    and the row arguments of its ``chomp_obstacle`` calls
    :data:`PLAN_CALLS` stacked (``rows``) with the calls' shared arguments
    (``shared``: dmats, tables, dt)."""
    sc = PlanningScene.from_npz(CFG, "data/suite_v2/scene_1.npz",
                                device="cpu")
    calls, op = [], kernels._chomp_obstacle_op

    def rec(*args):
        calls.append([a.clone() if torch.is_tensor(a) else a for a in args])
        return op(*args)

    kernels._chomp_obstacle_op = rec
    try:
        sc.step(fast=True)
    finally:
        kernels._chomp_obstacle_op = op
    picked = [calls[i] for i in PLAN_CALLS]
    return dict(model=sc.model, lower=sc.model.joint_lower,
                upper=sc.model.joint_upper,
                start=torch.as_tensor(np.asarray(sc.start, np.float32)),
                end=torch.as_tensor(np.asarray(sc.end, np.float32)),
                rows=[torch.stack(a) for a in zip(*(c[:8] for c in picked))],
                shared=picked[0][8:11])


def _obstacle_args(suite, rows=None, **flags):
    """``chomp_obstacle``'s operator arguments: the plan's rows (or
    ``rows``), k = 1,000 and the plan's flags unless ``flags`` say
    otherwise (k, finger, soften, quirks)."""
    spec = dict(k=CFG.top_k_collision, finger=False, soften=False,
                quirks=False)
    spec.update(flags)
    return list(rows or suite["rows"]) + list(suite["shared"]) + [
        spec["k"], spec["finger"], spec["soften"], spec["quirks"]]


def _fingers(suite):
    """The finger links of suite scene 1's model (bool [L])."""
    tables = model_api.jacobian_tables(suite["model"])
    return kernels._jacobian_parts(tables, 10)[3] > 0


def _with_pot(suite, pot):
    rows = list(suite["rows"])
    rows[5] = pot
    return rows


def _selected(got, r):
    """The points the kernel's mask selects in row r (its list holds those
    of them whose potential or gradient is not zero)."""
    return int((got[4][r] != 0).sum())


def test_rows_are_zero_heavy(suite):
    """The plan's rows: most potentials exactly zero, more than k positive,
    so the k-th value is positive and at most k points are listed."""
    pot = suite["rows"][5]
    for r in range(pot.shape[0]):
        zeros = int((pot[r] == 0).sum())
        assert zeros > N_POINTS // 2 and int((pot[r] > 0).sum()) > 1000


@pytest.mark.parametrize("flags", [
    {}, dict(quirks=True), dict(finger=True), dict(soften=True),
    dict(soften=True, quirks=True, finger=True), dict(k=1),
    dict(k=1, quirks=True), dict(k=N_POINTS), dict(k=N_POINTS + 7,
                                                   quirks=True)])
def test_obstacle_sparse_rows(lib, suite, flags):
    got = check_obstacle(lib["omg_chomp_obstacle"],
                         _obstacle_args(suite, **flags))
    fingers = _fingers(suite)
    k = flags.get("k", CFG.top_k_collision)
    for r in range(3):
        n = _selected(got, r)
        if k < N_POINTS:  # the top k, less the finger links' share
            assert n < N_POINTS // 3
            assert n >= k or not flags.get("finger")
        elif not flags.get("finger"):
            assert n == N_POINTS - 30 * 15 * int(fingers.sum())


@pytest.mark.parametrize("quirks", [False, True])
def test_obstacle_all_zero_row(lib, suite, quirks):
    """Row 1's potentials all zero: its k-th value is 0 and every point off
    the fingers is selected, and listed where its gradient is not zero;
    the rows beside it keep their own selection."""
    pot = suite["rows"][5].clone()
    pot[1] = 0.0
    got = check_obstacle(lib["omg_chomp_obstacle"], _obstacle_args(
        suite, _with_pot(suite, pot), quirks=quirks))
    assert float(got[3][1]) == 0.0
    assert _selected(got, 1) == N_POINTS - 30 * 15 * int(
        _fingers(suite).sum())
    assert _selected(got, 0) < N_POINTS // 2


@pytest.mark.parametrize("finger", [False, True])
def test_obstacle_empty_and_full_timesteps(lib, suite, finger):
    """t = 3 has no selected point (its potentials zeroed below a positive
    k-th value); t = 5 all 150 (above every other potential), so its
    segment of the list holds every point of the timestep."""
    pot = suite["rows"][5].clone()
    pot[:, 3] = 0.0
    pot[:, 5] = 10.0 + torch.arange(150.0).reshape(10, 15) / 150
    got = check_obstacle(lib["omg_chomp_obstacle"], _obstacle_args(
        suite, _with_pot(suite, pot), finger=finger))
    fingers = _fingers(suite)
    for r in range(3):
        assert float(got[3][r]) > 0
        assert int(got[4][r, 3].sum()) == 0
        on = got[4][r, 5] if finger else got[4][r, 5][~fingers]
        assert bool((on == 1).all())
        assert torch.equal(got[1][r, 3], torch.zeros(9))


def test_obstacle_ties_across_timesteps(lib, suite):
    """Forty points spread over every timestep set to the row's k-th value:
    all of them off the finger links are selected."""
    pot = suite["rows"][5].clone()
    rng = np.random.default_rng(41)
    for r in range(3):
        kth = torch.sort(pot[r].reshape(-1), descending=True)[0][999]
        for t in range(30):
            for q in rng.choice(150, 4 if t < 10 else 1, replace=False):
                pot[r, t, q // 15, q % 15] = kth
    got = check_obstacle(lib["omg_chomp_obstacle"],
                         _obstacle_args(suite, _with_pot(suite, pot)))
    fingers = _fingers(suite)
    for r in range(3):
        tied = (pot[r] == got[3][r]) & ~fingers[None, :, None]
        assert int(tied.sum()) >= 30 and bool((got[4][r][tied] == 1).all())


def _unselected(suite, r, fingers):
    """A point of row r below its k-th value, off the fingers."""
    pot = suite["rows"][5][r]
    for t in (12, 4):
        for l in range(10):
            if fingers[l]:
                continue
            for p in range(15):
                if pot[t, l, p] == 0:
                    return t, l, p
    raise AssertionError("no unselected point")


@pytest.mark.parametrize("where,value,flags", [
    ("pot", float("nan"), {}), ("pot", float("inf"), dict(quirks=True)),
    ("x", float("nan"), {}), ("x", float("inf"), dict(quirks=True)),
    ("grad", float("nan"), {}), ("grad", float("nan"), dict(quirks=True)),
    ("x_start", float("nan"), {})])
def test_obstacle_unselected_non_finite(lib, suite, where, value, flags):
    """A non-finite input at a point the mask leaves out spreads as the
    plain version's masked products spread it (the pot case on a finger
    link, which the mask drops); the other rows keep their bits."""
    rows = [a.clone() for a in suite["rows"]]
    fingers = _fingers(suite)
    t, l, p = _unselected(suite, 1, fingers)
    if where == "pot":
        l = int(torch.nonzero(fingers)[0])
        rows[5][1, t, l, p] = value
    elif where == "x":
        rows[0][1, t, l, p, 1] = value
    elif where == "grad":
        rows[6][1, t, l, p, 2] = value
    else:
        rows[3][1, l, p, 0] = value
    got = check_obstacle(lib["omg_chomp_obstacle"],
                         _obstacle_args(suite, rows, **flags))
    nan = torch.isnan(got[0][1]).any() or torch.isnan(got[1][1]).any()
    assert bool(nan)
    assert not torch.isnan(got[1][0]).any()


@pytest.mark.parametrize("t,k,quirks", [(5, 40, False), (5, 40, True),
                                         (40, 120, False)])
def test_obstacle_horizons_few_selected(lib, suite, t, k, quirks):
    """T = 5 and 40 (the suite's points resampled along time) with few
    points listed, so most timesteps' segments are empty or short."""
    idx = torch.linspace(0, 29, t).round().long()
    rows = list(suite["rows"])
    for i in (0, 1, 2, 5, 6, 7):
        rows[i] = rows[i][:, idx].contiguous()
    hp = CFG.horizon(t).on("cpu")
    args = rows + [hp.diff_matrices, model_api.jacobian_tables(
        suite["model"]), hp.time_interval, k, False, False, quirks]
    got = check_obstacle(lib["omg_chomp_obstacle"], args)
    assert all(_selected(got, r) < 150 * t // 3 for r in range(3))


@pytest.mark.parametrize("k", [0, 60])
def test_obstacle_ur_chain(lib, k):
    """The UR-like chain: D = 6, no finger links, its own Jacobian
    tables."""
    model = chain.load_urdf_chain(ur_urdf(), "base_link", "tool0",
                                  collision_points_per_link=8, device="cpu")
    model = chain.with_collision_points(model, _ur_points(model.num_joints))
    rng = np.random.default_rng(19)
    xi = torch.as_tensor(rng.uniform(-1, 1, (2, 30, model.num_dof))
                         .astype(np.float32))
    rows = []
    for q in xi:
        _, og, ax, x = model_api.fk_points(model, q, joint_info=True)
        xs, xe = model_api.end_points(model, q[0] * 0, q[-1])
        n = x.shape[:3]
        pot = torch.as_tensor(np.clip(rng.normal(-0.2, 0.2, n), 0, None)
                              .astype(np.float32))
        grad = torch.as_tensor(rng.normal(size=n + (3,)).astype(np.float32))
        rows.append((x, og, ax, xs, xe, pot, grad, (pot > 0.1).float()))
    hp = CFG.horizon().on("cpu")
    args = [torch.stack(a) for a in zip(*rows)] + [
        hp.diff_matrices, model_api.jacobian_tables(model), hp.time_interval,
        k, False, False, False]
    got = check_obstacle(lib["omg_chomp_obstacle"], args)
    assert got[1].shape == (2, 30, 6)


@pytest.mark.parametrize("proj,finger", [(True, False), (False, False),
                                         (True, True)])
def test_step_past_limits(lib, suite, proj, finger):
    """``chomp_step`` on the sparse rows' obstacle terms, trajectories past
    one or both joint limits, with and without the goal-set projection."""
    fn = lib["omg_chomp_step"]
    hp = CFG.horizon().on("cpu")
    obs = kernels.chomp_obstacle_plain(*_obstacle_args(suite))
    rng = np.random.default_rng(29)
    lo, hi = suite["lower"], suite["upper"]
    line = np.linspace(suite["start"].numpy(), suite["end"].numpy(), 30)
    xi = torch.minimum(torch.maximum(torch.as_tensor(
        (line[None] + rng.normal(scale=0.1, size=(3, 30, 9)))
        .astype(np.float32)), lo + 0.01), hi - 0.01)
    xi[0, 2, 3] = hi[3] + 0.3    # past both limits
    xi[0, 20, 5] = lo[5] - 0.3
    xi[2, 7, 1] = lo[1] - 0.1    # past one
    goal = suite["end"][None].repeat(3, 1)
    k = CFG.reach_tail_length if proj else 1
    tail = goal[:, None].repeat(1, k, 1) + torch.as_tensor(
        rng.normal(scale=0.01, size=(3, k, 9)).astype(np.float32))
    w = schedule_weights(CFG, 9)
    pmat, mmat = ((hp.proj[k][1], hp.proj[k][0]) if proj
                  else (hp.Ainv, None))
    args = [xi, suite["start"].expand(3, 9), goal, tail, *obs, w[0], w[1],
            w[3], lo.expand(3, 9), hi.expand(3, 9), hp.diff_matrices[0],
            hp.A, pmat, mmat, model_api.dof_tables(suite["model"]),
            hp.time_interval, CFG.clip_grad_scale,
            float(CFG.allow_collision_point), CFG.terminate_smooth_loss,
            proj, True, finger]
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
