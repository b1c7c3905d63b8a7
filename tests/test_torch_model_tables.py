"""What the kernels read of a robot model (``models/api.py::kernel_tables``:
``kernels.fk_tables``' buffer, its ``pqr`` head, the Jacobian and dof
tables), on the CPU.

The tables are made once for the model object and held by it: 24 other
models (the learner's thinned copies and ``_replace``d models with points
of their own) run through ``panda_fk``, ``ik_prefilter``,
``chomp_obstacle`` and ``chomp_step`` with their own tables, and the first
model's tables stay the same objects with the same values.  A
``_replace``d model's FK is ``panda_fk_plain`` on its own points, bit for
bit, and its thinned copy is made once per point count."""

import pytest
import torch

from omg_planner_torch.config import OMGConfig
from omg_planner_torch.models import api
from omg_planner_torch.models import panda
from omg_planner_torch.ops import chomp
from omg_planner_torch.ops import ik as ik_ops
from omg_planner_torch.ops import kernels

CFG = OMGConfig(silent=True)


@pytest.fixture(scope="module")
def base():
    return panda.load_panda(15, "cpu")


def _configs(model, n, gen):
    lo, hi = model.joint_lower, model.joint_upper
    return lo + (hi - lo) * torch.rand(n, 9, generator=gen)


def _run_kernels(model, q, gen):
    """One call of each kernel on ``model``'s tables; (FK body points, the
    prefilter's q, the obstacle gradient, the stepped trajectory)."""
    hp = CFG.horizon().on("cpu")
    t, links, p = hp.timesteps, 10, model.num_collision_points
    _, x = api.fk_points(model, q)
    tgt = api.hand_poses(model, q)
    q_pre, _ = ik_ops.ik_batch_fixed(model, tgt, q[:, :7], CFG,
                                     model.joint_lower[:7],
                                     model.joint_upper[:7], 2)
    poses, og, ax, xt = api.fk_points(model, _configs(model, t, gen),
                                      joint_info=True)
    pot = torch.rand(t, links, p, generator=gen)
    obs = kernels.chomp_obstacle(
        xt, og, ax, xt[0], xt[-1], pot, torch.rand(t, links, p, 3,
                                                   generator=gen),
        (pot > 0.5).float(), hp.diff_matrices, api.jacobian_tables(model),
        hp.time_interval, 100, False, True, False)
    xi = _configs(model, t, gen)
    w = torch.tensor(1.0)
    new, _ = chomp.chomp_step(model, CFG.replace(goal_set_proj=False), hp,
                              xi, xi[0], xi[-1], xi[-1:], obs, (w, w, w),
                              model.joint_lower, model.joint_upper)
    return x, q_pre, obs[1], new


def test_tables_are_held_by_their_model_through_churn(base):
    gen = torch.Generator().manual_seed(0)
    q = _configs(base, 6, gen)
    first = _run_kernels(base, q, torch.Generator().manual_seed(1))
    tables = api.kernel_tables(base)
    held = {f: v.clone() for f, v in tables._asdict().items()}
    ptrs = {f: v.data_ptr() for f, v in tables._asdict().items()}

    others = [api.thinned(base, n) for n in range(2, 14)]
    others += [base._replace(collision_points=torch.rand(
        10, 3 + k, 3, generator=gen)) for k in range(12)]
    assert len({id(m) for m in others}) == 24
    for m in others:
        _run_kernels(m, q, gen)
        assert api.kernel_tables(m).fk is not tables.fk

    assert api.kernel_tables(base) is tables
    for f, v in tables._asdict().items():
        assert v.data_ptr() == ptrs[f], f
        assert torch.equal(v, held[f]), f
    again = _run_kernels(base, q, torch.Generator().manual_seed(1))
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_replaced_model_reads_its_own_points(base):
    gen = torch.Generator().manual_seed(2)
    q = _configs(base, 5, gen)
    pts = torch.rand(10, 7, 3, generator=gen)
    m = base._replace(collision_points=pts)
    got = api.fk_points(m, q)[1]
    want = kernels.panda_fk_plain(
        q, panda.pqr_table(base.pose_0, base.chain_post), base.pose_0,
        base.center_offset, pts)[3]
    assert got.shape == (5, 10, 7, 3) and torch.equal(got, want)
    assert torch.equal(kernels.fk_table_parts(api.kernel_tables(m).fk)[3],
                       pts)


def test_thinned_model_is_made_once_per_point_count(base):
    five = api.thinned(base, 5)
    assert api.thinned(base, 5) is five
    assert api.thinned(base, 0) is base and api.thinned(base, 15) is base
    assert torch.equal(five.collision_points,
                       base.collision_points[:, ::3][:, :5])
    assert api.kernel_tables(five) is api.kernel_tables(five)
    assert api.thinned(base._replace(), 5) is not five
