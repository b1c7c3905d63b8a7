"""The goal-set build's IK operators (``omg_torch::ik_prefilter`` and
``omg_torch::ik_chain``, ``omg_planner_torch/ops/kernels.py``) on the CPU,
where they run their plain versions.

* Their CPU key against the eager loops that ``ops/ik.py`` ran before the
  loops became operators (copied below as they were): bit for bit, with
  one budget for every lane and with a budget per scene.
* Against the JAX package (``ik_batch_fixed`` and ``_solve_chain_fused``)
  on the same inputs: suite scene 1's grasps (8 of them x the start and 3
  anchor seeds, 32 lanes x 6 stages), their standoff poses and a seeded
  set of near-solution lanes, handed to both as numpy arrays.  The chain:
  ``ok`` equal on every lane, ``qs`` within ``Q_TOL = 1e-3`` rad on the ok
  lanes (as ``tests/test_torch_goal_set.py`` holds the IK).  The
  prefilter: its 12 steps from far seeds are chaotic on some lanes (the
  redundant arm's null space, and ``so3_log`` near pi), so the lanes that
  go on, those under ``ik_prefilter_tol`` in both, are held to ``Q_TOL``
  and the flags to each other; every lane is held to 1e-3 on the
  near-solution set.
* Lanes that are not active, per-lane budgets of two "scenes" against each
  scene's own call, budget 0 (none) against a budget that cuts lanes, and
  a lane alone against its row of a batch.
* The operators' registration: one Autograd kernel each, a call on an
  input that requires grad raises, and ``torch.func.vmap`` folds the
  mapped axis into the lanes.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.config import OMGConfig as JConfig
from omg_planner_tpu.models import panda as jpanda
from omg_planner_tpu.ops import ik as jik
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.models import api, panda
from omg_planner_torch.ops import ik as tik
from omg_planner_torch.ops import kernels
from omg_planner_torch.planner import goal_set as tgs
from omg_planner_torch.planner.scene import PlanningScene
from omg_planner_torch.utils.sync import host_bool

torch.set_num_threads(2)

Q_TOL = 1e-3
CFG = OMGConfig(silent=True)
SCENE_1 = os.path.join(os.path.dirname(__file__), "..", "data", "suite_v2",
                       "scene_1.npz")
CHAIN_CFG = tik._chain_cfg(CFG)


def _old_batch_fixed(model, targets, seeds, cfg, lower7, upper7, iters):
    """``ops/ik.py::ik_batch_fixed`` as it was before the operator."""
    q = seeds
    for _ in range(iters):
        e, jac = tik._batch_error_and_jac(model, q, targets)
        q = kernels.ik_newton_step(jac, e, q, cfg.ik_damping, lower7, upper7)
    e, _ = tik._batch_error_and_jac(model, q, targets)
    return q, torch.linalg.norm(e, dim=1)


def _old_chain_fused(model, cfg, chain_tgts, seeds, lower7, upper7, active,
                     scene_budgets=None):
    """``ops/ik.py::_solve_chain_fused`` as it was before the operator."""
    b, k = chain_tgts.shape[0], chain_tgts.shape[1]
    dev = seeds.device
    tol = cfg.ik_pos_tol
    max_it = cfg.ik_max_iters
    window = cfg.ik_stall_window
    budget = cfg.ik_chain_total_budget
    lanes = torch.arange(b, device=dev)
    lane_budget = None
    if scene_budgets is not None:
        budget = 0 if 0 in scene_budgets else max(scene_budgets)
        lane_budget = torch.tensor(
            [v or 2**62 for v in scene_budgets],
            device=dev).repeat_interleave(b // len(scene_budgets))
    q = seeds
    s = torch.where(active, 0, k)
    it = torch.zeros(b, dtype=torch.int32, device=dev)
    err_best = torch.full((b,), torch.inf, device=dev)
    stall = torch.zeros(b, dtype=torch.int32, device=dev)
    ok = active
    qs = torch.zeros((b, k, 7), dtype=seeds.dtype, device=dev)
    glob = 0
    live = s < k
    while (not budget or glob < budget) and host_bool(torch.any(live)):
        stage = torch.clamp(s, max=k - 1)
        tgt_now = chain_tgts[lanes, stage]
        e, jac = tik._batch_error_and_jac(model, q, tgt_now)
        err = torch.linalg.norm(e, dim=1)
        stalled = (stall >= window) if window else torch.zeros_like(live)
        fin = live & ((err <= tol) | (it >= max_it) | stalled)
        pos_err = torch.linalg.norm(e[:, :3], dim=1)
        rot_err = torch.linalg.norm(e[:, 3:], dim=1)
        succ = (pos_err < tol * 10) & (rot_err < cfg.ik_rot_tol * 10)
        rec = (fin[:, None]
               & (torch.arange(k, device=dev)[None, :] == stage[:, None]))
        qs = torch.where(rec[:, :, None], q[:, None, :], qs)
        ok = ok & torch.where(fin, succ, torch.ones_like(succ))
        s = torch.where(fin, torch.where(succ, s + 1, k), s)
        q_new = kernels.ik_newton_step(jac, e, q, cfg.ik_damping, lower7,
                                       upper7)
        upd = live & ~fin
        improved = err < 0.85 * err_best
        q = torch.where(upd[:, None], q_new, q)
        it = torch.where(fin, 0, it + upd.to(it.dtype))
        err_best = torch.where(fin, torch.full_like(err, torch.inf),
                               torch.minimum(err_best, err))
        stall = torch.where(fin | improved, 0, stall + upd.to(stall.dtype))
        glob += 1
        live = s < k
        if lane_budget is not None:
            live = live & (glob < lane_budget)
    ok = ok & (s >= k)
    return qs[:, 1:], ok


@pytest.fixture(scope="module")
def lanes():
    """Suite scene 1's first 8 grasps (every sixth) x 4 seeds: the
    prefilter's targets and seeds, the chain's 6 stage targets, the
    port's prefilter result (the chain's seeds) and the soft limits, with
    the JAX model and the port's model built from the same tables."""
    sc = PlanningScene.from_npz(CFG, SCENE_1,
                                device="cpu")
    grasps = torch.as_tensor(sc.env.grasp_poses_world()[::6][:8],
                             dtype=torch.float32)
    seeds = torch.cat([torch.as_tensor(sc.start[None, :7]), torch.as_tensor(
        tgs.ANCHOR_SEEDS[:3, :7])]).float()
    tgt = torch.repeat_interleave(tik._standoff_targets(CFG, grasps), 4, 0)
    jmodel = jpanda.load_panda()
    model = interop.panda_model(jax.tree.map(np.asarray, jmodel), "cpu")
    lo, hi = model.soft_limits(CFG.soft_joint_limit_padding)
    seeds_b = seeds.repeat(8, 1)
    q_pre, err_pre = tik.ik_batch_fixed(model, tgt[:, -1], seeds_b, CFG,
                                        lo[:7], hi[:7],
                                        CFG.ik_prefilter_iters)
    return dict(model=model, jmodel=jmodel, lo=lo[:7], hi=hi[:7],
                pre_tgt=tgt[:, -1], seeds=seeds_b,
                chain_tgts=torch.cat([tgt[:, -1:], tgt], 1), q_pre=q_pre,
                active=err_pre < CFG.ik_prefilter_tol)


def _near_solutions(model, lo, hi, n=32, seed=5):
    """n lanes with reachable targets (the hand at a seeded q_true within
    the limits) and seeds 0.05 rad (s.d.) from q_true."""
    rng = np.random.default_rng(seed)
    q_true = (lo + (hi - lo) * torch.as_tensor(
        rng.uniform(0.3, 0.7, (n, 7)), dtype=torch.float32))
    tgts = panda.hand_pose_batch(model, torch.cat(
        [q_true, torch.full((n, 2), 0.04)], 1))
    return tgts, q_true + torch.as_tensor(rng.normal(0, 0.05, (n, 7)),
                                          dtype=torch.float32)


def _chain(st, cfg=CHAIN_CFG, active=None, seeds=None, **kw):
    return tik._solve_chain_fused(
        st["model"], cfg, st["chain_tgts"],
        st["q_pre"] if seeds is None else seeds, st["lo"], st["hi"],
        st["active"] if active is None else active, **kw)


def test_prefilter_operator_matches_eager_loop(lanes):
    st = lanes
    for tgts, seeds in ((st["pre_tgt"], st["seeds"]),
                        _near_solutions(st["model"], st["lo"], st["hi"])):
        for iters in (0, 1, CFG.ik_prefilter_iters):
            got = tik.ik_batch_fixed(st["model"], tgts, seeds, CFG,
                                     st["lo"], st["hi"], iters)
            want = _old_batch_fixed(st["model"], tgts, seeds, CFG, st["lo"],
                                    st["hi"], iters)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), iters
            assert got[0].data_ptr() != seeds.data_ptr()


@pytest.mark.parametrize("budget", [CHAIN_CFG.ik_chain_total_budget, 0, 9])
def test_chain_operator_matches_eager_loop(lanes, budget):
    st = lanes
    cfg = CHAIN_CFG.replace(ik_chain_total_budget=budget)
    got = _chain(st, cfg)
    want = _old_chain_fused(st["model"], cfg, st["chain_tgts"], st["q_pre"],
                            st["lo"], st["hi"], st["active"])
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[0].shape == (32, 5, 7)
    assert 0 < int(got[1].sum()) < 32 or budget == 9   # 9: too few
    # a budget per scene: two "scenes" of 16 lanes
    for budgets in ([budget, 26], [0, budget], [7, 0]):
        got = _chain(st, active=st["active"], scene_budgets=budgets)
        want = _old_chain_fused(st["model"], CHAIN_CFG, st["chain_tgts"],
                                st["q_pre"], st["lo"], st["hi"],
                                st["active"], budgets)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _jax_cfg(cfg):
    """The JAX package's config with ``cfg``'s values."""
    return JConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(JConfig)})


def test_prefilter_matches_jax(lanes):
    st = lanes
    jcfg = _jax_cfg(CFG)
    lo, hi = st["lo"].numpy(), st["hi"].numpy()

    def jax_pre(tgts, seeds):
        out = jax.jit(lambda m, t, s: jik.ik_batch_fixed(
            m, t, s, jcfg, lo, hi, CFG.ik_prefilter_iters))(
                st["jmodel"], jnp.asarray(tgts.numpy()),
                jnp.asarray(seeds.numpy()))
        return [np.asarray(x) for x in out]

    tol = CFG.ik_prefilter_tol
    jq, je = jax_pre(st["pre_tgt"], st["seeds"])
    tq, te = (x.numpy() for x in tik.ik_batch_fixed(
        st["model"], st["pre_tgt"], st["seeds"], CFG, st["lo"], st["hi"],
        CFG.ik_prefilter_iters))
    flips = np.flatnonzero((je < tol) != (te < tol))
    for i in flips:
        print(f"lane {i}: JAX err {je[i]:.6g}, port {te[i]:.6g}, "
              f"threshold {tol}: margins {je[i] - tol:.3g}, {te[i] - tol:.3g}")
    assert flips.size == 0
    go_on = je < tol
    assert 4 <= go_on.sum() < 32
    np.testing.assert_allclose(tq[go_on], jq[go_on], atol=Q_TOL)
    np.testing.assert_allclose(te[go_on], je[go_on], atol=Q_TOL)
    # every lane, near its solution
    tgts, seeds = _near_solutions(st["model"], st["lo"], st["hi"])
    jq, je = jax_pre(tgts, seeds)
    tq, te = tik.ik_batch_fixed(st["model"], tgts, seeds, CFG, st["lo"],
                                st["hi"], CFG.ik_prefilter_iters)
    np.testing.assert_allclose(tq.numpy(), jq, atol=Q_TOL)
    np.testing.assert_allclose(te.numpy(), je, atol=Q_TOL)
    assert float(te.max()) < 1e-3


def _margins(st, qs, lane):
    """The acceptance's ratios (position, rotation error over 10 x their
    tolerance) at a lane's recorded tail solutions: 1 is the threshold."""
    pos, rot = kernels.ik_acceptance(
        st["chain_tgts"][lane:lane + 1], torch.as_tensor(qs[lane:lane + 1]),
        panda.pqr_table(st["model"].pose_0, st["model"].chain_post),
        st["model"].pose_0)
    return ((pos / (10 * CFG.ik_pos_tol)).numpy().round(4).tolist(),
            (rot / (10 * CFG.ik_rot_tol)).numpy().round(4).tolist())


def test_chain_matches_jax(lanes):
    st = lanes
    jcfg = _jax_cfg(CHAIN_CFG)
    jqs, jok = (np.asarray(x) for x in jax.jit(
        lambda m, c, s, a: jik._solve_chain_fused(
            m, jcfg, c, s, st["lo"].numpy(), st["hi"].numpy(), a))(
                st["jmodel"], jnp.asarray(st["chain_tgts"].numpy()),
                jnp.asarray(st["q_pre"].numpy()),
                jnp.asarray(st["active"].numpy())))
    tqs, tok = (x.numpy() for x in _chain(st))
    for i in np.flatnonzero(jok != tok):
        print(f"lane {i}: JAX ok {jok[i]} {_margins(st, jqs, i)}, port ok "
              f"{tok[i]} {_margins(st, tqs, i)}")
    np.testing.assert_array_equal(tok, jok)
    assert 4 <= jok.sum() < 32
    np.testing.assert_allclose(tqs[jok], jqs[jok], atol=Q_TOL)


def test_chain_inactive_lanes_and_budgets(lanes):
    st = lanes
    active = st["active"].clone()
    active[::3] = False
    qs, ok = _chain(st, active=active)
    assert not bool(ok[~active].any())
    assert bool((qs[~active] == 0).all())
    # per-lane budgets of two "scenes" against each scene's own call
    for budgets in ([26, 0], [5, 26]):
        both = _chain(st, active=active, scene_budgets=budgets)
        for i, b in enumerate(budgets):
            rows = slice(16 * i, 16 * (i + 1))
            sub = dict(st, chain_tgts=st["chain_tgts"][rows])
            one = _chain(sub, CHAIN_CFG.replace(ik_chain_total_budget=b),
                         active=active[rows], seeds=st["q_pre"][rows])
            assert torch.equal(one[0], both[0][rows])
            assert torch.equal(one[1], both[1][rows])
    # budget 0 is none: every lane ends its chain; a budget of 5 cuts
    # lanes that budget 0 completes
    none = _chain(st, CHAIN_CFG.replace(ik_chain_total_budget=0))
    cut = _chain(st, CHAIN_CFG.replace(ik_chain_total_budget=5))
    assert bool((none[1] | ~cut[1]).all()) and int(cut[1].sum()) < int(
        none[1].sum())


def test_lane_alone_matches_its_row(lanes):
    st = lanes
    pqr = panda.pqr_table(st["model"].pose_0, st["model"].chain_post)
    q, err = kernels.ik_prefilter_plain(
        st["pre_tgt"], st["seeds"], pqr, st["model"].pose_0, st["lo"],
        st["hi"], CFG.ik_damping, 12)
    qs, ok = _chain(st)
    budgets = torch.full((32,), 26, dtype=torch.int32)
    for i in (0, 5, 31):
        q1, e1 = kernels.ik_prefilter_plain(
            st["pre_tgt"][i], st["seeds"][i], pqr, st["model"].pose_0,
            st["lo"], st["hi"], CFG.ik_damping, 12)
        assert torch.equal(q1, q[i]) and torch.equal(e1, err[i])
        qs1, ok1 = kernels.ik_chain(
            st["chain_tgts"][i:i + 1], st["q_pre"][i:i + 1],
            st["active"][i:i + 1], budgets[i:i + 1],
            api.kernel_tables(st["model"]).fk, st["lo"], st["hi"],
            CFG.ik_damping, CFG.ik_pos_tol, CFG.ik_rot_tol,
            CHAIN_CFG.ik_max_iters, CFG.ik_stall_window)
        assert torch.equal(qs1[0], qs[i]) and torch.equal(ok1[0], ok[i])


def test_operators_registration(lanes):
    st = lanes
    has = torch._C._dispatch_has_kernel_for_dispatch_key
    for name in ("ik_prefilter", "ik_chain"):
        op = f"omg_torch::{name}"
        assert all(has(op, key) for key in ("CPU", "CUDA", "Autograd"))
        assert not has(op, "AutogradCUDA")
    tables = api.kernel_tables(st["model"]).fk
    args = (tables, st["lo"], st["hi"], CFG.ik_damping, 2)
    with pytest.raises(RuntimeError, match="autograd"):
        kernels.ik_prefilter(st["pre_tgt"],
                             st["seeds"].clone().requires_grad_(), *args)
    # vmap folds the mapped axis into the lanes: 4 rows of 8
    flat = kernels.ik_prefilter(st["pre_tgt"], st["seeds"], *args)
    mapped = torch.func.vmap(lambda t, s: kernels.ik_prefilter(t, s, *args))(
        st["pre_tgt"].reshape(4, 8, 4, 4), st["seeds"].reshape(4, 8, 7))
    assert all(torch.equal(a.reshape(b.shape), b)
               for a, b in zip(mapped, flat))
    budgets = torch.full((32,), 26, dtype=torch.int32)
    rest = (tables, st["lo"], st["hi"], CFG.ik_damping,
            CFG.ik_pos_tol, CFG.ik_rot_tol, CHAIN_CFG.ik_max_iters,
            CFG.ik_stall_window)
    flat = kernels.ik_chain(st["chain_tgts"], st["q_pre"], st["active"],
                            budgets, *rest)
    mapped = torch.func.vmap(lambda c, s, a, b: kernels.ik_chain(
        c, s, a, b, *rest))(st["chain_tgts"].reshape(4, 8, 6, 4, 4),
                            st["q_pre"].reshape(4, 8, 7),
                            st["active"].reshape(4, 8), budgets.reshape(4, 8))
    assert torch.equal(mapped[0].reshape(32, 5, 7), flat[0])
    assert torch.equal(mapped[1].reshape(32), flat[1])
