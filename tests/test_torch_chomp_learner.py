"""CHOMP cost/update and the online learner of the port against the JAX
package on one staged problem.

Problem: synthetic scene 5 at ``tests/test_golden.py::CFG``, staged by the
JAX package and carried across with ``interop``.  Trajectories are the
staged spline plus numpy noise from fixed seeds, so the collision terms,
the top-k mask and the joint-limit loop all have work to do.

Tolerances: costs and potentials rtol 1e-4 (float32 sums of ~4500 point
terms in another order); gradients atol 2e-3 of their largest entry
(the functional gradient divides by |v|^2, which magnifies float32
rounding near the trajectory's end, where the points barely move:
measured up to 9e-4 of the largest entry); trajectory updates atol
1e-5; learner distributions atol 1e-5; goal picks and masks exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.config import schedule_weights as jschedule
from omg_planner_tpu.ops import chomp as jchomp
from omg_planner_tpu.ops import learner as jol
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.config import schedule_weights as tschedule
from omg_planner_torch.ops import chomp as tchomp
from omg_planner_torch.ops import learner as tol
from test_golden import CFG

torch.set_num_threads(2)


def T(a):
    return torch.as_tensor(np.array(a))


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


def close(t, j, atol=1e-5, rtol=0.0):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=rtol)


@pytest.fixture(scope="module")
def staged():
    js = JScene.synthetic(CFG, scene_id=5, n_obstacles=2)
    jprob = js.build_problem()
    nprob = jax.tree.map(np.asarray, jprob)
    return dict(js=js, jprob=jprob, nprob=nprob,
                tmodel=interop.panda_model(jax.tree.map(np.asarray, js.model),
                                           "cpu"),
                tprob=interop.plan_problem(nprob, "cpu"))


def _trajs(nprob, n=3):
    rng = np.random.default_rng(3)
    base = nprob.traj_init
    out = [base]
    for _ in range(n - 1):
        noise = rng.normal(scale=0.15, size=base.shape).astype(np.float32)
        noise[:, 7:] = 0.0
        out.append(base + noise)
    return out


@pytest.mark.parametrize("quirks", [False, True])
def test_total_loss_matches_jax(staged, quirks):
    cfg = CFG.replace(ref_topk_quirks=quirks, top_k_collision=300)
    tc = tcfg(cfg)
    js, jprob, tprob = staged["js"], staged["jprob"], staged["tprob"]
    jhp, thp = cfg.horizon(), tc.horizon().on("cpu")
    goal = jprob.goal_set.grasps[0]
    for step in (0, 7):
        ow, sw, _, _ = jschedule(cfg, step + 1)
        tow, tsw, _, _ = tschedule(tc, step + 1)
        close(tow, ow, atol=0, rtol=1e-6)
        close(tsw, sw, atol=0, rtol=1e-6)
        fn = jax.jit(lambda xi: jchomp.compute_total_loss(
            js.model, jprob.scene, jprob.cost_params, cfg, jhp, xi,
            jprob.start, goal, goal, ow, sw))
        for xi in _trajs(staged["nprob"]):
            jc, jg, ji = fn(jnp.asarray(xi))
            tcost, tg, ti = tchomp.compute_total_loss(
                staged["tmodel"], tprob.scene, tprob.cost_params, tc, thp,
                T(xi), tprob.start, tprob.goal_set.grasps[0],
                tprob.goal_set.grasps[0], tow, tsw)
            close(tcost, jc, rtol=1e-4)
            close(tg, jg, atol=2e-3 * max(1.0, float(np.abs(jg).max())))
            for name in ji._fields:
                a, b = getattr(ti, name), getattr(ji, name)
                if b.dtype == bool:
                    assert bool(a) == bool(b), name
                else:
                    close(a, b, atol=1e-4, rtol=1e-4)
    assert float(ji.collide) > 0  # the noisy trajectories collide


def test_forward_kinematics_obstacle_matches_jax(staged):
    js, jprob, tprob = staged["js"], staged["jprob"], staged["tprob"]
    xi = _trajs(staged["nprob"])[1]
    jout = jax.jit(lambda xi: jchomp.forward_kinematics_obstacle(
        js.model, jprob.scene, jprob.cost_params, CFG, CFG.horizon(), xi,
        jprob.start, jprob.end))(jnp.asarray(xi))
    tout = tchomp.forward_kinematics_obstacle(
        staged["tmodel"], tprob.scene, tprob.cost_params, tcfg(CFG),
        tcfg(CFG).horizon().on("cpu"), T(xi), tprob.start, tprob.end)
    for a, b in zip(tout, jout):
        close(a, b, atol=2e-4, rtol=1e-4)


def test_update_and_joint_limits_match_jax(staged):
    cfg, tc = CFG, tcfg(CFG)
    jprob, tprob = staged["jprob"], staged["tprob"]
    jhp, thp = cfg.horizon(), tc.horizon().on("cpu")
    rng = np.random.default_rng(5)
    xi = staged["nprob"].traj_init.copy()
    grad = rng.normal(size=xi.shape).astype(np.float32)
    tail = staged["nprob"].goal_set.reach_grasps[0]
    ju = jchomp.goal_set_projection_update(jhp, cfg, jnp.asarray(xi),
                                           jnp.asarray(grad),
                                           jnp.asarray(tail), 0.1)
    tu = tchomp.goal_set_projection_update(thp, tc, T(xi), T(grad), T(tail),
                                           0.1)
    close(tu, ju, atol=1e-5)
    close(tchomp.unconstrained_update(thp, T(grad), 0.1),
          jchomp.unconstrained_update(jhp, jnp.asarray(grad), 0.1))
    jn = jchomp.apply_update(staged["js"].model, cfg, jnp.asarray(xi), ju)
    tn = tchomp.apply_update(staged["tmodel"], tc, T(xi), tu)
    close(tn, jn, atol=1e-5)
    # push some joints past the soft limits: the smoothing loop iterates
    over = xi.copy()
    over[10:20, 1] = np.asarray(jprob.joint_upper)[1] + 0.3
    over[5:9, 3] = np.asarray(jprob.joint_lower)[3] - 0.2
    jl = jax.jit(lambda x: jchomp.handle_joint_limit(
        jhp, cfg, x, jprob.joint_lower, jprob.joint_upper))(jnp.asarray(over))
    tl = tchomp.handle_joint_limit(thp, tc, T(over), tprob.joint_lower,
                                   tprob.joint_upper)
    assert np.abs(np.asarray(jl) - over).max() > 0.05
    close(tl, jl, atol=1e-4)
    for x in (xi, over):
        assert bool(tchomp.check_joint_limit(
            T(x), tprob.joint_lower, tprob.joint_upper)) == bool(
                jchomp.check_joint_limit(jnp.asarray(x), jprob.joint_lower,
                                         jprob.joint_upper))


@pytest.mark.parametrize("parity_density", [False, True])
def test_cost_vector_matches_jax(staged, parity_density):
    cfg = CFG.replace(parity_density=parity_density)
    tc = tcfg(cfg)
    js, jprob, tprob = staged["js"], staged["jprob"], staged["tprob"]
    for t in (0.0, 1.0, 6.0):
        for xi in _trajs(staged["nprob"], 2):
            jr = jax.jit(lambda xi, t: jol.cost_vector_raw(
                js.model, jprob.scene, jprob.cost_params, cfg, cfg.horizon(),
                xi, jprob.goal_set, t, jprob.world_potential))(
                    jnp.asarray(xi), jnp.asarray(t))
            tr = tol.cost_vector_raw(
                staged["tmodel"], tprob.scene, tprob.cost_params, tc,
                tc.horizon().on("cpu"), T(xi), tprob.goal_set, t,
                tprob.world_potential)
            close(tr, jr, atol=1e-6, rtol=1e-4)
            close(tol.finalize_cost_vector(tc, tr, tprob.goal_set.mask),
                  jol.finalize_cost_vector(cfg, jr, jprob.goal_set.mask),
                  atol=1e-6, rtol=1e-4)
    assert (np.asarray(jr) > 0).all()


def _random_goal_set(n=12, n_valid=9, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.zeros(n, bool)
    mask[rng.choice(n, n_valid, replace=False)] = True
    grasps = rng.uniform(-1, 1, (n, 9)).astype(np.float32)
    goal = jchomp.GoalSet(grasps=grasps, reach_grasps=np.repeat(
        grasps[:, None], 5, 1), mask=mask,
        potentials=np.zeros(n, np.float32))
    cv = np.where(mask, rng.uniform(0, 1, n), 1e6).astype(np.float32)
    return goal, cv


@pytest.mark.parametrize("alg", ["MD", "FTL", "FTC", "Exp", "Proj"])
def test_update_goal_dist_matches_jax(alg):
    cfg = CFG.replace(ol_alg=alg)
    goal, cv = _random_goal_set()
    jgoal = jax.tree.map(jnp.asarray, goal)
    tgoal = interop.goal_set(goal, "cpu")
    js = jol.init_learner_state(jgoal)
    ts = tol.init_learner_state(tgoal)
    end = goal.grasps[4] + 0.01
    rng = np.random.default_rng(1)
    for _ in range(4):
        js = jol.update_goal_dist(cfg, js, jnp.asarray(cv), jgoal,
                                  jnp.asarray(end))
        ts = tol.update_goal_dist(tcfg(cfg), ts, T(cv), tgoal, T(end))
        for name in ("p", "sum_costs", "experts_p", "experts_costs", "q"):
            close(getattr(ts, name), getattr(js, name), atol=1e-5)
        cv = np.where(goal.mask, rng.uniform(0, 1, 12), 1e6).astype(
            np.float32)


@pytest.mark.parametrize("uniform_w", [True, False])
def test_bregman_projection_matches_jax(uniform_w):
    rng = np.random.default_rng(2)
    g = 12
    mask = np.ones(g, bool)
    mask[[2, 7]] = False
    mf = mask.astype(np.float32)
    x = rng.dirichlet(np.ones(g), 5).astype(np.float32) * mf
    v = rng.uniform(0, 2, (5, g)).astype(np.float32)
    delta = (mf / (4 * mf.sum() + 1)).astype(np.float32)
    w = np.ones(g, np.float32)
    jy = jax.vmap(lambda xi, vi: jol.bregman_projection(
        xi, vi, jnp.asarray(delta), jnp.asarray(w), jnp.asarray(mask),
        uniform_w=uniform_w))(jnp.asarray(x), jnp.asarray(v))
    ty = tol.bregman_projection(T(x), T(v), T(delta), T(w), T(mask),
                                uniform_w=uniform_w)
    close(ty, jy, atol=1e-5)
    close(ty.sum(-1), np.ones(5), atol=1e-5)
    assert (ty.numpy()[:, ~mask] == 0).all()


def test_find_zero_matches_jax():
    roots = np.array([0.3, -1.2, 2.5], np.float32)

    def jf(x):
        return x ** 3 - jnp.asarray(roots) ** 3

    def tf(x):
        return x ** 3 - T(roots) ** 3

    lo, hi = np.full(3, -3.0, np.float32), np.full(3, 3.0, np.float32)
    j = jol.find_zero(jf, jnp.asarray(lo), jnp.asarray(hi))
    t = tol.find_zero(tf, T(lo), T(hi))
    close(t, j, atol=1e-6)
    close(t, roots, atol=1e-5)


def test_update_goal_active_lane_sweep_matches_jax(staged):
    """The restricted sweep (4 active lanes of 12, a full re-rank every 3
    learner steps) followed step by step on a moving trajectory."""
    cfg = CFG.replace(learner_active_goals=4, learner_refresh_every=3)
    tc = tcfg(cfg)
    js, jprob, tprob = staged["js"], staged["jprob"], staged["tprob"]
    assert jol.sweep_restricted(cfg, 12) and tol.sweep_restricted(tc, 12)
    jhp, thp = cfg.horizon(), tc.horizon().on("cpu")
    raw0 = jol.cost_vector_raw(js.model, jprob.scene, jprob.cost_params, cfg,
                               jhp, jprob.traj_init, jprob.goal_set,
                               jnp.asarray(0.0), jprob.world_potential)
    cv0 = jol.finalize_cost_vector(cfg, raw0, jprob.goal_set.mask)
    jstate = jol.init_learner_state(jprob.goal_set, 4)._replace(
        last_raw=raw0, active_idx=jax.lax.top_k(-cv0, 4)[1])
    tstate = tol.init_learner_state(tprob.goal_set, 4)._replace(
        last_raw=T(np.asarray(raw0)),
        active_idx=T(np.asarray(jstate.active_idx)).long())
    step = jax.jit(lambda st, xi: jol.update_goal(
        js.model, jprob.scene, jprob.cost_params, cfg, jhp, xi,
        jprob.goal_set, st, jprob.world_potential))
    picks = []
    for i, xi in enumerate(_trajs(staged["nprob"], 5)):
        jstate, jg = step(jstate, jnp.asarray(xi))
        tstate, tg = tol.update_goal(
            staged["tmodel"], tprob.scene, tprob.cost_params, tc, thp, T(xi),
            tprob.goal_set, tstate, tprob.world_potential)
        assert int(tg) == int(jg), i
        np.testing.assert_array_equal(tstate.active_idx.numpy(),
                                      np.asarray(jstate.active_idx))
        for name in ("p", "last_raw", "ti", "q"):
            close(getattr(tstate, name), getattr(jstate, name), atol=1e-5,
                  rtol=1e-4)
        assert tstate.t == float(jstate.t)
        picks.append(int(jg))
    assert len(set(picks)) >= 1
