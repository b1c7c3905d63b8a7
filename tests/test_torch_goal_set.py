"""Goal-set construction of the port against the JAX package on the CPU:
the batched IK, the augmentation / filter / prune / dedupe / sample
stages, the initial-goal policy and ``build_goal_set`` as a whole.

Staged problem: synthetic scene 5 at ``tests/test_golden.py::CFG``, staged
by the JAX package and carried across with ``interop`` so both sides see
the same model, scene and cost parameters.

Randomness: the sample stage's Gumbel noise is JAX's own draw
(``jax.random.gumbel`` on the key the JAX scene uses), handed to the port
through ``gumbel_fn``.

Lane order: the two-stage IK ranks lanes by their prefilter error.  Lanes
that converged sit at 2e-8..1e-7 there, i.e. float rounding, so the two
packages rank them differently; the per-lane results agree, but the
greedy dedupe is order dependent.  ``build_goal_set`` is therefore
compared with the port's own IK results put in JAX's lane order
(``solve_fn``).

Tolerances: IK solutions atol 1e-3 rad (25-30 damped Newton iterations
amplify float32 rounding; measured ~1e-4); collision potentials atol 1e-4;
masks, kept sets and indices exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.models import panda as jpanda
from omg_planner_tpu.ops import ik as jik
from omg_planner_tpu.planner import goal_set as jgs
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.ops import ik as tik
from omg_planner_torch.planner import goal_set as tgs
from test_golden import CFG

torch.set_num_threads(2)

Q_TOL = 1e-3
ATOL = 1e-4


def T(a):
    return torch.as_tensor(np.array(a))


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def staged():
    js = JScene.synthetic(CFG, scene_id=5, n_obstacles=2)
    env = js.env
    jp = env.cost_params()
    poses = env.grasp_poses_world().astype(np.float32)
    start = np.asarray(js.start, np.float32)
    lo, hi = js.model.soft_limits(CFG.soft_joint_limit_padding)
    seeds = np.concatenate([start[None, :7],
                            jgs.ANCHOR_SEEDS[:CFG.ik_seed_num, :7]])
    return dict(
        js=js, poses=poses, start=start, seeds=seeds.astype(np.float32),
        lo=np.asarray(lo), hi=np.asarray(hi),
        obj_pos=env.target.pose_mat[:3, 3].astype(np.float32),
        tmodel=interop.panda_model(jax.tree.map(np.asarray, js.model), "cpu"),
        tscene=interop.scene(jax.tree.map(np.asarray, env.scene_sdf()),
                             "cpu"),
        tparams=interop.cost_params(jax.tree.map(np.asarray, jp), "cpu"))


def _jax_solve(st, cfg):
    lo, hi = st["lo"], st["hi"]
    out = jax.jit(lambda m, p, s: jik.solve_goal_set(
        m, cfg, p, s, lo[:7], hi[:7]))(
            st["js"].model, jnp.asarray(st["poses"]), jnp.asarray(st["seeds"]))
    return [np.asarray(x) for x in out]


def _torch_solve(st, cfg):
    out = tik.solve_goal_set(st["tmodel"], tcfg(cfg), T(st["poses"]),
                             T(st["seeds"]), T(st["lo"][:7]),
                             T(st["hi"][:7]))
    return [x.numpy() for x in out]


def _by_lane(res, n_lanes):
    """(valid [B], reach [B, tail, 9], standoff [B, 9]) indexed by the
    original (grasp, seed) lane."""
    reach, standoff, valid, lane = res
    v = np.zeros(n_lanes, bool)
    r = np.zeros((n_lanes,) + reach.shape[1:], np.float32)
    s = np.zeros((n_lanes, 9), np.float32)
    v[lane], r[lane], s[lane] = valid, reach, standoff
    return v, r, s


@pytest.mark.parametrize("fused", [True, False])
def test_solve_goal_set_per_lane(staged, fused):
    cfg = CFG.replace(ik_chain_fused=fused)
    jr, tr = _jax_solve(staged, cfg), _torch_solve(staged, cfg)
    n_lanes = len(staged["poses"]) * len(staged["seeds"])
    # every lane survives the cap here: both lists are permutations
    assert sorted(tr[3]) == sorted(jr[3]) == list(range(n_lanes))
    jv, jreach, jstand = _by_lane(jr, n_lanes)
    tv, treach, tstand = _by_lane(tr, n_lanes)
    np.testing.assert_array_equal(tv, jv)
    assert 50 < jv.sum() < n_lanes  # some lanes succeed, some fail
    np.testing.assert_allclose(treach[jv], jreach[jv], atol=Q_TOL)
    np.testing.assert_allclose(tstand[jv], jstand[jv], atol=Q_TOL)


def test_fused_chain_matches_scanned_chain_in_port():
    """The port's fused chain against its scanned chain, the scanned side
    pinned explicitly (``ik_chain_fused=False``) so that the test does not
    compare the fused chain with itself.  Per-lane stage advancement stops
    each lane at its own convergence instant, so solutions agree to the
    solver's tolerance, not bit for bit."""
    model = interop.panda_model(jax.tree.map(np.asarray, jpanda.load_panda()),
                                "cpu")
    cfg = TConfig()
    lo, hi = model.soft_limits(cfg.soft_joint_limit_padding)
    rng = np.random.default_rng(17)
    base = np.array([[0.0, -0.8, 0.0, -2.0, 0.0, 1.6, 0.785, 0.04, 0.04],
                     [0.3, -1.0, 0.2, -2.2, 0.1, 1.5, 0.5, 0.04, 0.04]])
    qs = np.concatenate([base, base + rng.normal(size=(2, 9)) * 0.15,
                         base + rng.normal(size=(2, 9)) * 0.15])
    qs[:, 7:] = 0.04
    grasps = tgs.panda.hand_pose_batch(model, T(qs.astype(np.float32)))
    seeds = T(qs[:3, :7].astype(np.float32))
    r_scan = tik.solve_goal_set(model, cfg.replace(ik_chain_fused=False),
                                grasps, seeds, lo[:7], hi[:7])
    r_fused = tik.solve_goal_set(model, cfg.replace(ik_chain_fused=True),
                                 grasps, seeds, lo[:7], hi[:7])
    n = grasps.shape[0] * seeds.shape[0]
    v_scan, reach_scan, _ = _by_lane([x.numpy() for x in r_scan], n)
    v_fused, reach_fused, _ = _by_lane([x.numpy() for x in r_fused], n)
    np.testing.assert_array_equal(v_scan, v_fused)
    assert v_scan.sum() >= n // 2
    d = np.abs(reach_scan - reach_fused)[v_scan].max()
    assert d < 5e-3, d


def test_ik_batch_and_single(staged):
    """``ik_batch`` with its convergence exit and stall gate, and the
    single-pose solver, on the far standoffs of the first grasps."""
    st = staged
    poses, seeds = st["poses"][:8], np.tile(st["seeds"][:2], (4, 1))
    lo, hi = st["lo"][:7], st["hi"][:7]
    jres = jax.jit(lambda m, t, s: jik.ik_batch(m, t, s, CFG, lo, hi))(
        st["js"].model, jnp.asarray(poses), jnp.asarray(seeds))
    tres = tik.ik_batch(st["tmodel"], T(poses), T(seeds), tcfg(CFG), T(lo),
                        T(hi))
    np.testing.assert_array_equal(tres.success.numpy(),
                                  np.asarray(jres.success))
    ok = np.asarray(jres.success)
    assert ok.any()
    np.testing.assert_allclose(tres.q.numpy()[ok], np.asarray(jres.q)[ok],
                               atol=Q_TOL)
    for i in np.nonzero(ok)[0][:2]:
        js1 = jik.ik_single(st["js"].model, jnp.asarray(poses[i]),
                            jnp.asarray(seeds[i]), CFG, lo, hi)
        ts1 = tik.ik_single(st["tmodel"], T(poses[i]), T(seeds[i]),
                            tcfg(CFG), T(lo), T(hi))
        assert bool(ts1.success) == bool(js1.success)
        np.testing.assert_allclose(ts1.q.numpy(), np.asarray(js1.q),
                                   atol=Q_TOL)


def test_solve_standoff_chain(staged):
    st = staged
    lo, hi = st["lo"][:7], st["hi"][:7]
    tail = CFG.reach_tail_length
    offs = np.tile(np.eye(4, dtype=np.float32), (tail, 1, 1))
    offs[:, 2, 3] = -CFG.standoff_dist * np.arange(tail) / tail
    for g in (0, 3):
        stand = np.einsum("ab,kbc->kac", st["poses"][g], offs)
        jout = jik.solve_standoff_chain(
            st["js"].model, jnp.asarray(st["poses"][g]), jnp.asarray(stand),
            jnp.asarray(st["seeds"][0]), CFG, lo, hi)
        tout = tik.solve_standoff_chain(
            st["tmodel"], T(st["poses"][g]), T(stand), T(st["seeds"][0]),
            tcfg(CFG), T(lo), T(hi))
        assert bool(tout[2]) == bool(jout[2])
        for a, b in zip(tout[:2], jout[:2]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=Q_TOL)


def _downstream_jax(st, reach, standoff, valid):
    js = st["js"]
    scene, params = js.env.scene_sdf(), js.env.cost_params()

    def f(reach, standoff, valid):
        fr, _ = jgs.flip_wrist(reach, CFG)
        fs, ok1 = jgs.flip_wrist(standoff, CFG)
        reach = jnp.concatenate([reach, fr])
        standoff = jnp.concatenate([standoff, fs])
        valid = jnp.concatenate([valid, valid & ok1])
        valid = jgs.task_space_filter(js.model, CFG, jnp.asarray(st["start"]),
                                      reach, valid)
        pruned, pot = jgs.collision_prune(js.model, scene, params, CFG,
                                          standoff, valid)
        kept = jgs.diversity_dedupe(standoff, pruned, mode="rounds")
        kept_scan = jgs.diversity_dedupe(standoff, pruned, mode="scan")
        return standoff, valid, pruned, pot, kept, kept_scan

    return [np.asarray(x) for x in jax.jit(f)(reach, standoff, valid)]


def _downstream_torch(st, reach, standoff, valid):
    cfg, model = tcfg(CFG), st["tmodel"]
    reach, standoff, valid = T(reach), T(standoff), T(valid)
    fr, _ = tgs.flip_wrist(reach, cfg)
    fs, ok1 = tgs.flip_wrist(standoff, cfg)
    reach = torch.cat([reach, fr])
    standoff = torch.cat([standoff, fs])
    valid = torch.cat([valid, valid & ok1])
    valid = tgs.task_space_filter(model, cfg, T(st["start"]), reach, valid)
    pruned, pot = tgs.collision_prune(model, st["tscene"], st["tparams"], cfg,
                                      standoff, valid)
    kept = tgs.diversity_dedupe(standoff, pruned, mode="rounds")
    kept_scan = tgs.diversity_dedupe(standoff, pruned, mode="scan")
    return [x.numpy() for x in (standoff, valid, pruned, pot, kept,
                                kept_scan)]


def test_filter_prune_dedupe_stages(staged):
    """Augmentation, task-space filter, collision prune and both dedupe
    modes on the same IK output (JAX's)."""
    reach, standoff, valid, _ = _jax_solve(staged, CFG)
    j = _downstream_jax(staged, reach, standoff, valid)
    t = _downstream_torch(staged, reach, standoff, valid)
    np.testing.assert_allclose(t[0], j[0], atol=1e-6)   # flipped configs
    for name, a, b in zip(("filter", "prune"), t[1:3], j[1:3]):
        np.testing.assert_array_equal(a, b, name)
    assert j[1].sum() > j[2].sum() > 0  # the prune removes some lanes
    np.testing.assert_allclose(t[3], j[3], atol=ATOL)
    np.testing.assert_array_equal(t[4], j[4])
    np.testing.assert_array_equal(t[5], j[5])
    np.testing.assert_array_equal(t[4], t[5])  # rounds == scan
    assert 0 < j[4].sum() < j[2].sum()


def test_dedupe_rejects_unknown_mode():
    """The JAX package falls back to "scan" for an unknown mode string;
    the port raises."""
    c = torch.zeros(3, 9)
    with pytest.raises(ValueError):
        tgs.diversity_dedupe(c, torch.ones(3, dtype=torch.bool), mode="rund")


@pytest.mark.parametrize("n_valid", [5, 30])
def test_sample_goals_with_jax_noise(n_valid):
    """Below the capacity the sample is the valid set whatever the draw;
    above it, the same Gumbel noise picks the same lanes."""
    rng = np.random.default_rng(n_valid)
    valid = np.zeros(40, bool)
    valid[rng.choice(40, n_valid, replace=False)] = True
    key = jax.random.PRNGKey(n_valid)
    jidx, jmask = jgs.sample_goals(key, jnp.asarray(valid), 12)
    noise = np.asarray(jax.random.gumbel(key, (40,)))
    tidx, tmask = tgs.sample_goals(T(noise), T(valid), 12)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(tidx.numpy()[tmask.numpy()],
                                  np.asarray(jidx)[np.asarray(jmask)])


def test_upsampling_matches_jax(staged):
    poses = staged["poses"][:6]
    obj = staged["obj_pos"]
    jz = np.asarray(jgs.z_upsample_poses(jnp.asarray(poses), jnp.asarray(obj)))
    tz = tgs.z_upsample_poses(T(poses), T(obj)).numpy()
    np.testing.assert_allclose(tz, jz, atol=1e-5)
    jy = np.asarray(jgs.y_upsample_poses(jnp.asarray(poses)))
    ty = tgs.y_upsample_poses(T(poses)).numpy()
    np.testing.assert_allclose(ty, jy, atol=1e-5)


def _jax_key():
    """The key ``PlanningScene.build_goal_set`` hands the JAX goal-set function."""
    return jax.random.split(jax.random.PRNGKey(233))[1]


def test_build_goal_set_matches_jax(staged):
    """The whole build with the port's own IK (put in JAX's lane order) and
    JAX's Gumbel noise: same valid mask, same goals, same potentials; and
    the initial-goal policy picks the same goal."""
    st = staged
    js = st["js"]
    jgoal = jax.tree.map(np.asarray, js.build_problem().goal_set)
    jlanes = _jax_solve(st, CFG)[3]

    def solve_in_jax_order(*args, **kw):
        reach, standoff, valid, lanes = tik.solve_goal_set(*args, **kw)
        pos = torch.argsort(lanes)[T(jlanes)]
        return reach[pos], standoff[pos], valid[pos], lanes[pos]

    key = _jax_key()

    def gumbel_fn(tag, n):
        k = jax.random.fold_in(key, 0x9d5) if tag == "prune" else key
        return T(np.asarray(jax.random.gumbel(k, (n,))))

    cfg = tcfg(CFG)
    tgoal = tgs.build_goal_set(
        st["tmodel"], cfg, st["tscene"], st["tparams"], T(st["poses"]),
        torch.ones(len(st["poses"]), dtype=torch.bool), T(st["start"]),
        obj_pos=T(st["obj_pos"]), gumbel_fn=gumbel_fn,
        solve_fn=solve_in_jax_order)
    np.testing.assert_array_equal(tgoal.mask.numpy(), jgoal.mask)
    assert jgoal.mask.sum() == CFG.goal_set_max_num
    np.testing.assert_allclose(tgoal.grasps.numpy(), jgoal.grasps, atol=Q_TOL)
    np.testing.assert_allclose(tgoal.reach_grasps.numpy(), jgoal.reach_grasps,
                               atol=Q_TOL)
    np.testing.assert_allclose(tgoal.potentials.numpy(), jgoal.potentials,
                               atol=ATOL)
    for goal_idx in (-1, 3):
        c = CFG.replace(goal_idx=goal_idx)
        j = int(jgs.goal_idx_policy(c, jax.tree.map(jnp.asarray, jgoal),
                                    jnp.asarray(st["start"])))
        t = int(tgs.goal_idx_policy(tcfg(c), tgoal, T(st["start"])))
        assert t == j


def test_port_scene_builds_its_own_goal_set():
    """The port's own staging (``PlanningScene.synthetic`` on the CPU,
    drawing from its generator) yields a full goal set of valid,
    in-limit, collision-pruned goals.  (The wrist flip checks only the
    standoff against the soft limit, as the reference does, so a grasp
    may sit between the soft and the hard limit.)"""
    from omg_planner_torch.planner.scene import PlanningScene as TScene

    scene = TScene.synthetic(tcfg(CFG), scene_id=5, n_obstacles=2,
                             device="cpu")
    goal = scene.build_goal_set()
    assert int(goal.mask.sum()) == CFG.goal_set_max_num
    lo, hi = scene.model.joint_lower, scene.model.joint_upper
    g = goal.grasps[goal.mask]
    assert bool(((g >= lo - 1e-4) & (g <= hi + 1e-4)).all())
    assert torch.isfinite(goal.potentials).all()


@pytest.mark.parametrize("mode", ["fast", "history", "warm_start",
                                  "goal_mask", "dynamic_horizon",
                                  "fixed_goal"])
def test_precomputed_goals_scene_plans_like_jax(staged, mode):
    """``set_precomputed_goals`` (the CLI's ``-g scene`` mode, standoff
    off): with no IK draw in the way, each package stages the scene itself
    (analytic scene, cost parameters, goal policy, spline) and plans it
    through ``PlanningScene.step`` -- both loops, a warm start from a
    given trajectory, a goal-mask override, the dynamic horizon, and the
    fixed-goal plan without goal-set projection (``goal_set_proj=False``,
    which ignores the goals).  Goal,
    verdict, steps and trajectory agree (traj atol 2e-3, as
    ``tests/test_golden.py``)."""
    from omg_planner_torch.planner.scene import PlanningScene as TScene

    goal = jax.tree.map(np.asarray, staged["js"].build_problem().goal_set)
    goals = goal.grasps[goal.mask]
    cfg = CFG.replace(use_standoff=False,
                      dynamic_timestep=mode == "dynamic_horizon",
                      goal_set_proj=mode != "fixed_goal")
    js = JScene.synthetic(cfg, scene_id=5, n_obstacles=2)
    ts = TScene.synthetic(tcfg(cfg), scene_id=5, n_obstacles=2,
                          device="cpu")
    js.set_precomputed_goals(goals)
    ts.set_precomputed_goals(goals)
    kw = {"fast": mode != "history"}
    if mode == "warm_start":
        rng = np.random.default_rng(4)
        traj = js.step(fast=True).traj
        kw["traj_init"] = (traj + rng.normal(scale=0.05, size=traj.shape)
                           * np.r_[np.ones(7), 0, 0]).astype(np.float32)
    if mode == "goal_mask":
        kw["goal_mask"] = np.arange(CFG.goal_set_max_num) % 3 != 0
    jres, tres = js.step(**kw), ts.step(**kw)
    assert tres.traj.shape == jres.traj.shape
    if mode == "dynamic_horizon":
        assert ts.cfg.timesteps == js.cfg.timesteps != CFG.timesteps
    if mode == "goal_mask":
        assert kw["goal_mask"][int(tres.goal_idx)]
    assert int(tres.goal_idx) == int(jres.goal_idx)
    assert bool(tres.flag) == bool(jres.flag)
    assert int(tres.steps_used) == int(jres.steps_used)
    np.testing.assert_allclose(tres.traj, jres.traj, atol=2e-3)
