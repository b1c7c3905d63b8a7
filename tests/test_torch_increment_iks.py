"""``increment_iks`` (the second IK pass of the goal-set build) of the port
against the JAX package on the CPU, on synthetic scene 5 at
``tests/test_golden.py::CFG`` staged by JAX, with the goal cap above the
first pass's yield (so the second pass runs) and the survivor cap above
its 480 lanes (so both packages keep every lane).

* Reseed: from the first pass in JAX's lane order and JAX's own Gumbel
  draw, the port picks JAX's 10 reseed configurations (atol 1e-3 rad, the
  first pass's per-lane bar in ``tests/test_torch_goal_set.py``).
* Second solve, from JAX's reseeds, lane by lane.  A reseed is another
  grasp's solution, so the damped-Newton path is long and branches at
  joint limits and stall exits: a lane's outcome is decided by rounding.
  JAX against itself with the seeds moved by one ulp differs on 10 of 480
  lanes' validity and 3 solutions beyond 1e-3 rad; the port against JAX
  on 3 and 4 (measured).  Bars: valid masks equal on at least 98% of the
  lanes, and on at least 97% of the lanes valid in both the solutions
  within 1e-4 rad.
* The whole build, with the port's IK put in JAX's lane order for the
  first pass (the lane-order fault of ``ROADMAP.md`` section 3) and JAX's
  second solve handed in: masks equal, goals within 1e-3 rad, potentials
  within 1e-4.
* With the goal cap filled by the first pass the second solve is skipped
  (one host read) and zero invalid lanes of its shape are appended."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.ops import ik as jik
from omg_planner_tpu.planner import goal_set as jgs
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.ops import ik as tik
from omg_planner_torch.planner import goal_set as tgs
from omg_planner_torch.utils.sync import SYNCS
from test_golden import CFG

torch.set_num_threads(2)

Q_TOL = 1e-3
# a goal cap above the first pass's yield, so the second pass runs, and a
# survivor cap above its 480 lanes, so both packages keep every lane
INC_CFG = CFG.replace(increment_iks=True, goal_set_max_num=200,
                      ik_survivor_cap=512)


def T(a):
    return torch.as_tensor(np.array(a))


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


@pytest.fixture(scope="module")
def staged():
    js = JScene.synthetic(CFG, scene_id=5, n_obstacles=2)
    env = js.env
    start = np.asarray(js.start, np.float32)
    lo, hi = (np.asarray(a) for a in
              js.model.soft_limits(CFG.soft_joint_limit_padding))
    seeds = np.concatenate([start[None, :7],
                            jgs.ANCHOR_SEEDS[:CFG.ik_seed_num, :7]])
    return dict(
        js=js, poses=env.grasp_poses_world().astype(np.float32),
        start=start, seeds=seeds.astype(np.float32), lo=lo, hi=hi,
        obj_pos=env.target.pose_mat[:3, 3].astype(np.float32),
        tmodel=interop.panda_model(jax.tree.map(np.asarray, js.model), "cpu"),
        tscene=interop.scene(jax.tree.map(np.asarray, env.scene_sdf()),
                             "cpu"),
        tparams=interop.cost_params(
            jax.tree.map(np.asarray, env.cost_params()), "cpu"))


def _jax_solve(st, seeds):
    lo, hi = st["lo"][:7], st["hi"][:7]
    out = jax.jit(lambda m, p, s: jik.solve_goal_set(
        m, INC_CFG, p, s, lo, hi))(st["js"].model, jnp.asarray(st["poses"]),
                                   jnp.asarray(seeds))
    return [np.asarray(x) for x in out]


def _by_lane(res, n_lanes):
    reach, standoff, valid, lane = res
    v = np.zeros(n_lanes, bool)
    s = np.zeros((n_lanes, standoff.shape[1]), np.float32)
    v[lane], s[lane] = valid, standoff
    return v, s


def test_second_pass_matches_jax(staged):
    st = staged
    key = jax.random.split(jax.random.PRNGKey(233))[1]
    key2, sub = jax.random.split(key)
    noise = {"increment": sub, "prune": jax.random.fold_in(key2, 0x9d5),
             "sample": key2}
    first = _jax_solve(st, st["seeds"])
    n_first = len(first[2])
    assert first[2].sum() < INC_CFG.goal_set_max_num  # the pass runs
    # JAX's reseed configurations, as its build_goal_set picks them
    g = np.asarray(jax.random.gumbel(sub, (n_first,)))
    top = np.argsort(-np.where(first[2], g, -np.inf), kind="stable")[:10]
    extra_j = np.where(first[2][top][:, None], first[1][top][:, :7],
                       st["seeds"][0][None]).astype(np.float32)
    second = _jax_solve(st, extra_j)
    seen = []

    def solve_fn(model, cfg, poses, seeds, *a, **kw):
        """First pass: the port's IK in JAX's lane order; second: JAX's."""
        seen.append(seeds.clone())
        if len(seen) == 2:
            return tuple(T(x) for x in second)
        reach, standoff, valid, lane = tik.solve_goal_set(
            model, cfg, poses, seeds, *a, **kw)
        pos = torch.argsort(lane)[T(first[3])]
        return reach[pos], standoff[pos], valid[pos], lane[pos]

    def gumbel_fn(tag, n):
        return T(np.asarray(jax.random.gumbel(noise[tag], (n,))))

    cfg = tcfg(INC_CFG)
    s0 = SYNCS.count
    tgoal = tgs.build_goal_set(
        st["tmodel"], cfg, st["tscene"], st["tparams"], T(st["poses"]),
        torch.ones(len(st["poses"]), dtype=torch.bool), T(st["start"]),
        obj_pos=T(st["obj_pos"]), gumbel_fn=gumbel_fn, solve_fn=solve_fn)
    assert len(seen) == 2 and SYNCS.count > s0
    np.testing.assert_allclose(seen[1].numpy(), extra_j, atol=Q_TOL)
    jgoal = jax.tree.map(np.asarray, jax.jit(
        lambda m, sc, p, po, s: jgs.build_goal_set(
            m, INC_CFG, sc, p, po, jnp.ones(po.shape[0], bool), s, key,
            obj_pos=jnp.asarray(st["obj_pos"])))(
        st["js"].model, st["js"].env.scene_sdf(),
        st["js"].env.cost_params(), jnp.asarray(st["poses"]),
        jnp.asarray(st["start"])))
    np.testing.assert_array_equal(tgoal.mask.numpy(), jgoal.mask)
    assert jgoal.mask.sum() > CFG.goal_set_max_num
    np.testing.assert_allclose(tgoal.grasps.numpy(), jgoal.grasps,
                               atol=Q_TOL)
    np.testing.assert_allclose(tgoal.potentials.numpy(), jgoal.potentials,
                               atol=1e-4)

    # the port's second solve from JAX's reseeds, lane by lane
    n2 = len(st["poses"]) * 10
    t2 = tik.solve_goal_set(st["tmodel"], cfg, T(st["poses"]), T(extra_j),
                            T(st["lo"][:7]), T(st["hi"][:7]))
    jv, jsol = _by_lane(second, n2)
    tv, tsol = _by_lane([x.numpy() for x in t2], n2)
    both = jv & tv
    assert both.sum() > 200
    assert (tv != jv).mean() <= 0.02, (tv != jv).sum()
    far = np.abs(tsol[both] - jsol[both]).max(1) > 1e-4
    assert far.mean() <= 0.03, far.sum()
    # JAX's own spread: the same solve with the seeds one ulp away
    pv, _ = _by_lane(_jax_solve(
        st, np.nextafter(extra_j, np.float32(np.inf))), n2)
    assert (pv != jv).sum() > 0


def test_full_first_pass_skips_second(staged):
    st = staged
    cfg = tcfg(CFG.replace(increment_iks=True))
    calls = []

    def solve(*a, **kw):
        calls.append(1)
        return tik.solve_goal_set(*a, **kw)

    gen = torch.Generator().manual_seed(0)
    n_lanes = []

    def gumbel_fn(tag, n):
        n_lanes.append((tag, n))
        return tgs.gumbel_noise(gen, n, "cpu")

    goal = tgs.build_goal_set(
        st["tmodel"], cfg, st["tscene"], st["tparams"], T(st["poses"]),
        torch.ones(len(st["poses"]), dtype=torch.bool), T(st["start"]),
        gumbel_fn=gumbel_fn, solve_fn=solve)
    assert calls == [1]
    assert int(goal.mask.sum()) == CFG.goal_set_max_num
    k = tik.solve_lanes(cfg, len(st["poses"]), len(st["seeds"]))
    k2 = tik.solve_lanes(cfg, len(st["poses"]), 10)
    # first pass + the skipped pass's zero lanes, then the wrist flip
    assert n_lanes[0] == ("increment", k)
    assert n_lanes[-1] == ("sample", n_lanes[-1][1])
    assert ("prune", 2 * (k + k2)) in n_lanes or 2 * (k + k2) <= \
        cfg.goal_prune_cap
