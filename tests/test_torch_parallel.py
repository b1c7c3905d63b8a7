"""The port's scale-out (``omg_planner_torch/parallel/batch.py``) against
its own single-process path and the JAX package on the CPU, at
``tests/test_parallel.py::_cfg`` widths.

JAX runs in this process on its CPU devices.  The port's goal-sharded
ranks are two spawned gloo processes (``parallel/launch.py``, goal group
of 2), started once for the module with a time limit; their results come
back as files in ``tmp_path``.

Cases:
* ``plan_batch``: bit for bit the per-problem ``plan_fast``; against JAX's
  ``plan_batch_jit`` on the same staged problems the same ``goal_idx``,
  ``flag`` and ``steps_used``, ``traj`` within 2e-3 (the bar of
  ``tests/test_torch_plan.py``);
* the goal-sharded plan with JAX's blacklist configuration
  (``tests/test_parallel.py:85-89``, the blacklist fires), unrestricted
  (active goals 0: the per-step all-gather) and restricted (4): against
  the port's single-process ``plan_fast`` ``traj`` within 1e-6 and
  ``goal_idx``, ``steps_used`` and ``goal_mask`` equal; against JAX's
  ``plan_fast`` within 2e-3 with ``goal_idx`` and ``flag`` equal;
* the sharded two-stage IK solve, fused and scanned chain, with 17
  survivors over two ranks (one pad lane): ``lane_idx`` and ``valid``
  equal to the single-process solve, ``reach`` and ``standoff`` within
  1e-6; the same for the scanned chain over every lane from cold seeds
  (two-stage off), where the two ranks' lanes converge at different
  iterations, so only the synced exit keeps them equal; each also
  against JAX's ``solve_goal_set_sharded`` over a two-device goal mesh
  (lane for lane from cold seeds; on the lanes both keep in two-stage,
  whose survivor ranking ties at float rounding), within the IK bar of
  ``tests/test_torch_goal_set.py``, 1e-3 rad;
* the whole sharded pipeline (IK goal-set build, then the goal-sharded
  plan) on a JAX-staged ``PipelineInput`` carried across by
  ``interop.pipeline_input``: equal to the port's one-process pipeline
  (``goal_idx``, ``flag``, ``steps_used`` and ``goal_mask`` equal,
  ``traj`` within 1e-6);
* ``make_sharded_plan`` rejects a goal capacity that the group size does
  not divide.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from omg_planner_tpu.parallel import batch as jbatch
from omg_planner_tpu.planner import plan as jplan
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.ops import ik as tik
from omg_planner_torch.parallel import batch as tbatch
from omg_planner_torch.parallel import launch
from omg_planner_torch.parallel.multihost import SceneMesh
from omg_planner_torch.planner import plan as tplan
from test_parallel import _cfg

torch.set_num_threads(2)

ACTIVE_GOALS = (0, 4)
# chain variants: fused and scanned two-stage; scanned from cold seeds
CHAINS = ("fused", "scanned", "scanned_cold")
SPAWN_TIMEOUT_S = 240
IK_TOL = 1e-3   # the IK bar of tests/test_torch_goal_set.py


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def blacklist_cfg(active_goals):
    return _cfg().replace(
        optim_steps=6, extra_smooth_steps=2,
        inplan_blacklist_step=2, inplan_blacklist_every=2,
        inplan_blacklist_radius=0.05, allow_collision_point=-1,
        learner_active_goals=active_goals)


def ik_cfg(chain):
    if chain == "scanned_cold":
        return _cfg().replace(ik_two_stage=False, ik_seed_num=3,
                              ik_chain_fused=False)
    return _cfg().replace(ik_two_stage=True, ik_survivor_cap=17,
                          ik_prefilter_iters=6, ik_seed_num=3,
                          ik_chain_fused=chain == "fused")


@pytest.fixture(scope="module")
def staged():
    """JAX-staged inputs and their port counterparts."""
    model, _ = ge._tiny_problem(_cfg())
    tmodel = interop.panda_model(np_tree(model), "cpu")
    plans = {}
    for ag in ACTIVE_GOALS:
        cfg = blacklist_cfg(ag)
        _, prob = ge._tiny_problem(cfg)
        plans[ag] = dict(cfg=cfg, jprob=prob,
                         tprob=interop.plan_problem(np_tree(prob), "cpu"))
    _, _, prob, grasps_world = ge._tiny_problem(ik_cfg("fused"),
                                                real_grasps=True)
    lo, hi = model.soft_limits(_cfg().soft_joint_limit_padding)
    seeds = (np.tile(np.asarray(prob.start)[None, :7], (3, 1))
             + 0.2 * np.random.default_rng(1).normal(size=(3, 7)))
    ik = dict(grasps=torch.tensor(np.asarray(grasps_world)),
              seeds=torch.as_tensor(seeds, dtype=torch.float32),
              lower7=torch.tensor(np.asarray(lo[:7])),
              upper7=torch.tensor(np.asarray(hi[:7])),
              grasp_valid=torch.ones(grasps_world.shape[0], dtype=torch.bool))
    _, env, prob, grasps_world = ge._tiny_problem(_cfg(), real_grasps=True)
    jinp = jbatch.PipelineInput(
        problem=prob, grasps_world=grasps_world,
        grasp_valid=jnp.ones(grasps_world.shape[0], bool),
        key=jax.random.PRNGKey(0),
        obj_pos=jnp.asarray(env.target.pose_mat[:3, 3], jnp.float32))
    pipe = dict(jinp=jinp, tinp=interop.pipeline_input(np_tree(jinp), 5,
                                                       "cpu"))
    return dict(model=model, tmodel=tmodel, plans=plans, ik=ik, pipe=pipe)


@pytest.fixture(scope="module")
def sharded(staged, tmp_path_factory):
    """Every sharded case in one spawn of two gloo ranks (goal group 2);
    returns both ranks' results."""
    calls = {}
    for ag, p in staged["plans"].items():
        calls[f"plan{ag}"] = (
            "omg_planner_torch.parallel.launch:plan_job",
            dict(model=staged["tmodel"], cfg=tcfg(p["cfg"]),
                 problems=tbatch.stack_problems([p["tprob"]])))
    for chain in CHAINS:
        calls[f"solve_{chain}"] = (
            "omg_planner_torch.parallel.launch:solve_job",
            dict(model=staged["tmodel"], cfg=tcfg(ik_cfg(chain)),
                 **staged["ik"]))
    calls["pipeline"] = (
        "omg_planner_torch.parallel.launch:pipeline_job",
        dict(model=staged["tmodel"], cfg=tcfg(_cfg()),
             inputs=tbatch.stack_problems([staged["pipe"]["tinp"]])))
    runs = launch.spawn("omg_planner_torch.parallel.launch:jobs", 2,
                        str(tmp_path_factory.mktemp("ranks")),
                        goal_parallel=2, kwargs=dict(calls=calls),
                        device="cpu", timeout=SPAWN_TIMEOUT_S)
    return launch.check(runs)


def _check_same(tres, jres):
    jres = np_tree(jres)
    assert int(tres.goal_idx) == int(jres.goal_idx)
    assert bool(tres.flag) == bool(jres.flag)
    assert int(tres.steps_used) == int(jres.steps_used)
    np.testing.assert_allclose(tres.traj.numpy(), jres.traj, atol=2e-3)


def test_plan_batch_matches_plan_fast_and_jax():
    cfg = _cfg()
    jprobs = [JScene.synthetic(cfg, scene_id=sid,
                               n_obstacles=2).build_problem()
              for sid in (0, 3)]
    n_obj = max(p.cost_params.inv_poses.shape[0] for p in jprobs)
    jprobs = [jbatch.pad_objects(p, n_obj) for p in jprobs]
    model = JScene.synthetic(cfg, scene_id=0, n_obstacles=2).model
    tmodel = interop.panda_model(np_tree(model), "cpu")
    tprobs = [interop.plan_problem(np_tree(p), "cpu") for p in jprobs]

    tres = tbatch.plan_batch(tmodel, tcfg(cfg),
                             tbatch.stack_problems(tprobs))
    jres = jbatch.plan_batch_jit(model, cfg, jbatch.stack_problems(jprobs))
    assert tres.traj.shape == (2, cfg.timesteps, 9)
    for i, tprob in enumerate(tprobs):
        single = tplan.plan_fast(tmodel, tcfg(cfg), tprob)
        for a, b in zip(jax.tree.leaves(tbatch._index(tres, i)),
                        jax.tree.leaves(single)):
            assert torch.equal(a, b)
        _check_same(single, jax.tree.map(lambda x: x[i], jres))


@pytest.mark.parametrize("active_goals", ACTIVE_GOALS)
def test_sharded_plan_matches_single_process_and_jax(staged, sharded,
                                                     active_goals):
    p = staged["plans"][active_goals]
    cfg = p["cfg"]
    rank0, rank1 = (r[f"plan{active_goals}"] for r in sharded)
    for a, b in zip(jax.tree.leaves(rank0), jax.tree.leaves(rank1)):
        assert torch.equal(a, b)
    res = tbatch._index(rank0, 0)

    single = tplan.plan_fast(staged["tmodel"], tcfg(cfg), p["tprob"])
    np.testing.assert_allclose(res.traj.numpy(), single.traj.numpy(),
                               atol=1e-6)
    assert int(res.goal_idx) == int(single.goal_idx)
    assert int(res.steps_used) == int(single.steps_used)
    assert torch.equal(res.goal_mask, single.goal_mask)

    jres = jax.jit(jplan.plan_fast, static_argnums=(1,))(
        staged["model"], cfg.jit_key(), p["jprob"])
    # the blacklist fired
    assert (np.asarray(jres.goal_mask).sum()
            < np.asarray(p["jprob"].goal_set.mask).sum())
    _check_same(res, jres)
    np.testing.assert_array_equal(res.goal_mask.numpy(),
                                  np.asarray(jres.goal_mask))


def _jax_solve_sharded(model, cfg, ik):
    """JAX's ``solve_goal_set_sharded`` over a two-device goal mesh."""
    from jax.sharding import Mesh, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:2]), ("goal",))
    lo, hi = (jnp.asarray(ik[k].numpy()) for k in ("lower7", "upper7"))
    fn = jax.jit(jax.shard_map(
        lambda g, s, v: jbatch.solve_goal_set_sharded(
            model, cfg, g, s, lo, hi, grasp_valid=v, axis="goal"),
        mesh=mesh, in_specs=(P(), P(), P()), out_specs=P(),
        check_vma=False))
    out = fn(*(jnp.asarray(ik[k].numpy())
               for k in ("grasps", "seeds", "grasp_valid")))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("chain", CHAINS)
def test_solve_goal_set_sharded_matches_single(staged, sharded, chain):
    ik = staged["ik"]
    cfg = tcfg(ik_cfg(chain))
    single = tik.solve_goal_set(
        staged["tmodel"], cfg, ik["grasps"], ik["seeds"], ik["lower7"],
        ik["upper7"], grasp_valid=ik["grasp_valid"])
    k = tik.solve_lanes(cfg, ik["grasps"].shape[0], ik["seeds"].shape[0])
    if chain != "scanned_cold":
        assert k == 17  # odd over two ranks: one pad lane
    for out in (r[f"solve_{chain}"] for r in sharded):
        for a, b, name in zip(single, out,
                              ("reach", "standoff", "valid", "lane_idx")):
            assert a.shape == b.shape, name
            if name in ("valid", "lane_idx"):
                assert torch.equal(a, b), name
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6,
                                           err_msg=name)
    assert int(single[2].sum()) > 0

    # against JAX's goal-sharded solve on the same inputs
    reach, standoff, valid, lanes = (
        x.numpy() for x in sharded[0][f"solve_{chain}"])
    jreach, jstand, jvalid, jlanes = _jax_solve_sharded(
        staged["model"], ik_cfg(chain), ik)
    assert lanes.shape == jlanes.shape
    if chain == "scanned_cold":
        # every lane is chained, in lane order: equal lane for lane
        np.testing.assert_array_equal(lanes, jlanes)
        np.testing.assert_array_equal(valid, jvalid)
        # failed lanes hold wherever their iterations stopped
        np.testing.assert_allclose(reach[valid], jreach[valid], atol=IK_TOL)
        np.testing.assert_allclose(standoff[valid], jstand[valid],
                                   atol=IK_TOL)
        return
    # two-stage: the survivors are ranked by prefilter errors that tie at
    # float rounding (``tests/test_torch_goal_set.py``'s lane-order note),
    # so the two packages keep different lanes; the lanes both keep agree
    common, ti, ji = np.intersect1d(lanes, jlanes, return_indices=True)
    assert len(common) > 0
    np.testing.assert_array_equal(valid[ti], jvalid[ji])
    ok = valid[ti]
    np.testing.assert_allclose(reach[ti][ok], jreach[ji][ok], atol=IK_TOL)
    np.testing.assert_allclose(standoff[ti][ok], jstand[ji][ok], atol=IK_TOL)
    assert valid.sum() == jvalid.sum()


def test_sharded_pipeline_matches_one_process(staged, sharded):
    jinp, tinp = staged["pipe"]["jinp"], staged["pipe"]["tinp"]
    for a, b in zip(jax.tree.leaves(tinp.problem),
                    jax.tree.leaves(jinp.problem)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for name in ("grasps_world", "grasp_valid", "obj_pos"):
        np.testing.assert_array_equal(getattr(tinp, name).numpy(),
                                      np.asarray(getattr(jinp, name)))
    assert tinp.seed == 5
    rank0, rank1 = (r["pipeline"] for r in sharded)
    for a, b in zip(jax.tree.leaves(rank0), jax.tree.leaves(rank1)):
        assert torch.equal(a, b)
    one = tbatch.make_sharded_pipeline(None, staged["tmodel"], tcfg(_cfg()))(
        tbatch.stack_problems([tinp]))
    for name in ("goal_idx", "flag", "steps_used", "goal_mask"):
        assert torch.equal(getattr(rank0, name), getattr(one, name)), name
    np.testing.assert_allclose(rank0.traj.numpy(), one.traj.numpy(),
                               atol=1e-6)
    assert int(one.goal_mask.sum()) > 0


def test_make_sharded_plan_rejects_indivisible_goal_set(staged):
    p = staged["plans"][0]
    g = p["tprob"].goal_set.grasps.shape[0]
    mesh = SceneMesh(rank=0, world=3, scene_row=0, goal_col=0,
                     goal_parallel=3, goal_group=None,
                     device=torch.device("cpu"))
    assert g % 3
    fn = tbatch.make_sharded_plan(mesh, staged["tmodel"], tcfg(p["cfg"]))
    with pytest.raises(ValueError, match="not divisible"):
        fn(tbatch.stack_problems([p["tprob"]]))
