"""The port's scene batches on the CPU: the scene-batched goal-set build
(``plan_pipelined(build_batch > 1)`` over ``runner.prebuild_goal_sets``)
and the lockstep batched plan (``parallel.batch.plan_batch_vmap``),
against the port's per-scene paths and against the JAX package; and the
``snap=True`` form of ``ops.sdf.bake_world_potential_analytic``.

Config: ``tests/test_parallel.py``'s batch config (``CFG`` below: 8 + 3
steps, goal cap 10, 2 anchor seeds, 25 IK iterations, analytic).

Against the port's per-scene paths (atol 1e-5, goal, verdict and steps
equal):
* ``plan_pipelined(build_batch=2)`` over synthetic scenes 0, 3 and 5 (a
  wave of 2 and a tail of 1) against ``build_batch=0``;
* the batched build's goal sets against each scene's own build, masks
  equal, at configs above the goal cap (the sample draw decides which
  goals are kept: another seed keeps others), one scene's grasp database
  cut to 30 so that the wave pads; the configs cover the fused chain with
  a per-scene whole-chain budget (survivor cap 100: the cut scene's 90
  lanes run unbudgeted), the scanned chain with the ``increment_iks``
  second pass, and a prune-cap compaction that some scenes make and the
  cut one does not; and a placement wave (targets attached, the placement
  pose z-upsampled) through ``scene.goal_set_batch``;
* the scene-batched IK: ``ik_batch(num_scenes=S)`` against per-scene
  calls (one exit gate per scene), and ``solve_goal_set_batch`` against
  per-scene ``solve_goal_set`` for the fused and the scanned chain (the
  fused chain's flattened lanes advance as in separate solves);
* ``plan_batch_vmap`` over suite scenes 0-4 against per-scene
  ``plan_fast``, with the in-plan blacklist every second step from step
  2: the scenes end at different steps and the blacklist fires in some
  (both asserted), for each learner algorithm; and on the grid backends
  (baked, exact, fused world field) over suite scenes 0-1.

Against the JAX package (traj atol 2e-3, goal, verdict and steps equal):
* the batched build and its plans: JAX's ``plan_pipelined(build_batch=2)``
  against the port's over synthetic scenes 0, 3 and 5.  Randomness and
  lane order follow ``tests/test_torch_goal_set.py``: the port's build
  draws JAX's Gumbel noise (every scene's key is the same, and every
  scene's database has 48 grasps, so JAX's padded draws are the per-scene
  ones), and its IK lanes are put in the order of JAX's vmapped solve
  (converged lanes tie at float rounding).  Goal sets: masks equal,
  grasps within the IK bar of 1e-3 rad;
* ``plan_batch_vmap`` on JAX-staged problems of suite scenes 0-4 against
  JAX's ``plan_batch_vmap``, freezing and the blacklist exercised;
* ``bake_world_potential_analytic(snap=True)`` against JAX's on suite
  scene 1: atol 1e-5 (the bar of ``tests/test_torch_grid.py``).
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from omg_planner_tpu.config import OMGConfig
from omg_planner_tpu.ops import ik as jik
from omg_planner_tpu.ops import sdf as jsdf
from omg_planner_tpu.parallel import batch as jbatch
from omg_planner_tpu.planner import runner as jrunner
from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.ops import ik as tik
from omg_planner_torch.ops import sdf as tsdf
from omg_planner_torch.parallel import batch as tbatch
from omg_planner_torch.planner import goal_set as tgs
from omg_planner_torch.planner import runner as trunner
from omg_planner_torch.planner.plan import plan_fast
from omg_planner_torch.planner.scene import PlanningScene as TScene
from omg_planner_torch.planner.scene import goal_set_batch
from omg_planner_torch.utils.sync import SYNCS

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE = os.path.join(ROOT, "data", "suite_v2")
CFG = OMGConfig(silent=True, optim_steps=8, extra_smooth_steps=3,
                goal_set_max_num=10, ik_seed_num=2, ik_max_iters=25,
                learner_interp_steps=8, sdf_analytic=True)
# the in-plan blacklist due every second step from step 2
BL_CFG = CFG.replace(inplan_blacklist_step=2, inplan_blacklist_every=2)
SIDS = (0, 3, 5)
PLAN_SIDS = (0, 1, 2, 3, 4)
TOL = 1e-5
JAX_TOL = 2e-3
IK_TOL = 1e-3   # the IK bar of tests/test_torch_goal_set.py
BUILD_CFGS = {
    "fused_budget": dict(ik_survivor_cap=100),
    "scanned_increment": dict(ik_chain_fused=False, increment_iks=True,
                              goal_set_max_num=60),
    "prune_cap": dict(ik_two_stage=False, goal_prune_cap=200,
                      dedupe_mode="scan"),
}


def tcfg(cfg):
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def _port_scenes(cfg, sids=SIDS, cut=None, seed=233):
    out = []
    for sid in sids:
        sc = TScene.synthetic(cfg, scene_id=sid, n_obstacles=2,
                              device="cpu")
        sc.gen.manual_seed(seed)
        if sid == cut:
            sc.env.target.grasps_poses = sc.env.target.grasps_poses[:30]
        out.append((sid, sc))
    return out


def _same_plan(a, b, tol):
    assert int(a.goal_idx) == int(b.goal_idx)
    assert bool(a.flag) == bool(b.flag)
    assert int(a.steps_used) == int(b.steps_used)
    np.testing.assert_allclose(np.asarray(a.traj), np.asarray(b.traj),
                               atol=tol, rtol=0)


def test_pipelined_build_batch_matches_per_scene(monkeypatch):
    cfg = tcfg(CFG)
    built = {}
    prebuild = trunner.prebuild_goal_sets

    def spy(scenes, *a, **kw):
        prebuild(scenes, *a, **kw)
        built.update({sid: sc._staged[1] for sid, sc in scenes
                      if sc._staged_fresh})

    monkeypatch.setattr(trunner, "prebuild_goal_sets", spy)

    def run(build_batch):
        scenes = _port_scenes(cfg)
        out = [res for _, _, res, _ in trunner.plan_pipelined(
            scenes, cfg, depth=2, build_batch=build_batch)]
        return scenes, out

    _, plain = run(0)
    assert not built
    scenes, batched = run(2)
    # every scene's plan went through its prebuilt goal set
    assert sorted(built) == sorted(SIDS)
    for sid, sc in scenes:
        assert sc._staged[1] is built[sid]
        assert not sc._staged_fresh
    assert len(plain) == len(batched) == len(SIDS)
    for a, b in zip(plain, batched):
        _same_plan(b, a, TOL)


@pytest.mark.parametrize("name", sorted(BUILD_CFGS))
def test_batched_build_matches_per_scene(name):
    cfg = tcfg(CFG.replace(**BUILD_CFGS[name]))
    cap = cfg.goal_set_max_num
    own = _port_scenes(cfg, cut=3)
    sets = []
    for _, sc in own:
        sc.build_problem(assume_goals=True)
        sets.append(sc._staged[1])
    scenes = _port_scenes(cfg, cut=3)
    trunner.prebuild_goal_sets(scenes, cfg, scenes[0][1].model, 2,
                               max(len(sc.env.objects) for _, sc in scenes))
    assert len(scenes[1][1].env.grasp_poses_world()) == 30
    for (sid, sc), ref in zip(scenes, sets):
        got = sc._staged[1]
        assert sc._staged_fresh
        assert torch.equal(got.mask, ref.mask), sid
        for f in ("grasps", "reach_grasps", "potentials"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       getattr(ref, f).numpy(), atol=TOL,
                                       rtol=0, err_msg=f"{sid} {f}")
        # each generator advanced as the scene's own build advanced it
        assert torch.equal(sc.gen.get_state(), own[SIDS.index(sid)][1]
                           .gen.get_state())
    if cfg.increment_iks:
        # the second pass runs for some scenes of the wave only: the cut
        # scene's first pass falls short of the cap, the others' do not
        model, grasps, seeds, valid, n_grasps, _ = _lane_inputs(cfg, cut=3)
        lo, hi = model.soft_limits(cfg.soft_joint_limit_padding)
        first = tik.solve_goal_set_batch(model, cfg, grasps, seeds, lo[:7],
                                         hi[:7], n_grasps,
                                         grasp_valid=valid)[2].sum(1)
        assert (first < cap).tolist() == [False, True, False]
        return
    # above the cap: the goal sets are full and another seed keeps other
    # goals
    assert all(int(ref.mask.sum()) == cap for ref in sets)
    other = _port_scenes(cfg, sids=(0,), seed=7)[0][1]
    other.build_problem(assume_goals=True)
    assert not torch.equal(other._staged[1].grasps, sets[0].grasps)


def test_goal_set_batch_attached_z_up():
    """A placement wave (targets attached, the placement pose z-upsampled
    by 50 bins): ``scene.goal_set_batch`` against each scene's own
    ``build_goal_set``."""
    cfg = tcfg(CFG)

    def attached():
        scenes = [sc for _, sc in _port_scenes(cfg, sids=(0, 3))]
        for sc in scenes:
            sc.attach_target(np.array(sc.start))
        return scenes

    own = [sc.build_goal_set() for sc in attached()]
    scenes = attached()
    n_obj = max(len(sc.env.objects) for sc in scenes)
    poses = np.stack([sc.env.grasp_poses_world() for sc in scenes])
    got = goal_set_batch(
        scenes[0].model, cfg,
        tbatch._stack([tbatch.pad_scene(sc.env.scene_sdf(), n_obj)
                       for sc in scenes]),
        tbatch._stack([tbatch._pad_cost_params(
            sc.env.cost_params(), n_obj - len(sc.env.objects))
            for sc in scenes]),
        torch.as_tensor(poses, dtype=torch.float32),
        torch.ones(poses.shape[:2], dtype=torch.bool), [1, 1],
        torch.as_tensor(np.stack([sc.start for sc in scenes]),
                        dtype=torch.float32),
        [sc.gen for sc in scenes],
        torch.as_tensor(np.stack([sc.env.target.pose_mat[:3, 3]
                                  for sc in scenes]), dtype=torch.float32),
        attached=True, z_up=True)
    for i, ref in enumerate(own):
        assert int(ref.mask.sum()) > 0
        assert torch.equal(got.mask[i], ref.mask)
        np.testing.assert_allclose(got.grasps[i].numpy(), ref.grasps.numpy(),
                                   atol=TOL, rtol=0)


def _lane_inputs(cfg, cut=None):
    """Stacked (grasps, seeds, valid, n_grasps) of synthetic scenes 0, 3,
    5 padded to one database, and the per-scene unpadded inputs."""
    scenes = _port_scenes(cfg, cut=cut)
    model = scenes[0][1].model
    per = []
    for _, sc in scenes:
        g = torch.as_tensor(sc.env.grasp_poses_world(), dtype=torch.float32)
        start = torch.as_tensor(sc.start, dtype=torch.float32)
        seeds = torch.cat([start[None, :7], torch.as_tensor(
            tgs.ANCHOR_SEEDS[:cfg.ik_seed_num, :7], dtype=torch.float32)])
        per.append((g, seeds))
    n = max(len(g) for g, _ in per)
    grasps = torch.eye(4).repeat(len(per), n, 1, 1)
    valid = torch.zeros((len(per), n), dtype=torch.bool)
    for i, (g, _) in enumerate(per):
        grasps[i, :len(g)] = g
        valid[i, :len(g)] = True
    seeds = torch.stack([s for _, s in per])
    return model, grasps, seeds, valid, [len(g) for g, _ in per], per


def test_ik_batch_per_scene_gate():
    """Three scenes' lanes, each seeded at its own distance from reachable
    targets, so their gates close at different iterations."""
    cfg = tcfg(CFG)
    model = _port_scenes(cfg, sids=(0,))[0][1].model
    lo, hi = model.soft_limits(cfg.soft_joint_limit_padding)
    gen = torch.Generator().manual_seed(0)
    q_true = lo[:7] + (hi[:7] - lo[:7]) * (
        0.3 + 0.4 * torch.rand((3, 16, 7), generator=gen))
    tgts = tgs.panda.hand_pose_batch(model, torch.cat(
        [q_true, torch.full((3, 16, 2), 0.04)], -1).reshape(-1, 9))
    tgts = tgts.reshape(3, 16, 4, 4)
    starts = [q_true[i] + scale * torch.randn((16, 7), generator=gen)
              for i, scale in enumerate((0.02, 0.2, 0.5))]
    single, iters = [], []
    for t, s in zip(tgts, starts):
        s0 = SYNCS.count    # one host read per iteration, and the last
        single.append(tik.ik_batch(model, t, s, cfg, lo[:7], hi[:7]))
        iters.append(SYNCS.count - s0 - 1)
    assert iters[0] < iters[2] < cfg.ik_max_iters
    s0 = SYNCS.count
    batched = tik.ik_batch(model, tgts.reshape(-1, 4, 4),
                           torch.cat(starts), cfg, lo[:7], hi[:7],
                           num_scenes=3)
    assert SYNCS.count - s0 - 1 == max(iters)
    for i, res in enumerate(single):
        sl = slice(16 * i, 16 * (i + 1))
        assert torch.equal(batched.q[sl], res.q), i
        assert torch.equal(batched.success[sl], res.success), i
    # scene 0's gate closed early and its q froze: more iterations of its
    # lanes alone (a tighter tolerance) move them
    assert bool(single[0].success.all())
    more = tik.ik_batch(model, tgts[0], starts[0],
                        cfg.replace(ik_pos_tol=0.0), lo[:7], hi[:7])
    assert not torch.equal(more.q, single[0].q)


@pytest.mark.parametrize("fused", [True, False])
def test_solve_goal_set_batch_matches_per_scene(fused):
    cfg = tcfg(CFG.replace(ik_chain_fused=fused, ik_survivor_cap=100))
    model, grasps, seeds, valid, n_grasps, per = _lane_inputs(cfg, cut=3)
    lo, hi = model.soft_limits(cfg.soft_joint_limit_padding)
    reach, standoff, ok, lanes, k = tik.solve_goal_set_batch(
        model, cfg, grasps, seeds, lo[:7], hi[:7], n_grasps,
        grasp_valid=valid)
    # the cut scene solves 90 lanes, under the survivor cap: unbudgeted
    assert k == [100, 90, 100]
    for i, (g, s) in enumerate(per):
        r1, s1, v1, l1 = tik.solve_goal_set(model, cfg, g, s, lo[:7],
                                            hi[:7])
        assert torch.equal(lanes[i, :k[i]], l1)
        assert torch.equal(ok[i, :k[i]], v1)
        assert not ok[i, k[i]:].any()
        np.testing.assert_allclose(reach[i, :k[i]].numpy(), r1.numpy(),
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(standoff[i, :k[i]].numpy(), s1.numpy(),
                                   atol=TOL, rtol=0)


def _suite_problems(cfg, sids=PLAN_SIDS):
    probs = []
    for sid in sids:
        sc = TScene.from_npz(cfg, os.path.join(SUITE, f"scene_{sid}.npz"),
                             device="cpu")
        probs.append(sc.build_problem())
    n_obj = max(p.cost_params.inv_poses.shape[0] for p in probs)
    return sc.model, [tbatch.pad_objects(p, n_obj) for p in probs]


def _fired(res, probs):
    """Per scene: did the in-plan blacklist narrow the goal mask?"""
    return [bool((np.asarray(m) != np.asarray(p.goal_set.mask)).any())
            for m, p in zip(res.goal_mask, probs)]


@pytest.mark.parametrize("alg", ["MD", "FTL", "Exp", "Proj"])
def test_plan_batch_vmap_matches_plan_fast(alg):
    cfg = tcfg(BL_CFG.replace(ol_alg=alg))
    model, probs = _suite_problems(cfg)
    batched = tbatch.plan_batch_vmap(model, cfg,
                                     tbatch.stack_problems(probs))
    for i, p in enumerate(probs):
        single = plan_fast(model, cfg, p)
        _same_plan(tbatch._index(batched, i), single, TOL)
        assert torch.equal(batched.goal_mask[i], single.goal_mask)
    # freezing: the scenes end at different steps
    assert len(set(batched.steps_used.tolist())) > 1
    if alg != "Proj":   # the blacklist needs the learner
        assert any(_fired(batched, probs))


@pytest.mark.parametrize("backend", ["baked", "exact", "fused"])
def test_plan_batch_vmap_on_grid_backends(backend):
    """The grid backends (voxel stacks padded to one shape) and the fused
    world field batch too."""
    kw = dict(baked=dict(), exact=dict(sdf_baked=False),
              fused=dict(sdf_fused=True, world_field_resolution=0.04))
    cfg = tcfg(BL_CFG.replace(sdf_analytic=False, **kw[backend]))
    scenes = [(sid, TScene.from_npz(cfg, os.path.join(
        SUITE, f"scene_{sid}.npz"), device="cpu")) for sid in (0, 1)]
    pad_to, n_obj = trunner.suite_shapes(scenes)
    probs = []
    for _, sc in scenes:
        sc.env.stage_scene(pad_to)
        probs.append(tbatch.pad_objects(sc.build_problem(), n_obj))
    model = scenes[0][1].model
    batched = tbatch.plan_batch_vmap(model, cfg,
                                     tbatch.stack_problems(probs))
    for i, p in enumerate(probs):
        _same_plan(tbatch._index(batched, i), plan_fast(model, cfg, p), TOL)


def test_batched_build_and_plans_match_jax(monkeypatch):
    jscenes = [(sid, JScene.synthetic(CFG, scene_id=sid, n_obstacles=2))
               for sid in SIDS]
    # every database has 48 grasps: JAX's padded draws are per-scene ones
    assert {len(sc.env.grasp_poses_world()) for _, sc in jscenes} == {48}
    jout = [res for _, _, res, _ in jrunner.plan_pipelined(
        jscenes, CFG, depth=2, build_batch=2)]
    jsets = [np_tree(sc._staged[1]) for _, sc in jscenes]
    jmodel = jscenes[0][1].model

    key = jax.random.split(jax.random.PRNGKey(233))[1]

    def gumbel_fn(i, tag, n):
        k = jax.random.fold_in(key, 0x9d5) if tag == "prune" else key
        return torch.as_tensor(np.array(jax.random.gumbel(k, (n,))))

    jsolve = jax.jit(jax.vmap(lambda g, s, lo, hi, v: jik.solve_goal_set(
        jmodel, CFG, g, s, lo, hi, grasp_valid=v)[3],
        in_axes=(0, 0, None, None, 0)))

    def solve_in_jax_order(model, cfg, grasps, seeds, lo, hi, n_grasps,
                           attached=False, grasp_valid=None):
        reach, standoff, valid, lanes, k = tik.solve_goal_set_batch(
            model, cfg, grasps, seeds, lo, hi, n_grasps, attached,
            grasp_valid=grasp_valid)
        jl = torch.as_tensor(np.array(jsolve(
            grasps.numpy(), seeds.numpy(), lo.numpy(), hi.numpy(),
            grasp_valid.numpy())))
        pos = torch.stack([torch.argsort(lanes[i])[jl[i]]
                           for i in range(len(k))])
        return (tgs._take_lanes(reach, pos), tgs._take_lanes(standoff, pos),
                torch.gather(valid, 1, pos), torch.gather(lanes, 1, pos), k)

    monkeypatch.setattr(tgs, "build_goal_set_batch", functools.partial(
        tgs.build_goal_set_batch, gumbel_fn=gumbel_fn,
        solve_fn=solve_in_jax_order))
    cfg = tcfg(CFG)
    scenes = _port_scenes(cfg)
    tout = [res for _, _, res, _ in trunner.plan_pipelined(
        scenes, cfg, depth=2, build_batch=2)]
    for (sid, sc), jset in zip(scenes, jsets):
        tset = sc._staged[1]
        np.testing.assert_array_equal(tset.mask.numpy(), jset.mask)
        np.testing.assert_allclose(tset.grasps.numpy(), jset.grasps,
                                   atol=IK_TOL, rtol=0, err_msg=str(sid))
    for tres, jres in zip(tout, jout):
        _same_plan(tres, jres, JAX_TOL)


def test_plan_batch_vmap_matches_jax():
    jprobs = [JScene.from_npz(BL_CFG, os.path.join(
        SUITE, f"scene_{sid}.npz")).build_problem() for sid in PLAN_SIDS]
    n_obj = max(p.cost_params.inv_poses.shape[0] for p in jprobs)
    jprobs = [jbatch.pad_objects(p, n_obj) for p in jprobs]
    model = JScene.from_npz(BL_CFG, os.path.join(SUITE, "scene_0.npz")).model
    jres = np_tree(jax.jit(jbatch.plan_batch_vmap, static_argnums=(1,))(
        model, BL_CFG.jit_key(), jbatch.stack_problems(jprobs)))
    tmodel = interop.panda_model(np_tree(model), "cpu")
    tprobs = [interop.plan_problem(np_tree(p), "cpu") for p in jprobs]
    tres = tbatch.plan_batch_vmap(tmodel, tcfg(BL_CFG),
                                  tbatch.stack_problems(tprobs))
    for i in range(len(PLAN_SIDS)):
        _same_plan(tbatch._index(tres, i),
                   jax.tree.map(lambda x: x[i], jres), JAX_TOL)
        np.testing.assert_array_equal(tres.goal_mask[i].numpy(),
                                      jres.goal_mask[i])
    assert len(set(tres.steps_used.tolist())) > 1
    assert any(_fired(tres, tprobs))


def test_world_potential_snap_matches_jax():
    """The parity (snapped) learner field of a primitive scene."""
    js = JScene.from_npz(CFG.replace(sdf_analytic=False),
                         os.path.join(SUITE, "scene_1.npz"))
    fields = [o.sdf for o in js.env.objects]
    p = np_tree(js.env.cost_params())
    kinds, halfs, pens, _, _, dims, limits, _ = jsdf.analytic_prim_arrays(
        fields)
    args = (kinds, halfs, pens, limits, p.inv_poses, p.epsilons,
            p.padding_scales, p.disables, dims)
    jwp = np_tree(jsdf.bake_world_potential_analytic(*args))
    twp = tsdf.bake_world_potential_analytic(
        *(torch.as_tensor(np.array(a)) for a in args))
    assert (jwp.data > 0).sum() > 1000
    np.testing.assert_allclose(twp.data.numpy(), jwp.data, atol=TOL, rtol=0)
    np.testing.assert_array_equal(twp.origin.numpy(), jwp.origin)
    # the parity form reads the object grid: not the production field
    prod = tsdf.bake_world_potential_analytic(
        *(torch.as_tensor(np.array(a)) for a in args), snap=False)
    assert not torch.equal(prod.data, twp.data)
