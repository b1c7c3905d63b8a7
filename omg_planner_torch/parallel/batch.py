"""Scale-out: batched and goal-sharded planning (counterpart of
``omg_planner_tpu/parallel/batch.py``).

The JAX package's axes of scale are **scenes** and **goals** on a 2-D
``Mesh(('scene', 'goal'))``.  Here the mesh is a ``torch.distributed``
process group with one process per device (``parallel/multihost.py``):
rank r sits at scene row ``r // goal_parallel`` and goal column
``r % goal_parallel``, and the ranks of a row form its goal group.

  * :func:`plan_batch`: ``plan_fast`` over a stacked scene batch, one
    scene after another (JAX's is a sequential ``lax.map``).
  * :func:`make_sharded_plan`: each rank plans its row's scenes with the
    learner's full candidate sweep sharded over the goal group and
    reassembled with one all-gather per step.
  * :func:`make_sharded_pipeline`: goal-set build (the IK chain lanes
    sharded over the goal group) followed by the goal-sharded plan.

Every host decision that gates a collective (the plan's termination and
blacklist, the IK chain's exit) is computed from replicated data, so it
comes out alike on every rank of a group; after each plan the ranks
compare goal, steps, verdict and a trajectory checksum and raise on any
difference, and every group carries a timeout (``multihost.py``), so a
disagreement ends in an error rather than a hang.

Also the object padding of staged problems: every scene of a suite pads
to one object count with disabled dummy objects, so the runner and the
cascade plan every scene at one set of shapes.

``plan_batch_vmap`` is not ported: the plan is an eager loop with host
reads, which cannot be vmapped.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..ops import learner as ol
from ..ops.chomp import GoalSet
from ..ops.sdf import AnalyticScene, BakedSceneSDF
from ..planner.plan import PlanProblem, PlanResult, plan, plan_fast
from ..utils.collectives import all_gather_cat, bits_checksum, check_agreement


def _num_objects(scene) -> int:
    if isinstance(scene, AnalyticScene):
        return scene.kinds.shape[0]
    return (scene.data4 if isinstance(scene, BakedSceneSDF)
            else scene.data).shape[0]


def pad_scene(scene, num_objects: int):
    """Pad a scene's object dimension with disabled dummy objects (grid
    backends fill +1 volumes; analytic scenes add far tiny primitives)."""
    extra = num_objects - _num_objects(scene)
    if extra == 0:
        return scene
    if isinstance(scene, AnalyticScene):
        def cat(a, value, shape=(extra,)):
            return torch.cat([a, torch.full(shape, value, dtype=a.dtype,
                                            device=a.device)])

        return AnalyticScene(kinds=cat(scene.kinds, 1),
                             halfs=cat(scene.halfs, 1e-3, (extra, 3)),
                             penals=cat(scene.penals, 1.0),
                             rounds=cat(scene.rounds, 0.0))
    baked = isinstance(scene, BakedSceneSDF)
    vol = scene.data4 if baked else scene.data
    if baked:
        fill = torch.zeros((extra,) + vol.shape[1:], dtype=vol.dtype,
                           device=vol.device)
        fill[..., 0] = 1.0
    else:
        fill = torch.ones((extra,) + vol.shape[1:], dtype=vol.dtype,
                          device=vol.device)
    data = torch.cat([vol, fill])
    lim = torch.cat([scene.limits, scene.limits[-1:].repeat(extra, 1)])
    return (scene._replace(data4=data, limits=lim) if baked
            else scene._replace(data=data, limits=lim))


def _pad_cost_params(cp, extra: int):
    """Disabled dummy entries for every per-object parameter array."""
    def pad1(a, v):
        return torch.cat([a, torch.full((extra,), v, dtype=a.dtype,
                                        device=a.device)])

    eye = torch.eye(4, dtype=cp.inv_poses.dtype, device=cp.inv_poses.device)
    return cp._replace(
        inv_poses=torch.cat([cp.inv_poses, eye[None].repeat(extra, 1, 1)]),
        epsilons=pad1(cp.epsilons, 0.2),
        padding_scales=pad1(cp.padding_scales, 1.0),
        clearances=pad1(cp.clearances, 0.0),
        disables=pad1(cp.disables, 1.0))


def pad_objects(problem: PlanProblem, num_objects: int) -> PlanProblem:
    """Pad a problem's object dimension with disabled dummy objects."""
    extra = num_objects - _num_objects(problem.scene)
    if extra == 0:
        return problem
    return problem._replace(
        scene=pad_scene(problem.scene, num_objects),
        cost_params=_pad_cost_params(problem.cost_params, extra))


# ---------------------------------------------------------------------------
# stacked scene batches
# ---------------------------------------------------------------------------

def _stack(trees: Sequence):
    """Stack matching NamedTuple trees of tensors on a new leading axis;
    None stays None, host numbers become a CPU tensor."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return torch.stack(list(trees))
    if hasattr(first, "_fields"):
        return type(first)(*(_stack(xs) for xs in zip(*trees)))
    return torch.tensor(list(trees))


def _index(tree, i: int):
    """Entry ``i`` of a stacked tree."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return type(tree)(*(_index(x, i) for x in tree))


def _batch_size(tree) -> int:
    while not isinstance(tree, torch.Tensor):
        tree = next(x for x in tree if x is not None)
    return tree.shape[0]


def stack_problems(problems: Sequence):
    """Stack per-scene problems (or any matching NamedTuples) into one
    batch with a leading scene axis.  All must share shapes: pad scenes to
    a common object count first (:func:`pad_objects`)."""
    return _stack(list(problems))


def plan_batch(model, cfg, problems: PlanProblem) -> PlanResult:
    """``plan_fast`` over a stacked problem batch, one scene after another
    (the JAX package's sequential ``lax.map``); the results are stacked."""
    return _stack([plan_fast(model, cfg, _index(problems, i))
                   for i in range(_batch_size(problems))])


# ---------------------------------------------------------------------------
# goal-sharded plan: scenes x goals
# ---------------------------------------------------------------------------

def _plan_goal_sharded(model, cfg, problem: PlanProblem, mesh,
                       fast: bool = True) -> PlanResult:
    """The plan of ONE scene on this rank of its goal group: the single
    plan loop (``planner/plan.py``) on the whole goal set, which every
    rank holds (the port has no global array to gather it from).

    When the learner sweeps every lane (``ol.sweep_restricted`` false) the
    per-step sweep is the sharded part: ``cost_vector_raw`` over this
    rank's contiguous slice on G (what JAX's ``P('scene', 'goal')``
    sharding hands a device), one all-gather, and ``finalize_cost_vector``
    on the whole vector with the current mask.  Under the active-lane
    restriction (the default) the sweep touches only K lanes and runs
    replicated.  The ranks' results are then compared.  Raises
    ``ValueError`` when the group size does not divide G, as JAX's
    sharding does (on every rank alike, before any collective, so no rank
    waits on the others)."""
    gs = problem.goal_set
    g = gs.grasps.shape[0]
    if g % mesh.goal_parallel:
        raise ValueError(f"goal capacity {g} is not divisible by the goal "
                         f"group size {mesh.goal_parallel}")
    per = g // mesh.goal_parallel
    lo = mesh.goal_col * per
    gs_local = GoalSet(*(a[lo:lo + per] for a in gs))
    group = mesh.goal_group
    hp = cfg.horizon().on(problem.start.device)

    def cv_fn(traj, t, mask):
        raw = ol.cost_vector_raw(
            model, problem.scene, problem.cost_params, cfg, hp, traj,
            gs_local, t, problem.world_potential)
        return ol.finalize_cost_vector(cfg, all_gather_cat(raw, group), mask)

    cv = None if ol.sweep_restricted(cfg, gs.capacity) else cv_fn
    loop = plan_fast if fast else plan
    res = loop(model, cfg, problem, cv_fn=cv)
    check_agreement(torch.stack([
        res.goal_idx.long(), res.steps_used.long(), res.flag.long(),
        bits_checksum(res.traj)]), group, "goal-sharded plan")
    return res


def make_sharded_plan(mesh, model, cfg, fast: bool = True):
    """The (scenes x goals)-sharded batch planner for this rank.

    Input: the stacked problems of this rank's scene row, the whole goal
    set on every rank; each rank sweeps its contiguous slice on G.
    Raises ``ValueError`` when G is not divisible by the goal group size,
    as JAX's sharding does.  Returns the row's stacked ``PlanResult``, the
    same on every rank of the row, equal in semantics to
    :func:`plan_batch` on the same problems."""

    def call(problems: PlanProblem) -> PlanResult:
        return _stack([
            _plan_goal_sharded(model, cfg, _index(problems, i), mesh, fast)
            for i in range(_batch_size(problems))])

    return call


# ---------------------------------------------------------------------------
# goal-sharded end-to-end pipeline: goal-set build (IK) + plan
# ---------------------------------------------------------------------------

def solve_goal_set_sharded(model, cfg, grasps, seeds, lower7, upper7,
                           attached=False, grasp_valid=None, group=None):
    """``ops.ik.solve_goal_set`` with the standoff-chain lanes sharded over
    ``group``: the prefilter and the survivor ranking run replicated, the
    chain's convergence exit is synced, and the output lanes match the
    single-process solve in count, order and (to float tolerance) value.
    A drop-in ``solve_fn`` for ``planner.goal_set.build_goal_set``."""
    from ..ops import ik as ik_ops

    return ik_ops.solve_goal_set(model, cfg, grasps, seeds, lower7, upper7,
                                 attached, grasp_valid=grasp_valid,
                                 group=group)


class PipelineInput(NamedTuple):
    """Per-scene inputs of the pipeline: a PlanProblem whose goal_set, end
    and traj_init are placeholders (the pipeline builds them), the grasp
    DB in the world, and the seed of the goal set's Gumbel draws (JAX's
    ``key``).  The draws come from a host ``torch.Generator`` made from
    the seed, as ``PlanningScene`` makes its own, so every rank of a row
    draws the same bits on any device."""

    problem: PlanProblem
    grasps_world: torch.Tensor          # [N, 4, 4]
    grasp_valid: torch.Tensor           # [N] bool
    seed: int
    obj_pos: torch.Tensor | None = None  # [3] target position (grip)


def scene_pipeline_input(scene, seed: int, num_objects: int | None = None,
                         num_grasps: int | None = None) -> PipelineInput:
    """The pipeline's input for a ``PlanningScene``: its staged collision
    scene, cost parameters, limits and learner field, an empty placeholder
    goal set, the target's world grasps (padded to ``num_grasps`` with
    invalid identity poses) and position.  ``num_objects`` pads the
    objects, so that the scenes of one batch stack."""
    from ..planner.plan import init_trajectory

    cfg, env, d = scene.cfg, scene.env, scene.device
    start = torch.as_tensor(np.asarray(scene.start, np.float32), device=d)
    g, dof = cfg.goal_set_max_num, start.shape[0]
    placeholder = GoalSet(
        grasps=torch.zeros((g, dof), device=d),
        reach_grasps=torch.zeros((g, cfg.reach_tail_length, dof), device=d),
        mask=torch.zeros(g, dtype=torch.bool, device=d),
        potentials=torch.zeros(g, device=d))
    lo, hi = scene.model.soft_limits(cfg.soft_joint_limit_padding)
    problem = PlanProblem(
        start=start, end=start, traj_init=init_trajectory(cfg, start, start),
        goal_set=placeholder, scene=env.scene_sdf(),
        cost_params=env.cost_params(), joint_lower=lo, joint_upper=hi,
        world_potential=scene._world_potential(),
        world_field=scene._world_field())
    if num_objects is not None:
        problem = pad_objects(problem, num_objects)
    gw = np.asarray(env.grasp_poses_world(), np.float32)
    n = len(gw) if num_grasps is None else num_grasps
    gw_pad = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    gw_pad[:len(gw)] = gw
    valid = np.arange(n) < len(gw)
    return PipelineInput(
        problem=problem, grasps_world=torch.as_tensor(gw_pad, device=d),
        grasp_valid=torch.as_tensor(valid, device=d), seed=int(seed),
        obj_pos=torch.as_tensor(
            np.asarray(env.target.pose_mat[:3, 3], np.float32), device=d))


def make_sharded_pipeline(mesh, model, cfg, attached: bool = False,
                          fast: bool = True):
    """The whole per-scene pipeline for this rank: the goal-set build
    (the IK chain lanes sharded over the goal group, the filter, prune
    and sample replicated), then the goal-sharded plan on the built goal
    set.  ``mesh=None`` runs the same pipeline in
    one process (the plain IK and ``plan_fast``).

    Input: a stacked :class:`PipelineInput` batch of this rank's scene
    row (``host_local_batch``).  Returns the stacked ``PlanResult``.

    (JAX's pipeline hands the replicated goal set to its goal-sharded
    plan, which gathers it again, so its plan sees every goal once per
    goal shard; this one plans on the built set as it is, so the sharded
    pipeline equals the single-process one.)"""
    from ..planner import goal_set as gs_mod
    from ..planner.plan import init_trajectory

    group = None if mesh is None else mesh.goal_group
    solve = (None if group is None else
             functools.partial(solve_goal_set_sharded, group=group))

    def one(inp: PipelineInput) -> PlanResult:
        pr = inp.problem
        gen = torch.Generator().manual_seed(int(inp.seed))
        gset = gs_mod.build_goal_set(
            model, cfg, pr.scene, pr.cost_params, inp.grasps_world,
            inp.grasp_valid, pr.start, gen=gen, attached=attached,
            obj_pos=inp.obj_pos, solve_fn=solve)
        end = gset.grasps[gs_mod.goal_idx_policy(cfg, gset, pr.start)]
        pr = pr._replace(goal_set=gset, end=end,
                         traj_init=init_trajectory(cfg, pr.start, end))
        if group is None:
            return (plan_fast if fast else plan)(model, cfg, pr)
        return _plan_goal_sharded(model, cfg, pr, mesh, fast)

    def call(inps: PipelineInput) -> PlanResult:
        return _stack([one(_index(inps, i))
                       for i in range(_batch_size(inps))])

    return call
