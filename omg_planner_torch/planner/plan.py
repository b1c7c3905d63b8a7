"""The OMG plan loop (counterpart of ``omg_planner_tpu/planner/plan.py``;
reference ``omg/planner.py:600-653``).

Per iteration: online-learner goal update (first ``optim_steps`` only,
every ``learner_sweep_every``-th step), one CHOMP step with goal-set
projection, joint-limit smoothing, early termination; plus the JAX
package's in-plan goal blacklist restarts and executable-state snapshot.

The loop is a Python loop.  The step count, the learner cadence and the
blacklist schedule are host integers; what depends on data is read on the
host: the termination flag once per step, and the blacklist trigger on
the steps where it is due.  The terminating step's update is rolled back
(``omg/planner.py:627-636``).  On a card, ``plan_fast`` replays its later
steps' updates as CUDA graphs, captured once a plan
(``_GraphedUpdates``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import OMGConfig, schedule_weights
from ..ops import chomp
from ..ops import learner as ol
from ..ops.chomp import CostInfo, CostParams, GoalSet
from ..ops.sdf import WorldField, WorldPotential
from ..utils import graphs, timing
from ..utils.graphs import GRAPHS
from ..utils.linalg import top_k
from ..utils.spline import cubic_interpolate, linear_interpolate
from ..utils.sync import host_bool, host_bools
from ..utils.vmap import vmap_scenes


class PlanProblem(NamedTuple):
    """Everything a single plan needs, as tensors on one device (D is the
    model's dof: 9 for the Panda)."""

    start: torch.Tensor        # [D]
    end: torch.Tensor          # [D] staged initial goal
    traj_init: torch.Tensor    # [T, D]
    goal_set: GoalSet
    scene: object              # AnalyticScene | BakedSceneSDF | SceneSDF
    cost_params: CostParams
    joint_lower: torch.Tensor  # [D] soft limits
    joint_upper: torch.Tensor  # [D]
    world_potential: WorldPotential  # learner scoring field
    # scene-fused CHOMP collision field (cfg.sdf_fused; None = the
    # per-object query)
    world_field: WorldField | None = None


class PlanResult(NamedTuple):
    traj: torch.Tensor          # [T, D] final trajectory
    goal_idx: torch.Tensor
    info: CostInfo              # final-step info
    info_history: CostInfo      # stacked [S] (plan) / final info (plan_fast)
    history: torch.Tensor       # [S, T, D]
    selected_goals: torch.Tensor  # [S]
    steps_used: torch.Tensor
    flag: torch.Tensor          # True => SUCCESS ("BE GENTLE")
    goal_mask: torch.Tensor | None = None


class _Carry(NamedTuple):
    traj: torch.Tensor
    goal_idx: torch.Tensor
    learner: ol.LearnerState
    step: int
    done: bool
    last_info: CostInfo
    goal_mask: torch.Tensor
    sched0: int
    exec_traj: torch.Tensor | None = None
    exec_ok: torch.Tensor | None = None
    exec_info: CostInfo | None = None


def _where_tree(cond, a, b):
    """Elementwise select over two matching NamedTuples of tensors."""
    return type(a)(*(torch.where(cond, x, y) for x, y in zip(a, b)))


def _chosen_goal(cfg: OMGConfig, goal_set: GoalSet, goal_idx):
    """(termination goal [D], projection tail [k, D]), gathered on the
    device (indexing with the 0-d ``goal_idx`` would read it on the
    host)."""
    idx = goal_idx.reshape(1)
    grasp = goal_set.grasps.index_select(0, idx)[0]
    tail = goal_set.reach_grasps.index_select(0, idx)[0] \
        if cfg.use_standoff else grasp[None]
    return grasp, tail


def _evaluate(model, cfg, hp, problem: PlanProblem, traj, goal_idx, step):
    """Cost/gradient/termination evaluation at ``traj`` on step ``step``
    of the cost schedule."""
    return _evaluate_w(model, cfg, hp, problem, traj, goal_idx,
                       schedule_weights(cfg, step + 1))


def _evaluate_w(model, cfg, hp, problem: PlanProblem, traj, goal_idx,
                weights):
    """:func:`_evaluate` with the schedule's weights given (a pure tensor
    function, which ``torch.func.vmap`` batches over scenes)."""
    return _chomp_update(model, cfg, hp, problem, traj, goal_idx, weights)[1]


def _chomp_update(model, cfg, hp, problem: PlanProblem, traj, goal_idx,
                  weights):
    """One CHOMP step before the joint-limit smoothing: (trajectory, info),
    the info's ``terminate`` false where the limits are violated (a pure
    tensor function, which ``torch.func.vmap`` batches).  FK, the query,
    then the ``chomp_obstacle`` and ``chomp_step`` kernels."""
    return chomp.chomp_step(*_chomp_args(model, cfg, hp, problem, traj,
                                         goal_idx, weights))


def _chomp_args(model, cfg, hp, problem: PlanProblem, traj, goal_idx,
                weights) -> tuple:
    """The goal, its tail and the obstacle terms: the arguments of
    ``chomp.chomp_step`` and of ``chomp.chomp_step_packed``, whose packed
    info a captured update selects into the snapshot with two ``out=``
    selects (:class:`_GraphedUpdates`)."""
    obstacle_w, smooth_w, _, step_size = weights
    if cfg.goal_set_proj:
        goal, tail = _chosen_goal(cfg, problem.goal_set, goal_idx)
    else:
        goal, tail = problem.end, problem.end[None]
    obs = chomp.compute_collision_loss(
        model, problem.scene, problem.cost_params, cfg, hp, traj,
        problem.start, goal,
        world_field=problem.world_field if cfg.sdf_fused else None)
    return (model, cfg, hp, traj, problem.start, goal, tail, obs,
            (obstacle_w, smooth_w, step_size), problem.joint_lower,
            problem.joint_upper)


def _optimize_once(model, cfg, hp, problem: PlanProblem, traj, goal_idx,
                   step):
    """One CHOMP step (``omg/optimizer.py:115-135``)."""
    new_traj, info = _chomp_update(model, cfg, hp, problem, traj, goal_idx,
                                   schedule_weights(cfg, step + 1))
    new_traj = chomp.handle_joint_limit(
        hp, cfg, new_traj, problem.joint_lower, problem.joint_upper)
    return new_traj, info


def _init_goal_idx(cfg, problem: PlanProblem):
    """The staged initial goal: the goal nearest ``problem.end``."""
    if not cfg.goal_set_proj:
        return torch.tensor(0, device=problem.start.device)
    d = torch.linalg.norm(problem.goal_set.grasps - problem.end[None], dim=-1)
    d = torch.where(problem.goal_set.mask, d, torch.full_like(d, torch.inf))
    return torch.argmin(d)


def _learner_enabled(cfg: OMGConfig) -> bool:
    return cfg.goal_set_proj and cfg.ol_alg not in ("Baseline", "Proj")


def _learner_due(cfg: OMGConfig, step: int) -> bool:
    """Does the learner update on step ``step``?  (Host-side: the step
    count and the sweep cadence only.)"""
    due = _learner_enabled(cfg) and step < cfg.optim_steps
    if cfg.learner_sweep_every > 1:
        due = due and step % cfg.learner_sweep_every == 0
    return due


def _blacklist_enabled(cfg: OMGConfig) -> bool:
    return cfg.inplan_blacklist_step > 0 and _learner_enabled(cfg)


def _learner_goals(cfg: OMGConfig, problem: PlanProblem, goal_mask):
    """The goal set the learner scores: the in-plan blacklist narrows its
    mask to ``goal_mask``."""
    if _blacklist_enabled(cfg):
        return problem.goal_set._replace(mask=goal_mask)
    return problem.goal_set


def _blacklist_due(cfg: OMGConfig, step: int) -> bool:
    """Is the in-plan blacklist checked after step ``step``?  (Host-side:
    depends on the step count only.)"""
    nstep = step + 1
    first = cfg.inplan_blacklist_step
    due = nstep >= first
    if cfg.inplan_blacklist_every > 0:
        due = due and (nstep - first) % cfg.inplan_blacklist_every == 0
    else:
        due = due and nstep == first
    # the learner must still be active afterwards to re-target
    return due and nstep < cfg.optim_steps


def _inplan_blacklist(cfg: OMGConfig, problem: PlanProblem, goal_mask,
                      goal_idx, info: CostInfo):
    """On a due step: mask the chosen goal's neighborhood (arm-joint L2 <
    radius) when the plan still collides above the allowance and some goal
    survives.  Returns (new_mask, fire) with ``fire`` a 0-d bool tensor."""
    failing = info.collide > cfg.allow_collision_point
    grasps = problem.goal_set.grasps
    d = torch.linalg.norm(grasps[:, :7] - grasps[goal_idx, :7][None], dim=-1)
    new_mask = goal_mask & (d >= cfg.inplan_blacklist_radius)
    return new_mask, failing & torch.any(new_mask)


def _blacklist_restart(cfg: OMGConfig, problem: PlanProblem, mask,
                       lstate: ol.LearnerState):
    """Fresh spline to the learner's best remaining goal and a learner
    reset to uniform over the shrunken mask (the cascade's blacklist
    re-plan, in-plan).  Returns (traj, goal_idx, lstate)."""
    gs = problem.goal_set
    mf = mask.to(torch.float32)
    uniform = mf / torch.clamp(mf.sum(), min=1.0)
    new_goal = torch.argmax(torch.where(
        mask, lstate.p, torch.full_like(lstate.p, -torch.inf)))
    new_traj = cubic_interpolate(problem.start, gs.grasps[new_goal],
                                 cfg.timesteps)
    rt = lstate._replace(
        p=uniform, sum_costs=torch.zeros_like(lstate.sum_costs),
        experts_p=uniform[None].repeat(ol.NUM_EXPERTS, 1),
        experts_costs=torch.zeros_like(lstate.experts_costs),
        q=torch.ones_like(lstate.q) / ol.NUM_EXPERTS,
        t=0.0, ti=torch.zeros_like(lstate.ti))
    # active_idx / last_raw are kept, as in the JAX package
    return new_traj, new_goal, rt


def _learner_init(model, cfg, hp, problem: PlanProblem, cv_fn=None):
    """Initial goal choice + respline (reference Learner.__init__,
    online_learner.py:94-102).  A ``cv_fn`` scores the candidates instead
    of the built-in sweep, and the active lanes stay unset (the learner
    bypasses them for it)."""
    goal_idx0 = _init_goal_idx(cfg, problem)
    traj0 = problem.traj_init
    restrict = ol.sweep_restricted(cfg, problem.goal_set.capacity)
    learner0 = ol.init_learner_state(
        problem.goal_set, cfg.learner_active_goals if restrict else 0)
    if _learner_enabled(cfg):
        if cv_fn is not None:
            cv0 = cv_fn(traj0, 0.0, problem.goal_set.mask)
        else:
            raw0 = ol.cost_vector_raw(
                model, problem.scene, problem.cost_params, cfg, hp, traj0,
                problem.goal_set, 0.0, problem.world_potential)
            cv0 = ol.finalize_cost_vector(cfg, raw0, problem.goal_set.mask)
            if restrict:
                k = min(cfg.learner_active_goals, problem.goal_set.capacity)
                learner0 = learner0._replace(last_raw=raw0,
                                             active_idx=top_k(-cv0, k)[1])
        goal_idx0 = torch.argmin(cv0)
        if not cfg.warm_start_init:
            traj0 = cubic_interpolate(
                problem.start, problem.goal_set.grasps[goal_idx0],
                cfg.timesteps)
    return traj0, goal_idx0, learner0


def _dummy_info(cfg: OMGConfig, device) -> CostInfo:
    z = torch.zeros((), device=device)
    f = torch.zeros((), dtype=torch.bool, device=device)
    return CostInfo(
        cost=z, obs=z, smooth=z, weighted_obs=z, weighted_smooth=z,
        grad_norm=z, smooth_grad_norm=z, obs_grad_norm=z, collide=z,
        reach=z, terminate=f, failure_terminate=f, execute=f,
        violate_limit=f, cost_traj=torch.zeros(cfg.timesteps, device=device))


class _Updates:
    """The plan step's updates as :func:`_step` runs them, eagerly: the
    learner's update, the CHOMP update, the executable-state snapshot and
    the info of a terminating step.  :class:`_GraphedUpdates` runs them
    from CUDA graphs."""

    def __init__(self, model, cfg: OMGConfig, hp, problem: PlanProblem,
                 cv_fn=None):
        self.args = (model, cfg, hp, problem)
        self.cv_fn = cv_fn

    def learner(self, step: int, traj, goal_idx, goal_mask, lstate):
        """The learner's update on step ``step``: (state, goal index)."""
        model, cfg, hp, problem = self.args
        return ol.update_goal(
            model, problem.scene, problem.cost_params, cfg, hp, traj,
            _learner_goals(cfg, problem, goal_mask), lstate,
            problem.world_potential, cv_fn=self.cv_fn)

    def chomp(self, step: int, rel: int, traj, goal_idx, ex):
        """The CHOMP update on step ``step``, ``rel`` steps since the last
        restart, the snapshot before it ``ex``: (the trajectory the plan
        keeps if the step terminates, the updated trajectory, info)."""
        model, cfg, hp, problem = self.args
        return (traj,) + _optimize_once(model, cfg, hp, problem, traj,
                                        goal_idx, rel)

    def snapshot(self, kept, info, ex):
        """The snapshot (trajectory, ok, info) after the update."""
        ex_traj, ex_ok, ex_info = ex
        snap = info.execute
        ex_traj = torch.where(snap, kept, ex_traj)
        ex_info = _where_tree(snap, info, ex_info)
        return ex_traj, ex_ok | snap, ex_info

    def last(self, rel: int, kept, goal_idx, info) -> CostInfo:
        """The info a plan ends with when this step terminates."""
        return info

    def release(self):
        """The plan's loop is over."""


def _step(model, cfg, hp, problem: PlanProblem, carry: _Carry,
          cv_fn=None, updates: _Updates | None = None) -> _Carry:
    """One plan iteration (the body of the JAX package's loop), its
    updates run by ``updates`` (eagerly by default).

    The learner's gate (``step < optim_steps`` and the sweep cadence) is a
    host ``if`` on the step count, so every rank of a goal-sharded plan
    takes it alike and a ``cv_fn`` holding collectives may be skipped on
    the smoothing steps.  (JAX runs such a sweep unconditionally and masks
    its result, since SPMD forbids collectives inside ``lax.cond``.)"""
    if updates is None:
        updates = _Updates(model, cfg, hp, problem, cv_fn)
    with timing.span("plan.step"):
        traj, goal_idx, lstate = carry.traj, carry.goal_idx, carry.learner
        rel = carry.step - carry.sched0
        if _learner_due(cfg, carry.step):
            with timing.span("plan.learner"):
                lstate, goal_idx = updates.learner(
                    carry.step, traj, goal_idx, carry.goal_mask, lstate)
        ex = (carry.exec_traj, carry.exec_ok, carry.exec_info)
        with timing.span("plan.chomp"):
            kept, new_traj, info = updates.chomp(carry.step, rel, traj,
                                                 goal_idx, ex)
        with timing.span("plan.control"):
            if cfg.exec_snapshot:
                ex = updates.snapshot(kept, info, ex)
            fired = carry.step > 0 and host_bool(info.terminate,
                                                 "plan.terminate")
            if fired:
                info = updates.last(rel, kept, goal_idx, info)
            goal_mask, sched0 = carry.goal_mask, carry.sched0
            if (_blacklist_enabled(cfg) and not fired
                    and _blacklist_due(cfg, carry.step)):
                new_mask, fire = _inplan_blacklist(cfg, problem, goal_mask,
                                                   goal_idx, info)
                if host_bool(fire, "plan.blacklist"):
                    goal_mask = new_mask
                    new_traj, goal_idx, lstate = _blacklist_restart(
                        cfg, problem, goal_mask, lstate)
                    sched0 = carry.step + 1
        return _Carry(
            traj=kept if fired else new_traj, goal_idx=goal_idx,
            learner=lstate, step=carry.step + 1, done=fired, last_info=info,
            goal_mask=goal_mask, sched0=sched0,
            exec_traj=ex[0], exec_ok=ex[1], exec_info=ex[2])


def _init_carry(model, cfg, hp, problem: PlanProblem, cv_fn=None) -> _Carry:
    dev = problem.start.device
    with timing.span("plan.init"):
        traj0, goal_idx0, learner0 = _learner_init(model, cfg, hp, problem,
                                                   cv_fn)
        info0 = _dummy_info(cfg, dev)
    snap = cfg.exec_snapshot
    return _Carry(traj0, goal_idx0, learner0, 0, False, info0,
                  problem.goal_set.mask, 0,
                  exec_traj=traj0 if snap else None,
                  exec_ok=(torch.zeros((), dtype=torch.bool, device=dev)
                           if snap else None),
                  exec_info=info0 if snap else None)


def _finish(model, cfg, hp, problem, carry: _Carry):
    """Final info (the reference re-evaluates the final trajectory when
    the loop ran out of steps, planner.py:633-636) and the executable-state
    snapshot selection.  Returns (traj, info)."""
    with timing.span("plan.finish"):
        info = carry.last_info
        if not carry.done:
            info = _evaluate(model, cfg, hp, problem, carry.traj,
                             carry.goal_idx, carry.step - carry.sched0)
        if not cfg.exec_snapshot:
            return carry.traj, info
        use = carry.exec_ok & ~info.execute
        return (torch.where(use, carry.exec_traj, carry.traj),
                _where_tree(use, carry.exec_info, info))


def plan(model, cfg: OMGConfig, problem: PlanProblem,
         cv_fn=None) -> PlanResult:
    """Full OMG plan with per-step history (``cfg.total_steps`` entries;
    steps after termination repeat the frozen state, as the JAX package's
    scan does).  ``cv_fn(traj, t, mask) -> [G]`` optionally overrides the
    learner's candidate costs (``ops/learner.py::update_goal``); the
    goal-sharded plan (``parallel/batch.py``) runs this same loop with
    it."""
    with timing.span("plan"):
        hp = cfg.horizon().on(problem.start.device)
        carry = _init_carry(model, cfg, hp, problem, cv_fn)
        history, infos, selected = [], [], []
        for _ in range(cfg.total_steps):
            if not carry.done:
                carry = _step(model, cfg, hp, problem, carry, cv_fn)
            history.append(carry.traj)
            infos.append(carry.last_info)
            selected.append(carry.goal_idx)
        traj_out, info = _finish(model, cfg, hp, problem, carry)
        dev = problem.start.device
        return PlanResult(
            traj=traj_out, goal_idx=carry.goal_idx, info=info,
            info_history=CostInfo(*(torch.stack(f) for f in zip(*infos))),
            history=torch.stack(history),
            selected_goals=torch.stack(selected),
            steps_used=torch.tensor(carry.step, device=dev),
            flag=info.terminate, goal_mask=carry.goal_mask)


def plan_fast(model, cfg: OMGConfig, problem: PlanProblem,
              cv_fn=None, _graphs: bool = True) -> PlanResult:
    """History-free plan: early termination ends the loop (the benchmark
    path).  ``cv_fn`` as in :func:`plan`.  On a card, without ``cv_fn``,
    the later steps replay CUDA graphs (:class:`_GraphedUpdates`; the same
    plan, bit for bit); ``_graphs=False`` keeps the eager loop there."""
    with timing.span("plan"):
        hp = cfg.horizon().on(problem.start.device)
        carry = _init_carry(model, cfg, hp, problem, cv_fn)
        if _graphs and cv_fn is None and problem.start.device.type == "cuda":
            updates = _GraphedUpdates(model, cfg, hp, problem)
        else:
            updates = _Updates(model, cfg, hp, problem, cv_fn)
        try:
            while not carry.done and carry.step < cfg.total_steps:
                carry = _step(model, cfg, hp, problem, carry,
                              updates=updates)
        finally:
            updates.release()
        traj_out, info = _finish(model, cfg, hp, problem, carry)
        return PlanResult(
            traj=traj_out, goal_idx=carry.goal_idx, info=info,
            info_history=info, history=traj_out[None],
            selected_goals=carry.goal_idx[None],
            steps_used=torch.tensor(carry.step, device=problem.start.device),
            flag=info.terminate, goal_mask=carry.goal_mask)


# -- plan_fast on the card: CUDA graphs of the updates ----------------------

_LEARNER_TENSORS = tuple(f for f in ol.LearnerState._fields if f != "t")


@functools.lru_cache(maxsize=8)
def _plan_tables(cfg: OMGConfig, device: str):
    """A graphed plan's per-step constants on ``device``, made once per
    configuration by the eager loop's host arithmetic: the cost schedule
    ``[total_steps, 4]``, row ``r`` that of ``schedule_weights(cfg, r +
    1)`` (``r`` counts the steps since the last restart), and the learner
    sweep's start rows ``[optim_steps + 1]``, entry ``t`` that of
    ``ol._start_index(cfg, t)``."""
    weights = torch.stack([torch.stack(schedule_weights(cfg, r + 1))
                           for r in range(cfg.total_steps)])
    starts = torch.tensor([ol._start_index(cfg, float(t))
                           for t in range(cfg.optim_steps + 1)])
    return weights.to(device), starts.to(device)


#: A graphed plan's first steps run eagerly: a plan that ends at step 1
#: (about half of the suite's) pays no capture, which costs more host
#: time than an eager step.
_EAGER_STEPS = 2


def _update_kind(cfg: OMGConfig, piece: str, restricted: bool, step: int,
                 t: float, captured) -> str:
    """How a graphed plan runs ``piece``'s (``chomp``, ``learner``) update
    on step ``step``, from host counts alone: ``eager`` (the first
    :data:`_EAGER_STEPS` steps; an unrestricted sweep), ``refresh`` (the
    learner's full re-ranking sweep, eager), ``capture`` (the piece's
    first graphed update, when ``captured`` lacks it) or ``replay``.
    ``t`` is the learner's count of updates before this one since the
    start or the last blacklist restart (``LearnerState.t``).  A graphed
    CHOMP update that terminates the plan is run again eagerly
    (:meth:`_GraphedUpdates.last`)."""
    if step < _EAGER_STEPS or (piece == "learner" and not restricted):
        return "eager"
    every = cfg.learner_refresh_every
    if piece == "learner" and every and (t + 1.0) % every == 0:
        return "refresh"
    return "replay" if piece in captured else "capture"


class _GraphedUpdates(_Updates):
    """:func:`plan_fast`'s updates on a card.  After the first
    :data:`_EAGER_STEPS` steps the CHOMP update (the goal gathers, FK, the
    query, ``chomp_obstacle``, ``chomp_step``, ``joint_limit`` and the
    snapshot's selects) and the restricted learner update are each
    captured once a plan as a CUDA graph on the plan's own tensors, then
    replayed; the query's and ``chomp_obstacle``'s launches run between a
    graph's segments (``utils/graphs.py::outside``).  A graph reads and
    writes fixed buffers: the trajectory and the one before the update,
    the goal index and mask, the learner state, the snapshot, the step's
    weights and the sweep's start row (these two refreshed from the plan's
    tables).  An input that is not its buffer (after an eager update or a
    blacklist restart) is copied into it first.  A graphed update returns
    the buffers, which the next replay overwrites, and its info lives in
    the graph's pool: a terminating graphed step's info comes from an
    eager re-run, and nothing the plan returns lives in the pool."""

    def __init__(self, model, cfg: OMGConfig, hp, problem: PlanProblem):
        super().__init__(model, cfg, hp, problem)
        self.device = problem.start.device
        self.restricted = ol.sweep_restricted(cfg, problem.goal_set.capacity)
        self.w_rows, self.start_rows = _plan_tables(cfg, str(self.device))
        self.bufs = {}
        self.graphs = {}     # piece -> (graphs.Graph, its outputs)
        self.ex_info = None  # the snapshot's info: views of its buffers
        self.replayed = False  # the last CHOMP update ran from its graph

    def _stage(self, **values) -> dict:
        """The fixed buffers, each of ``values`` copied into its own (made
        on first use)."""
        for name, value in values.items():
            buf = self.bufs.get(name)
            if buf is None:
                self.bufs[name] = value.clone()
            elif buf is not value:
                buf.copy_(value)
        return self.bufs

    def _run(self, piece: str, body):
        """``body``'s graph for ``piece``, captured (and so run) on first
        use, replayed after; returns its outputs."""
        entry = self.graphs.get(piece)
        if entry is None:
            with timing.span("plan.graph.capture"):
                entry = self.graphs[piece] = graphs.capture(body,
                                                            self.device)
            GRAPHS.add(piece, "capture")
        else:
            with timing.span("plan.graph.replay"):
                entry[0].replay()
            GRAPHS.add(piece, "replay")
        return entry[1]

    def learner(self, step: int, traj, goal_idx, goal_mask, lstate):
        model, cfg, hp, problem = self.args
        if _update_kind(cfg, "learner", self.restricted, step, lstate.t,
                        self.graphs) in ("eager", "refresh"):
            GRAPHS.add("learner", "eager")
            return super().learner(step, traj, goal_idx, goal_mask, lstate)
        t = lstate.t + 1.0
        b = self._stage(traj=traj, goal=goal_idx, mask=goal_mask,
                        start=self.start_rows[int(t)], **{
                            "l_" + f: getattr(lstate, f)
                            for f in _LEARNER_TENSORS})
        state = lstate._replace(t=t, **{f: b["l_" + f]
                                        for f in _LEARNER_TENSORS})

        def body():
            new, goal = ol.update_goal(
                model, problem.scene, problem.cost_params, cfg, hp,
                b["traj"], _learner_goals(cfg, problem, b["mask"]),
                state._replace(t=t - 1.0), problem.world_potential,
                start_idx=b["start"])
            for f in _LEARNER_TENSORS:
                if getattr(new, f) is not getattr(state, f):
                    getattr(state, f).copy_(getattr(new, f))
            b["goal"].copy_(goal)
            return ()

        self._run("learner", body)
        return state, b["goal"]

    def _stage_snapshot(self, ex):
        ex_traj, ex_ok, ex_info = ex
        self._stage(ex_traj=ex_traj, ex_ok=ex_ok)
        if self.ex_info is None:
            self.bufs["ex_floats"] = ex_traj.new_empty(
                len(chomp.kernels.INFO_SCALARS) + ex_traj.shape[0])
            self.bufs["ex_flags"] = ex_ok.new_empty(4)
            self.ex_info = chomp.info_from(self.bufs["ex_floats"],
                                           self.bufs["ex_flags"])
        moved = [(b, v) for b, v in zip(self.ex_info, ex_info) if b is not v]
        if moved:
            torch._foreach_copy_(*map(list, zip(*moved)))

    def chomp(self, step: int, rel: int, traj, goal_idx, ex):
        model, cfg, hp, problem = self.args
        self.replayed = _update_kind(cfg, "chomp", self.restricted, step,
                                     0.0, self.graphs) != "eager"
        if not self.replayed:
            GRAPHS.add("chomp", "eager")
            return super().chomp(step, rel, traj, goal_idx, ex)
        b = self._stage(traj=traj, goal=goal_idx, weights=self.w_rows[rel])
        if "prev" not in b:
            b["prev"] = torch.empty_like(traj)
        snapshot = cfg.exec_snapshot
        if snapshot:
            self._stage_snapshot(ex)

        def body():
            new, floats, flags = chomp.chomp_step_packed(*_chomp_args(
                model, cfg, hp, problem, b["traj"], b["goal"],
                b["weights"].unbind()))
            new = chomp.handle_joint_limit(hp, cfg, new, problem.joint_lower,
                                           problem.joint_upper)
            if snapshot:
                snap = chomp.info_from(floats, flags).execute
                for name, value in (("ex_traj", b["traj"]),
                                    ("ex_floats", floats),
                                    ("ex_flags", flags)):
                    torch.where(snap, value, b[name], out=b[name])
                torch.logical_or(b["ex_ok"], snap, out=b["ex_ok"])
            b["prev"].copy_(b["traj"])
            b["traj"].copy_(new)
            return chomp.info_from(floats, flags)

        return b["prev"], b["traj"], self._run("chomp", body)

    def snapshot(self, kept, info, ex):
        if not self.replayed:
            return super().snapshot(kept, info, ex)
        return self.bufs["ex_traj"], self.bufs["ex_ok"], self.ex_info

    def last(self, rel: int, kept, goal_idx, info) -> CostInfo:
        """A graphed step's ``_chomp_update`` again, eagerly, on tensors of
        its own (bit-equal to the replay's): the plan's last evaluation, as
        the eager loop makes it."""
        if not self.replayed:
            return info
        model, cfg, hp, problem = self.args
        GRAPHS.add("chomp", "eager")
        with timing.span("plan.chomp"):
            return _chomp_update(model, cfg, hp, problem, kept.clone(),
                                 goal_idx.clone(),
                                 schedule_weights(cfg, rel + 1))[1]

    def release(self):
        graphs.retain([g for g, _ in self.graphs.values()], self.device)


def _where_rows(cond, a, b):
    """Per-scene select over two matching trees of tensors with a leading
    scene axis: ``cond [S]`` picks ``a``'s rows."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)),
                           a, b)
    return type(a)(*(_where_rows(cond, x, y) for x, y in zip(a, b)))


def plan_fast_batch(model, cfg: OMGConfig,
                    problems: PlanProblem) -> PlanResult:
    """:func:`plan_fast` over a stacked batch of S problems (leading scene
    axis, objects padded to one count) in lockstep: each loop step is one
    set of tensor operations over all S scenes (the pure per-scene pieces
    under ``torch.func.vmap``), so the number of operations per step does
    not grow with S.  This is the JAX package's ``vmap`` of ``plan_fast``:
    each scene's state (trajectory, goal, learner, goal mask, schedule
    offset, snapshot, last info, step count) freezes when its own loop
    ends, and its result equals its own :func:`plan_fast`'s.

    Host reads per step: the termination flags of all scenes in one read
    (after step 0), on the blacklist's due steps the scenes that fire in
    one read, and the loops of the learner's Bregman projection and of
    the joint-limit smoothing, each over all live scenes at once.  The
    learner's gate depends on the step count only, alike for every live
    scene; each scene's learner step count (which a blacklist restart
    resets) is kept on the host and on the device."""
    dev = problems.start.device
    hp = cfg.horizon().on(dev)
    n = problems.start.shape[0]
    use_bl = _blacklist_enabled(cfg)

    def init_one(pr):
        traj0, goal0, learner0 = _learner_init(model, cfg, hp, pr)
        return traj0, goal0, learner0._replace(t=pr.start.new_zeros(()))

    traj, goal_idx, lstate = vmap_scenes(init_one, problems)
    t_host = [0.0] * n
    live = torch.ones(n, dtype=torch.bool, device=dev)
    live_host = [True] * n
    steps = torch.zeros(n, dtype=torch.int64, device=dev)
    sched0 = torch.zeros(n, dtype=torch.int64, device=dev)
    goal_mask = problems.goal_set.mask
    last_info = CostInfo(*(x.expand((n,) + x.shape)
                           for x in _dummy_info(cfg, dev)))
    ex_traj, ex_ok, ex_info = traj, torch.zeros_like(live), last_info

    def weights(step, sched0):
        """The cost schedule at each scene's own step (``step [S]``) since
        its last restart (``sched0 [S]``)."""
        return schedule_weights(cfg, (step - sched0 + 1).to(torch.float32))

    step = 0
    while any(live_host) and step < cfg.total_steps:
        if _learner_due(cfg, step):
            l_new, g_new, t_new = ol.update_goal_batch(
                model, problems.scene, problems.cost_params, cfg, hp, traj,
                _learner_goals(cfg, problems, goal_mask), lstate, t_host,
                live, problems.world_potential)
            lstate = _where_rows(live, l_new, lstate)
            goal_idx = torch.where(live, g_new, goal_idx)
            t_host = [a if lv else b
                      for a, b, lv in zip(t_new, t_host, live_host)]
        w = weights(torch.full_like(steps, step), sched0)
        new_traj, info = vmap_scenes(
            lambda pr, tr, gi, wt: _chomp_update(model, cfg, hp, pr, tr, gi,
                                                 wt),
            problems, traj, goal_idx, w)
        new_traj = chomp.handle_joint_limit_batch(
            hp, cfg, new_traj, problems.joint_lower, problems.joint_upper,
            live)
        if cfg.exec_snapshot:
            snap = info.execute & live
            ex_traj = _where_rows(snap, traj, ex_traj)
            ex_info = _where_rows(snap, info, ex_info)
            ex_ok = ex_ok | snap
        fired = info.terminate & live if step > 0 else torch.zeros_like(live)
        fired_host = (host_bools(fired, "plan_batch.terminate") if step > 0
                      else [False] * n)
        if use_bl and _blacklist_due(cfg, step):
            new_mask, fire = vmap_scenes(
                lambda pr, m, gi, inf: _inplan_blacklist(cfg, pr, m, gi, inf),
                problems, goal_mask, goal_idx, info)
            fire = fire & live & ~fired
            fire_host = host_bools(fire, "plan_batch.blacklist")
            if any(fire_host):
                rt_traj, rt_goal, rt_l = vmap_scenes(
                    lambda pr, m, ls: _restart_tensors(cfg, pr, m, ls),
                    problems, new_mask, lstate)
                goal_mask = _where_rows(fire, new_mask, goal_mask)
                new_traj = _where_rows(fire, rt_traj, new_traj)
                goal_idx = torch.where(fire, rt_goal, goal_idx)
                lstate = _where_rows(fire, rt_l, lstate)
                sched0 = torch.where(fire, step + 1, sched0)
                t_host = [0.0 if f else t for f, t in zip(fire_host, t_host)]
        traj = _where_rows(live & ~fired, new_traj, traj)
        last_info = _where_rows(live, info, last_info)
        steps = torch.where(live, step + 1, steps)
        live = live & ~fired
        live_host = [a and not b for a, b in zip(live_host, fired_host)]
        step += 1

    # scenes that ran out of steps are re-evaluated at their final
    # trajectory (planner.py:633-636), as in _finish
    info = last_info
    if any(live_host):
        final = vmap_scenes(lambda pr, tr, gi, wt: _evaluate_w(
            model, cfg, hp, pr, tr, gi, wt),
            problems, traj, goal_idx, weights(steps, sched0))
        info = _where_rows(live, final, info)
    traj_out = traj
    if cfg.exec_snapshot:
        use = ex_ok & ~info.execute
        traj_out = _where_rows(use, ex_traj, traj)
        info = _where_rows(use, ex_info, info)
    return PlanResult(
        traj=traj_out, goal_idx=goal_idx, info=info, info_history=info,
        history=traj_out[:, None], selected_goals=goal_idx[:, None],
        steps_used=steps, flag=info.terminate, goal_mask=goal_mask)


def _restart_tensors(cfg, problem, mask, lstate):
    """:func:`_blacklist_restart` with the learner's step count as a
    tensor (for ``torch.func.vmap``)."""
    traj, goal, rt = _blacklist_restart(cfg, problem, mask, lstate)
    return traj, goal, rt._replace(t=torch.zeros_like(lstate.t))


def init_trajectory(cfg: OMGConfig, start, end):
    """Spline initialization (``omg/core.py:59-78``)."""
    if cfg.traj_interpolate == "linear":
        return linear_interpolate(start, end, cfg.timesteps)
    return cubic_interpolate(start, end, cfg.timesteps)
