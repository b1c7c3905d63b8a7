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
(``omg/planner.py:627-636``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import OMGConfig, schedule_weights
from ..ops import chomp
from ..ops import learner as ol
from ..ops.chomp import CostInfo, CostParams, GoalSet
from ..ops.sdf import WorldField, WorldPotential
from ..utils.linalg import top_k
from ..utils.spline import cubic_interpolate, linear_interpolate
from ..utils.sync import host_bool


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
    """(termination goal [D], projection tail [k, D])."""
    grasp = goal_set.grasps[goal_idx]
    tail = goal_set.reach_grasps[goal_idx] if cfg.use_standoff \
        else grasp[None]
    return grasp, tail


def _evaluate(model, cfg, hp, problem: PlanProblem, traj, goal_idx, step):
    """Cost/gradient/termination evaluation at ``traj``."""
    obstacle_w, smooth_w, _, step_size = schedule_weights(cfg, step + 1)
    if cfg.goal_set_proj:
        goal, tail = _chosen_goal(cfg, problem.goal_set, goal_idx)
    else:
        goal, tail = problem.end, problem.end[None]
    _, grad, info = chomp.compute_total_loss(
        model, problem.scene, problem.cost_params, cfg, hp, traj,
        problem.start, goal if cfg.goal_set_proj else problem.end,
        goal, obstacle_w, smooth_w,
        world_field=problem.world_field if cfg.sdf_fused else None)
    over_limit = chomp.check_joint_limit(
        traj, problem.joint_lower, problem.joint_upper)
    info = info._replace(violate_limit=over_limit,
                         terminate=info.terminate & ~over_limit)
    return info, grad, tail, step_size


def _optimize_once(model, cfg, hp, problem: PlanProblem, traj, goal_idx,
                   step):
    """One CHOMP step (``omg/optimizer.py:115-135``)."""
    info, grad, tail, step_size = _evaluate(
        model, cfg, hp, problem, traj, goal_idx, step)
    if cfg.goal_set_proj:
        update = chomp.goal_set_projection_update(
            hp, cfg, traj, grad, tail, step_size)
    else:
        update = chomp.unconstrained_update(hp, grad, step_size)
    new_traj = chomp.apply_update(model, cfg, traj, update)
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


def _blacklist_enabled(cfg: OMGConfig) -> bool:
    return cfg.inplan_blacklist_step > 0 and _learner_enabled(cfg)


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


def _learner_init(model, cfg, hp, problem: PlanProblem):
    """Initial goal choice + respline (reference Learner.__init__,
    online_learner.py:94-102)."""
    goal_idx0 = _init_goal_idx(cfg, problem)
    traj0 = problem.traj_init
    restrict = ol.sweep_restricted(cfg, problem.goal_set.capacity)
    learner0 = ol.init_learner_state(
        problem.goal_set, cfg.learner_active_goals if restrict else 0)
    if _learner_enabled(cfg):
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


def _step(model, cfg, hp, problem: PlanProblem, carry: _Carry) -> _Carry:
    """One plan iteration (the body of the JAX package's loop)."""
    traj, goal_idx, lstate = carry.traj, carry.goal_idx, carry.learner
    use_bl = _blacklist_enabled(cfg)
    if _learner_enabled(cfg):
        do_learn = carry.step < cfg.optim_steps
        if cfg.learner_sweep_every > 1:
            do_learn = do_learn and carry.step % cfg.learner_sweep_every == 0
        if do_learn:
            problem_l = (problem._replace(goal_set=problem.goal_set._replace(
                mask=carry.goal_mask)) if use_bl else problem)
            lstate, goal_idx = ol.update_goal(
                model, problem_l.scene, problem_l.cost_params, cfg, hp, traj,
                problem_l.goal_set, lstate, problem_l.world_potential)
    new_traj, info = _optimize_once(model, cfg, hp, problem, traj, goal_idx,
                                    carry.step - carry.sched0)
    ex_traj, ex_ok, ex_info = carry.exec_traj, carry.exec_ok, carry.exec_info
    if cfg.exec_snapshot:
        snap = info.execute
        ex_traj = torch.where(snap, traj, ex_traj)
        ex_info = _where_tree(snap, info, ex_info)
        ex_ok = ex_ok | snap
    fired = carry.step > 0 and host_bool(info.terminate)
    goal_mask, sched0 = carry.goal_mask, carry.sched0
    if use_bl and not fired and _blacklist_due(cfg, carry.step):
        new_mask, fire = _inplan_blacklist(cfg, problem, goal_mask,
                                           goal_idx, info)
        if host_bool(fire):
            goal_mask = new_mask
            new_traj, goal_idx, lstate = _blacklist_restart(
                cfg, problem, goal_mask, lstate)
            sched0 = carry.step + 1
    return _Carry(
        traj=traj if fired else new_traj, goal_idx=goal_idx, learner=lstate,
        step=carry.step + 1, done=fired, last_info=info,
        goal_mask=goal_mask, sched0=sched0,
        exec_traj=ex_traj, exec_ok=ex_ok, exec_info=ex_info)


def _init_carry(model, cfg, hp, problem: PlanProblem) -> _Carry:
    dev = problem.start.device
    traj0, goal_idx0, learner0 = _learner_init(model, cfg, hp, problem)
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
    info = carry.last_info
    if not carry.done:
        info = _evaluate(model, cfg, hp, problem, carry.traj, carry.goal_idx,
                         carry.step - carry.sched0)[0]
    if not cfg.exec_snapshot:
        return carry.traj, info
    use = carry.exec_ok & ~info.execute
    return (torch.where(use, carry.exec_traj, carry.traj),
            _where_tree(use, carry.exec_info, info))


def plan(model, cfg: OMGConfig, problem: PlanProblem) -> PlanResult:
    """Full OMG plan with per-step history (``cfg.total_steps`` entries;
    steps after termination repeat the frozen state, as the JAX package's
    scan does)."""
    hp = cfg.horizon().on(problem.start.device)
    carry = _init_carry(model, cfg, hp, problem)
    history, infos, selected = [], [], []
    for _ in range(cfg.total_steps):
        if not carry.done:
            carry = _step(model, cfg, hp, problem, carry)
        history.append(carry.traj)
        infos.append(carry.last_info)
        selected.append(carry.goal_idx)
    traj_out, info = _finish(model, cfg, hp, problem, carry)
    dev = problem.start.device
    return PlanResult(
        traj=traj_out, goal_idx=carry.goal_idx, info=info,
        info_history=CostInfo(*(torch.stack(f) for f in zip(*infos))),
        history=torch.stack(history), selected_goals=torch.stack(selected),
        steps_used=torch.tensor(carry.step, device=dev), flag=info.terminate,
        goal_mask=carry.goal_mask)


def plan_fast(model, cfg: OMGConfig, problem: PlanProblem) -> PlanResult:
    """History-free plan: early termination ends the loop (the benchmark
    path)."""
    hp = cfg.horizon().on(problem.start.device)
    carry = _init_carry(model, cfg, hp, problem)
    while not carry.done and carry.step < cfg.total_steps:
        carry = _step(model, cfg, hp, problem, carry)
    traj_out, info = _finish(model, cfg, hp, problem, carry)
    return PlanResult(
        traj=traj_out, goal_idx=carry.goal_idx, info=info,
        info_history=info, history=traj_out[None],
        selected_goals=carry.goal_idx[None],
        steps_used=torch.tensor(carry.step, device=problem.start.device),
        flag=info.terminate, goal_mask=carry.goal_mask)


def init_trajectory(cfg: OMGConfig, start, end):
    """Spline initialization (``omg/core.py:59-78``)."""
    if cfg.traj_interpolate == "linear":
        return linear_interpolate(start, end, cfg.timesteps)
    return cubic_interpolate(start, end, cfg.timesteps)
