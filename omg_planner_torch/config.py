"""Immutable planner configuration and derived per-horizon operators.

Counterpart of ``omg_planner_tpu/config.py``: the same frozen dataclass
fields and defaults (the rationale of each knob is documented there), the
same per-horizon CHOMP/projection operators, and the pure cost schedule.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

# The reference's 7-tap finite difference rules (omg/config.py:204-207).
DIFF_RULE_LENGTH = 7
DIFF_RULES = np.array(
    [
        [0.0, 0.0, -1.0, 1.0, 0.0, 0.0, 0.0],  # velocity
        [0.0, 0.0, 1.0, -2.0, 1.0, 0.0, 0.0],  # acceleration
        [0.0, -0.5, 1.0, 0.0, -1.0, 0.5, 0.0],  # jerk
    ]
)


@dataclasses.dataclass(frozen=True)
class OMGConfig:
    """Planner hyperparameters (reference ``omg/config.py:29-131`` plus the
    JAX package's additions), field for field equal to
    ``omg_planner_tpu.config.OMGConfig``."""

    # --- hyperparameters
    smoothness_base_weight: float = 0.1
    base_obstacle_weight: float = 1.0
    base_grasp_weight: float = 1.0
    cost_schedule_decay: float = 1.0
    cost_schedule_boost: float = 1.02
    base_step_size: float = 0.1
    step_decay_rate: float = 1.0
    joint_limit_max_steps: int = 10
    optim_steps: int = 50

    # --- planner parameters
    epsilon: float = 0.2
    target_epsilon: float = 0.1
    target_obj_collision: float = 0.0
    collision_point_num: int = 15
    time_interval: float = 0.1
    top_k_collision: int = 1000
    clearance: float = 0.01
    target_clearance: float = 0.0
    ik_clearance: float = 0.03
    target_size: float = 1.0
    obstacle_size: float = 1.0
    obj_point_num: int = 800
    terminate_smooth_ratio: float = 4.0
    terminate_grad_norm: float = 1.5
    terminate_smooth_loss: float = 35.0
    penalize_constant: float = 5.0
    grasp_optimize: bool = False
    traj_init: str = "grasp"
    traj_interpolate: str = "cubic"
    goal_set_proj: bool = True
    goal_set_max_num: int = 100
    ol_alg: str = "MD"
    dist_eps: float = 0.1
    goal_idx: int = -2
    pre_terminate: bool = True
    ik_seed_num: int = 12
    finger_hard_constraint: bool = True
    uncheck_finger_collision: int = 0
    allow_collision_point: int = 5
    soft_joint_limit_padding: float = 0.2
    extra_smooth_steps: int = 20
    clip_grad_scale: float = 10.0
    normalize_cost: bool = True
    disable_collision_set: Tuple[str, ...] = ()
    use_standoff: bool = True
    standoff_dist: float = 0.08
    remove_flip_grasp: bool = True
    remove_base_rotate_grasp: bool = True
    remove_camera_downward_grasp: bool = True
    augment_flip_grasp: bool = True
    target_hand_filter_angle: float = 120.0
    dynamic_timestep: bool = False
    post_standoff: bool = False
    consider_finger: bool = False
    reach_tail_length: int = 5
    increment_iks: bool = False
    traj_delta: float = 0.05
    traj_max_step: int = 50
    traj_min_step: int = 2
    default_lazy: bool = True
    y_upsample: bool = False
    z_upsample: bool = True
    use_point_sdf: bool = False

    # --- globals
    timesteps: int = 30
    base_link: str = "panda_link0"
    report_cost: bool = False
    report_time: bool = False
    scene_file: str = ""
    timeout: float = 3.0
    silent: bool = False

    # --- framework additions (see omg_planner_tpu/config.py)
    dof: int = 9
    num_links: int = 10
    learner_interp_steps: int = 15
    learner_collision_points: int = 0
    learner_active_goals: int = 32
    learner_refresh_every: int = 10
    learner_sweep_every: int = 2
    warm_start_init: bool = False
    ref_topk_quirks: bool = False
    sdf_baked: bool = True
    learner_world_potential: bool = True
    world_potential_resolution: float = 0.015
    learner_lookup: str = "nearest"
    sdf_fused: bool = False
    world_field_resolution: float = 0.01
    sdf_analytic: bool = True
    ik_max_iters: int = 60
    ik_pos_tol: float = 1e-4
    ik_rot_tol: float = 1e-3
    ik_damping: float = 1e-4
    ik_stall_window: int = 6
    ik_two_stage: bool = True
    ik_prefilter_iters: int = 12
    ik_prefilter_tol: float = 0.05
    ik_survivor_cap: int = 256
    ik_chain_max_iters: int = 25
    ik_chain_fused: bool = True
    ik_chain_total_budget: int = 26
    goal_prune_cap: int = 512
    dedupe_mode: str = "rounds"
    inplan_blacklist_step: int = 12
    inplan_blacklist_every: int = 6
    inplan_blacklist_radius: float = 0.5
    exec_snapshot: bool = True
    grip_quality_weight: float = 0.0
    parity_density: bool = False

    def replace(self, **kw) -> "OMGConfig":
        return dataclasses.replace(self, **kw)

    def jit_key(self) -> "OMGConfig":
        """cfg with the host-only fields (``HOST_ONLY_DEFAULTS``) set to
        their defaults: the key of every staged cache, so flipping
        ``silent``, ``report_*`` or a path re-stages nothing."""
        return dataclasses.replace(self, **HOST_ONLY_DEFAULTS)

    @property
    def total_steps(self) -> int:
        return self.optim_steps + self.extra_smooth_steps

    @property
    def num_interp(self) -> int:
        return self.learner_interp_steps or self.timesteps

    def horizon(self, timesteps: int | None = None) -> "HorizonParams":
        return get_horizon_params(
            timesteps or self.timesteps,
            self.time_interval_for(timesteps or self.timesteps),
            self.goal_set_proj,
            self.reach_tail_length,
        )

    def time_interval_for(self, steps: int) -> float:
        # reference config.py:201: dt rescales so total duration stays 3 s.
        return (0.1 * 30.0) / steps

    def dynamic_timesteps(self, start: np.ndarray, end: np.ndarray) -> int:
        """Pick horizon length from start-goal distance (core.py:64-75)."""
        n = int(np.linalg.norm(np.asarray(start) - np.asarray(end))
                / self.traj_delta)
        return min(max(n, self.traj_min_step), self.traj_max_step)


#: Fields that never reach device work (reporting and IO).
HOST_ONLY_DEFAULTS = dict(
    silent=False, report_cost=False, report_time=False, scene_file="",
    timeout=3.0, default_lazy=True)


def get_diff_matrix(n: int, order: int, time_interval: float,
                    with_end: bool) -> np.ndarray:
    """Banded finite-difference matrix ``(n+1, n)``, reference
    ``omg/util.py:165-178``; ``with_end=False`` zeroes the last row's final
    entry (the endpoint is free under ``goal_set_proj``)."""
    rule = DIFF_RULES[order - 1]
    half = DIFF_RULE_LENGTH // 2
    d = np.zeros((n + 1, n))
    for i in range(n + 1):
        for j in range(-half, half):
            idx = i + j
            if 0 <= idx < n:
                d[i, idx] = rule[j + half]
    if not with_end:
        d[-1, -1] = 0.0
    return d / (time_interval ** order)


class HorizonParams:
    """Precomputed, horizon-dependent CHOMP operators (host numpy, float32).

    The goal-set projection step collapses to
    ``update = -eta * P_k @ g - M_k @ b`` with
    ``P_k = Ainv - M_k @ Ainv[-k:]`` and
    ``M_k = Ainv[:, -k:] @ inv(Ainv[-k:, -k:])`` for ``k = 1`` and
    ``k = reach_tail_length``.  :meth:`on` caches device copies.
    """

    def __init__(self, n: int, dt: float, goal_set_proj: bool, tail: int):
        self.timesteps = n
        self.time_interval = dt
        self.goal_set_proj = goal_set_proj
        self.tail = tail
        with_end = not goal_set_proj
        self.diff_matrices = np.stack(
            [get_diff_matrix(n, o + 1, dt, with_end) for o in range(3)]
        )
        d1 = self.diff_matrices[0]
        self.A = d1.T @ d1
        self.Ainv = np.linalg.inv(self.A)
        self.proj = {}
        for k in (1, tail):
            m_k = self.Ainv[:, -k:] @ np.linalg.inv(self.Ainv[-k:, -k:])
            p_k = self.Ainv - m_k @ self.Ainv[-k:, :]
            self.proj[k] = (m_k.astype(np.float32), p_k.astype(np.float32))
        self.diff_matrices = self.diff_matrices.astype(np.float32)
        self.A = self.A.astype(np.float32)
        self.Ainv = self.Ainv.astype(np.float32)
        self._dev: dict = {}

    def on(self, device) -> "DeviceHorizon":
        """The operators as float32 tensors on ``device`` (cached)."""
        key = str(torch.device(device))
        hit = self._dev.get(key)
        if hit is None:
            hit = DeviceHorizon(self, device)
            self._dev[key] = hit
        return hit


class DeviceHorizon:
    """Device copies of one :class:`HorizonParams`."""

    def __init__(self, hp: HorizonParams, device):
        def t(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        self.host = hp
        self.timesteps = hp.timesteps
        self.time_interval = hp.time_interval
        self.diff_matrices = t(hp.diff_matrices)
        self.A = t(hp.A)
        self.Ainv = t(hp.Ainv)
        self.proj = {k: (t(m), t(p)) for k, (m, p) in hp.proj.items()}


@functools.lru_cache(maxsize=64)
def get_horizon_params(n: int, dt: float, goal_set_proj: bool,
                       tail: int) -> HorizonParams:
    return HorizonParams(n, dt, goal_set_proj, tail)


def schedule_weights(cfg: OMGConfig, step):
    """Pure cost schedule, reference ``omg/optimizer.py:59-80``.

    ``step`` is a float32 tensor (1-based as in the reference); returns
    float32 0-d tensors ``(obstacle_w, smooth_w, grasp_w, step_size)``."""
    stepf = torch.as_tensor(step, dtype=torch.float32)

    def pw(base):
        # torch.full, not torch.tensor: no host-to-device copy on a card
        return torch.pow(torch.full((), base, dtype=torch.float32,
                                    device=stepf.device), stepf)

    obstacle_w = cfg.base_obstacle_weight * pw(cfg.cost_schedule_decay)
    smooth_w = cfg.smoothness_base_weight * pw(cfg.cost_schedule_boost)
    grasp_w = cfg.base_grasp_weight * pw(cfg.cost_schedule_decay)
    step_size = pw(cfg.step_decay_rate) * cfg.base_step_size
    return obstacle_w, smooth_w, grasp_w, step_size
