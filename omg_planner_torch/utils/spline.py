"""Trajectory initialization splines, closed-form and batched (counterpart
of ``omg_planner_tpu/utils/spline.py``).

A clamped cubic between two waypoints with zero end-derivatives is
``p(t) = start + (end - start) * (3 t^2 - 2 t^3)`` at the interior points
of ``linspace(0, 1, n + 2)``; the learner's candidates use a linear ramp.
"""

from __future__ import annotations

import torch


def _interior_times(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.linspace(0.0, 1.0, n + 2, dtype=torch.float32,
                          device=like.device)[1:-1]


def _cubic(t):
    return 3.0 * t**2 - 2.0 * t**3


def cubic_interpolate(start: torch.Tensor, end: torch.Tensor,
                      n: int) -> torch.Tensor:
    """Clamped cubic from start to end; returns [n, dof]."""
    s = _cubic(_interior_times(n, start))
    return start[None, :] + s[:, None] * (end - start)[None, :]


def linear_interpolate(start: torch.Tensor, end: torch.Tensor,
                       n: int) -> torch.Tensor:
    """Linear ramp; returns [n, dof]."""
    t = _interior_times(n, start)
    return start[None, :] + t[:, None] * (end - start)[None, :]


def multi_linear_interpolate(start: torch.Tensor, goals: torch.Tensor,
                             n: int) -> torch.Tensor:
    """One start to many goals, linear; returns [g, n, dof]."""
    t = _interior_times(n, goals)
    if start.ndim == 1:
        start = start[None, :].expand(goals.shape)
    return start[:, None, :] + t[None, :, None] * (goals - start)[:, None, :]


def multi_cubic_interpolate(start: torch.Tensor, goals: torch.Tensor,
                            n: int) -> torch.Tensor:
    """One start to many goals, clamped cubic; returns [g, n, dof]."""
    s = _cubic(_interior_times(n, goals))
    if start.ndim == 1:
        start = start[None, :].expand(goals.shape)
    return start[:, None, :] + s[None, :, None] * (goals - start)[:, None, :]
