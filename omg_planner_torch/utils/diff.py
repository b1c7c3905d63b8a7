"""Endpoint-corrected finite-difference derivative operators (counterpart of
``omg_planner_tpu/utils/diff.py``, reference ``omg/config.py:134-159``):
apply the (n+1, n) banded difference matrix along axis -2, add boundary
corrections from the fixed ``start``/``end`` states, drop the final row."""

from __future__ import annotations

import torch

from ..config import DIFF_RULES, DIFF_RULE_LENGTH, DeviceHorizon


def get_derivative(hp: DeviceHorizon, data: torch.Tensor,
                   start: torch.Tensor, end: torch.Tensor,
                   order: int = 1) -> torch.Tensor:
    """Differentiate ``data [..., n, m]`` along axis -2; returns
    [..., n, m].  ``start``/``end`` broadcast against ``[..., m]``."""
    return derivative(hp.diff_matrices, hp.time_interval, data, start, end,
                      order)


def derivative(diff_matrices: torch.Tensor, time_interval: float,
               data: torch.Tensor, start: torch.Tensor, end: torch.Tensor,
               order: int = 1) -> torch.Tensor:
    """:func:`get_derivative` on the horizon's difference matrices
    ``diff_matrices [3, T + 1, T]`` and its ``time_interval``."""
    n = data.shape[-2]
    dmat = diff_matrices[order - 1][: n + 1, :n]
    # one [n+1, n] @ [n, B] product over every leading lane
    moved = torch.movedim(data, -2, 0)                  # [n, ..., m]
    out = (dmat @ moved.reshape(n, -1)).reshape((n + 1,) + moved.shape[1:])
    out = torch.movedim(out, 0, -2)                     # [..., n+1, m]
    mid = DIFF_RULE_LENGTH // 2
    rule = DIFF_RULES[order - 1]
    dt = time_interval ** order
    out = out.clone()
    out[..., 0, :] += float(rule[mid - 1]) * start / dt
    out[..., -2, :] += float(rule[mid + 1]) * end / dt
    out[..., -1, :] += float(rule[mid]) * end / dt
    return out[..., :-1, :]
