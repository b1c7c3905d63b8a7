"""Small fixed-size linear algebra (counterpart of
``omg_planner_tpu/utils/linalg.py``).

:func:`solve_spd_unrolled` keeps the JAX package's unrolled Cholesky so the
IK's 6x6 damped-least-squares solves follow the same arithmetic; it is
elementwise over the batch (a batched ``torch.linalg.solve`` would pivot
and round differently).
"""

from __future__ import annotations

import torch


def solve_spd_unrolled(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve ``a x = b`` for SPD ``a [..., n, n]`` and ``b [..., n]``
    (small static ``n``; the IK uses 6): unrolled Cholesky and two
    triangular substitutions, elementwise over the leading dims."""
    n = a.shape[-1]
    l = [[None] * n for _ in range(n)]
    for j in range(n):
        s = a[..., j, j]
        for k in range(j):
            s = s - l[j][k] * l[j][k]
        d = torch.sqrt(torch.clamp(s, min=1e-20))
        l[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = a[..., i, j]
            for k in range(j):
                s = s - l[i][k] * l[j][k]
            l[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - l[i][k] * y[k]
        y[i] = s / l[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - l[k][i] * x[k]
        x[i] = s / l[i][i]
    return torch.stack(x, dim=-1)


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis with its tie order: among equal
    values the lower index comes first.  ``torch.topk`` promises no order
    for ties on CUDA, and masked ``-inf`` lanes and symmetric grasp sets
    tie routinely, so this is a stable sort on (value, index).
    Returns (values [..., k], indices [..., k] int64)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def take_rows(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row gather ``a[idx]`` (the JAX package flattens to scalar takes for
    the TPU's gather unit; on a GPU a plain index_select is the fast form)."""
    return torch.index_select(a, 0, idx)
