"""Collectives over a ``torch.distributed`` process group: the port's
counterparts of JAX's ``all_gather`` and ``pmax`` over a mesh axis, and the
check that the ranks of a group reached the same result."""

from __future__ import annotations

import torch
import torch.distributed as dist

from .sync import host_bool


def all_gather_cat(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` concatenated on dim 0 in rank order (JAX's
    ``all_gather`` over an axis, reshaped to one leading dim).  Bool
    tensors travel as uint8."""
    src = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts)
    return out.bool() if x.dtype == torch.bool else out


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over the group (JAX's ``pmax``)."""
    y = x.reshape(-1).clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y.reshape(x.shape)


def bits_checksum(x: torch.Tensor) -> torch.Tensor:
    """A 0-d int64 sum of the float32 bit patterns of ``x``: two tensors
    that differ in any bit almost surely differ here."""
    return x.to(torch.float32).contiguous().view(torch.int32).to(
        torch.int64).sum()


def check_agreement(values: torch.Tensor, group, what: str):
    """Raise unless every rank of ``group`` holds the same int64 vector
    ``values``.  A host decision that gates a collective (plan
    termination, a blacklist fire, a loop exit) must come out alike on
    every rank, or the ranks leave their loops at different steps."""
    rows = all_gather_cat(values.reshape(1, -1).to(torch.int64), group)
    if not host_bool((rows == rows[:1]).all(), "collectives.agree"):
        raise RuntimeError(f"{what}: ranks of the goal group disagree: "
                           f"{rows.tolist()}")
