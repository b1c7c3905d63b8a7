"""``torch.func.vmap`` over a scene batch.

The scene-batched paths (the goal-set build of a wave, the lockstep plan)
run the pure per-scene functions of the package under ``vmap``: one set
of tensor operations for the whole batch.  Their arguments are trees of
tensors with a leading scene axis, some of whose fields may be None (a
problem's ``world_field``); :func:`vmap_scenes` maps over every tensor and
passes the Nones through.
"""

from __future__ import annotations

import torch
from torch.utils._pytree import tree_map


def vmap_scenes(fn, *args):
    """``fn`` over the leading (scene) axis of every tensor in ``args``;
    None fields stay None."""
    dims = tuple(tree_map(lambda x: None if x is None else 0, a)
                 for a in args)
    return torch.func.vmap(fn, in_dims=dims)(*args)
