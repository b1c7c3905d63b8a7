"""Multi-process orchestration (counterpart of
``omg_planner_tpu/parallel/multihost.py``).

JAX's ``Mesh(('scene', 'goal'))`` over all devices becomes a
``torch.distributed`` world with one process per device: rank r sits at
scene row ``r // goal_parallel`` and goal column ``r % goal_parallel``,
and the ranks of each row form that row's goal group.  The scene axis is
embarrassingly parallel: each row stages its own scenes; the collectives
ride the goal groups only.

    dist.init_process_group(...)              # the caller's rendezvous
    mesh = make_scene_mesh(goal_parallel=2)
    inputs = [stage(sid) for sid in my_scene_ids(total=100, mesh=mesh)]
    batch = host_local_batch(mesh, inputs)
    results = make_sharded_pipeline(mesh, model, cfg)(batch)

Nothing here creates a process group at import time.
"""

from __future__ import annotations

from datetime import timedelta
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

from .. import resolve_device
from .batch import stack_problems

# every group gets a timeout: ranks that disagree on a host decision leave
# a collective unmatched, which must end in an error, not a hang
GROUP_TIMEOUT = timedelta(seconds=120)


class SceneMesh(NamedTuple):
    """This rank's place in the (scene x goal) layout."""

    rank: int
    world: int
    scene_row: int
    goal_col: int
    goal_parallel: int
    goal_group: object    # the torch.distributed group of this scene row
    device: torch.device

    @property
    def rows(self) -> int:
        return self.world // self.goal_parallel


def default_backend(device) -> str:
    """NCCL for CUDA tensors, gloo for CPU tensors."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def make_scene_mesh(goal_parallel: int = 1, backend: str | None = None,
                    device=None) -> SceneMesh:
    """This rank's (scene x goal) mesh over the initialised default group.

    Every rank creates every row's goal group, in the same order (as
    ``dist.new_group`` requires), with ``GROUP_TIMEOUT``.  ``device`` is
    where this rank's tensors live (``cuda`` unless named; a multi-GPU
    caller names ``cuda:<local rank>``); ``backend`` defaults to
    :func:`default_backend` of it.  Raises when ``torch.distributed`` is
    not initialised or when the world size is not divisible by
    ``goal_parallel``."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_scene_mesh needs an initialised default "
                           "group (torch.distributed.init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if goal_parallel < 1 or world % goal_parallel:
        raise ValueError(f"world size {world} is not divisible by "
                         f"goal_parallel={goal_parallel}")
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    mine = None
    for row in range(world // goal_parallel):
        ranks = list(range(row * goal_parallel, (row + 1) * goal_parallel))
        group = dist.new_group(ranks, timeout=GROUP_TIMEOUT,
                               backend=backend)
        if rank in ranks:
            mine = group
    return SceneMesh(rank=rank, world=world,
                     scene_row=rank // goal_parallel,
                     goal_col=rank % goal_parallel,
                     goal_parallel=goal_parallel, goal_group=mine,
                     device=dev)


def my_scene_ids(total: int, mesh: SceneMesh) -> list[int]:
    """The contiguous scene-id shard of this rank's scene row (JAX's
    per-process formula with scene rows in place of processes)."""
    per = (total + mesh.rows - 1) // mesh.rows
    return list(range(mesh.scene_row * per,
                      min((mesh.scene_row + 1) * per, total)))


def host_local_batch(mesh: SceneMesh, local_problems: Sequence):
    """The batch of this rank's scenes: ``stack_problems`` of the staged
    problems (or pipeline inputs) of its row.

    The port has no global array: where JAX assembles one from every
    process's shard (``make_array_from_process_local_data``), the batch and
    the results stay per rank, as JAX's addressable shards do, and every
    rank of a row holds its row's scenes."""
    return stack_problems(local_problems)
