"""Run a function on every rank of a process group spawned on this host.

    ranks = spawn("omg_planner_torch.parallel.launch:plan_job", world=2,
                  goal_parallel=2, kwargs=dict(...), workdir=tmp,
                  device="cpu")

The parent writes a job file into ``workdir`` and starts ``world``
processes of ``python -m omg_planner_torch.parallel.launch JOB RANK``.
Each child sets one torch thread, joins the group through a
``FileStore`` in ``workdir`` (no TCP port, so concurrent runs never
collide), builds its :class:`~.multihost.SceneMesh`, calls
``target(mesh, **kwargs)``, saves the result and destroys the group.  The
parent waits up to ``timeout`` seconds for all of them, kills whatever
still runs, and returns each rank's exit code, log and result.

The targets live in the package, so a child imports neither JAX nor a
test module.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import time
from typing import NamedTuple

import torch
import torch.distributed as dist

from .. import resolve_device
from .multihost import GROUP_TIMEOUT, default_backend, make_scene_mesh

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class RankRun(NamedTuple):
    rank: int
    returncode: int
    timed_out: bool          # killed at the time limit
    log: str
    result: object           # None unless the rank finished


def spawn(target: str, world: int, workdir: str, goal_parallel: int = 1,
          kwargs: dict | None = None, device=None,
          backend: str | None = None,
          timeout: float = 300.0) -> list[RankRun]:
    """Run ``target`` ("module:function") on ``world`` spawned ranks.

    ``device`` is ``cuda`` unless the caller names another (raising
    without a GPU, as every entry point does); a rank on ``cuda`` with no
    index takes card ``rank % count``.  ``backend`` defaults to NCCL for
    CUDA and gloo for the CPU.  NCCL needs a card for each rank: asking
    it for more ranks than cards raises ``ValueError`` here, before any
    rank starts."""
    dev = resolve_device(device)
    backend = backend or default_backend(dev)
    if backend == "nccl" and world > torch.cuda.device_count():
        raise ValueError(
            f"NCCL needs a card for each rank: {world} ranks, "
            f"{torch.cuda.device_count()} cards (pass backend='gloo' to "
            f"share cards)")
    os.makedirs(workdir, exist_ok=True)
    job = os.path.join(workdir, "job.pt")
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    torch.save(dict(target=target, world=world, goal_parallel=goal_parallel,
                    kwargs=kwargs or {}, device=str(dev), backend=backend,
                    store=store), job)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    logs = [os.path.join(workdir, f"rank_{r}.log") for r in range(world)]
    procs, killed = [], set()
    try:
        for r in range(world):
            with open(logs[r], "w") as out:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "omg_planner_torch.parallel.launch",
                     job, str(r)], stdout=out, stderr=subprocess.STDOUT,
                    cwd=_ROOT, env=env))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for r, p in enumerate(procs):
            if p.poll() is None:
                p.kill()
                p.wait()
                killed.add(r)
    runs = []
    for r, p in enumerate(procs):
        res_path = os.path.join(workdir, f"rank_{r}.pt")
        result = (torch.load(res_path, weights_only=False)
                  if p.returncode == 0 and os.path.exists(res_path) else None)
        with open(logs[r]) as f:
            runs.append(RankRun(r, p.returncode, r in killed, f.read(),
                                result))
    return runs


def check(runs: list[RankRun]) -> list:
    """The ranks' results; raises with every failed rank's log tail."""
    bad = [r for r in runs if r.returncode != 0]
    if bad:
        tails = "\n".join(
            f"--- rank {r.rank} (rc={r.returncode}"
            f"{', timed out' if r.timed_out else ''}) ---\n"
            + "\n".join(r.log.strip().splitlines()[-25:]) for r in bad)
        raise RuntimeError(f"{len(bad)} of {len(runs)} ranks failed\n{tails}")
    return [r.result for r in runs]


def _resolve(target: str):
    """The function named "module:function"."""
    module, name = target.split(":")
    return getattr(importlib.import_module(module), name)


def _child(job_path: str, rank: int):
    torch.set_num_threads(1)
    job = torch.load(job_path, weights_only=False)
    world, backend = job["world"], job["backend"]
    device = torch.device(job["device"])
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, store=dist.FileStore(job["store"], world), rank=rank,
        world_size=world, timeout=GROUP_TIMEOUT)
    try:
        mesh = make_scene_mesh(job["goal_parallel"], backend, device)
        out = _resolve(job["target"])(mesh, **job["kwargs"])
        path = os.path.join(os.path.dirname(job_path), f"rank_{rank}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# targets: each takes the rank's mesh first
# ---------------------------------------------------------------------------

def _to(tree, device):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return type(tree)(*(_to(x, device) for x in tree))


def plan_job(mesh, model, cfg, problems, fast: bool = True):
    """``make_sharded_plan`` over a stacked problem batch (moved to the
    rank's device); the result on the CPU."""
    from .batch import make_sharded_plan

    res = make_sharded_plan(mesh, _to(model, mesh.device), cfg, fast)(
        _to(problems, mesh.device))
    return _to(res, "cpu")


def solve_job(mesh, model, cfg, grasps, seeds, lower7, upper7,
              grasp_valid=None):
    """``solve_goal_set_sharded`` over the goal group; outputs on the CPU."""
    from .batch import solve_goal_set_sharded

    d = mesh.device
    out = solve_goal_set_sharded(
        _to(model, d), cfg, grasps.to(d), seeds.to(d), lower7.to(d),
        upper7.to(d), grasp_valid=_to(grasp_valid, d),
        group=mesh.goal_group)
    return tuple(x.cpu() for x in out)


def pipeline_job(mesh, model, cfg, inputs):
    """``make_sharded_pipeline`` over a stacked ``PipelineInput`` batch;
    the result on the CPU."""
    from .batch import make_sharded_pipeline

    res = make_sharded_pipeline(mesh, _to(model, mesh.device), cfg)(
        _to(inputs, mesh.device))
    return _to(res, "cpu")


def jobs(mesh, calls: dict):
    """Several targets in one spawn: ``calls`` maps a name to (target,
    kwargs); returns {name: result}."""
    return {name: _resolve(target)(mesh, **kwargs)
            for name, (target, kwargs) in calls.items()}


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]))
