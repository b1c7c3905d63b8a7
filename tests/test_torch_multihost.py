"""The port's multi-process layer (``omg_planner_torch/parallel/
multihost.py`` and ``apps/multihost_demo.py``) on the CPU.

* ``my_scene_ids`` against JAX's formula (``omg_planner_tpu/parallel/
  multihost.py::my_scene_ids`` with its process index and count set to
  the scene row and the number of rows), as a pure function;
* ``make_scene_mesh`` raises without an initialised group, and at world
  size 1 (a gloo group in this process) gives the 1 x 1 mesh and rejects
  a goal axis that does not divide the world;
* ``launch.spawn`` runs on ``cuda`` unless told otherwise, so without a
  GPU and no device named it raises, and it refuses NCCL for more ranks
  than cards before starting any rank;
* the demo as a subprocess with a time limit: 4 gloo ranks as scene 2 x
  goal 2 print ``MULTIHOST DEMO: PASS``.
"""

import os
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed as dist

from omg_planner_tpu.parallel import multihost as jmultihost
from omg_planner_torch.parallel import launch
from omg_planner_torch.parallel.multihost import (SceneMesh, make_scene_mesh,
                                                  my_scene_ids)
from omg_planner_torch.utils.collectives import all_gather_cat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_TIMEOUT_S = 300


@pytest.mark.parametrize("total,world,goal_parallel", [
    (100, 4, 2), (100, 8, 2), (7, 4, 1), (3, 8, 2), (4, 4, 2), (1, 2, 1),
    (10, 6, 3)])
def test_my_scene_ids_matches_jax_formula(monkeypatch, total, world,
                                          goal_parallel):
    rows = world // goal_parallel
    monkeypatch.setattr(jax, "process_count", lambda: rows)
    covered = []
    for rank in range(world):
        row = rank // goal_parallel
        mesh = SceneMesh(rank=rank, world=world, scene_row=row,
                         goal_col=rank % goal_parallel,
                         goal_parallel=goal_parallel, goal_group=None,
                         device=torch.device("cpu"))
        monkeypatch.setattr(jax, "process_index", lambda row=row: row)
        ids = my_scene_ids(total, mesh)
        assert ids == jmultihost.my_scene_ids(total)
        if rank % goal_parallel == 0:
            covered += ids
    assert covered == list(range(total))


def test_make_scene_mesh_needs_a_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_scene_mesh(goal_parallel=1, device="cpu")


def test_make_scene_mesh_world_one(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_scene_mesh(goal_parallel=1, device="cpu")
        assert (mesh.rank, mesh.world, mesh.scene_row, mesh.goal_col,
                mesh.rows) == (0, 1, 0, 0, 1)
        assert my_scene_ids(5, mesh) == [0, 1, 2, 3, 4]
        x = torch.tensor([[1.0, 2.0]])
        assert torch.equal(all_gather_cat(x, mesh.goal_group), x)
        flags = torch.tensor([True, False])
        assert torch.equal(all_gather_cat(flags, mesh.goal_group), flags)
        with pytest.raises(ValueError, match="not divisible"):
            make_scene_mesh(goal_parallel=2, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a GPU")
def test_spawn_defaults_to_cuda(tmp_path):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch.spawn("omg_planner_torch.parallel.launch:jobs", 2,
                     str(tmp_path), kwargs=dict(calls={}))
    assert not os.listdir(tmp_path)


def test_spawn_refuses_nccl_beyond_the_cards(tmp_path):
    world = torch.cuda.device_count() + 1
    with pytest.raises(ValueError, match="a card for each rank"):
        launch.spawn("omg_planner_torch.parallel.launch:jobs", world,
                     str(tmp_path), kwargs=dict(calls={}), device="cpu",
                     backend="nccl")
    assert not os.listdir(tmp_path)


def test_demo_passes_on_four_gloo_ranks():
    out = subprocess.run(
        [sys.executable, "-m", "omg_planner_torch.apps.multihost_demo",
         "--cpu", "--world", "4", "--goal-parallel", "2",
         "--timeout", str(DEMO_TIMEOUT_S - 30)],
        cwd=ROOT, capture_output=True, text=True, timeout=DEMO_TIMEOUT_S)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "MULTIHOST DEMO: PASS" in out.stdout
    for rank in range(4):
        assert f"[child {rank}] ok" in out.stdout
