"""Import hygiene and device rules of the port.

* ``omg_planner_torch`` (every module: ``models/chain.py``,
  ``planner/tasks.py``, ``apps/serve.py``, ``physics/*``,
  ``planner/exec_verify.py``, ``apps/phys_exec.py``, ``viz/render.py``
  and the apps among them; none imports matplotlib or cv2 at load),
  ``chip_smoke.py``
  and ``bench_torch.py`` import neither ``jax`` nor ``omg_planner_tpu``:
  checked in a fresh interpreter, since this test process has JAX loaded
  by ``tests/conftest.py``.
* Entry points run on ``cuda`` unless the caller passes a device; with no
  GPU they raise instead of falling back to the CPU, and so does
  ``bench_torch.py`` without ``--cpu``.
* ``chip_smoke.py`` fails, and prints no result, without a GPU and when it
  stands alone without the package."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

from omg_planner_torch import resolve_device
from omg_planner_torch.config import OMGConfig

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import importlib, pkgutil, sys
import omg_planner_torch
names = [m.name for m in pkgutil.walk_packages(
    omg_planner_torch.__path__, "omg_planner_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import bench_torch
bad = sorted(m for m in sys.modules
             if m in ("jax", "matplotlib", "cv2")
             or m.startswith(("jax.", "omg_planner_tpu")))
print(len(names), bad)
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, env=_env(),
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().splitlines()[-1].split(" ", 1)
    assert int(n) >= 38  # every module of the package was imported
    assert bad == "[]", bad


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_need_a_device_without_gpu(no_gpu, tmp_path):
    from omg_planner_torch.__main__ import main
    from omg_planner_torch.models import panda
    from omg_planner_torch.planner.scene import Env, PlanningScene, PointEnv

    cfg = OMGConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        panda.load_panda()
    with pytest.raises(RuntimeError):
        Env(cfg)
    with pytest.raises(RuntimeError):
        PointEnv(cfg)
    with pytest.raises(RuntimeError):
        PlanningScene(cfg)
    with pytest.raises(RuntimeError):
        PlanningScene.synthetic(cfg, scene_id=0)
    with pytest.raises(RuntimeError):
        PlanningScene.from_npz(
            cfg, os.path.join(ROOT, "data", "suite_v2", "scene_0.npz"))
    with pytest.raises(RuntimeError):
        main(["-f", "0"])
    with pytest.raises(RuntimeError):
        main(["-p", "-f", "0"])
    with pytest.raises(RuntimeError):
        main(["-exp"])
    from omg_planner_torch.planner.runner import SuiteRunner
    with pytest.raises(RuntimeError):
        SuiteRunner(str(tmp_path), cfg)
    # asked for explicitly, the CPU works
    assert resolve_device("cpu") == torch.device("cpu")
    assert Env(cfg, device="cpu").device == torch.device("cpu")
    assert panda.load_panda(15, "cpu").device == torch.device("cpu")


def test_service_and_chain_need_a_device_without_gpu(no_gpu):
    """The planning service (``make_server``, the serve ``main``) and the
    URDF chain loader raise without a GPU unless the CPU is asked for."""
    from omg_planner_torch.apps import serve
    from omg_planner_torch.models import chain

    urdf = ('<robot name="r"><link name="a"/><link name="b"/>'
            '<joint name="j" type="revolute"><parent link="a"/>'
            '<child link="b"/><axis xyz="0 0 1"/></joint></robot>')
    cfg = OMGConfig(silent=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.make_server(0, cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--port", "0"])
    with pytest.raises(RuntimeError):
        serve.plan_request({"objects": []}, cfg)
    with pytest.raises(RuntimeError):
        chain.load_urdf_chain(urdf, "a", "b")
    srv = serve.make_server(0, cfg, device="cpu")
    srv.server_close()
    assert chain.load_urdf_chain(urdf, "a", "b", device="cpu").num_dof == 1


def test_physics_needs_a_device_without_gpu(no_gpu):
    """The physics entry points run on cuda unless told otherwise: the
    solver constants, the body builders, ``NativePanda`` and the
    ``phys_exec`` app raise without a GPU, and work on the CPU when asked."""
    import numpy as np

    from omg_planner_torch.apps import phys_exec
    from omg_planner_torch.physics import rigid
    from omg_planner_torch.physics.panda_ctrl import NativePanda

    with pytest.raises(RuntimeError, match="device='cpu'"):
        rigid.default_params()
    with pytest.raises(RuntimeError):
        rigid.body_spec_from_primitive(0, np.full(3, 0.03))
    with pytest.raises(RuntimeError):
        NativePanda()
    with pytest.raises(RuntimeError):
        phys_exec.main(["--scenes", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        phys_exec.main(["--scenes", "1", "--video", "x.avi"])
    assert rigid.default_params(device="cpu").dt.device.type == "cpu"
    assert NativePanda(device="cpu").device.type == "cpu"


def test_apps_and_render_flags_need_a_device_without_gpu(no_gpu,
                                                        tmp_path):
    """The viz and app entry points (the CLI's render flags, ``gen_demos``,
    ``vis_demos``, ``kitchen``, ``inspector``) raise without a GPU unless
    the CPU is asked for."""
    from omg_planner_torch.__main__ import main
    from omg_planner_torch.apps import (gen_demos, inspector, kitchen,
                                        vis_demos)

    cfg = OMGConfig(silent=True)
    for flags in (["-vc"], ["-vg"], ["-w"], ["-v"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["-f", "0", *flags])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gen_demos.main(["-n", "1", "-o", str(tmp_path)])
    with pytest.raises(RuntimeError):
        gen_demos.generate(1, str(tmp_path), cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vis_demos.main(["-d", str(tmp_path)])
    with pytest.raises(RuntimeError):
        vis_demos.replay(os.path.join(str(tmp_path), "demo_0.npz"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kitchen.main([])
    with pytest.raises(RuntimeError):
        kitchen.kitchen_scene(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inspector.main(["--port", "0"])
    assert kitchen.kitchen_scene(cfg, device="cpu").device.type == "cpu"


def test_chip_smoke_fails_without_gpu_or_package(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke.py would run")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         capture_output=True, text=True, env=_env(),
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           capture_output=True, text=True, env=_env(),
                           timeout=120)
    assert alone.returncode != 0
    assert '"ok"' not in alone.stdout


def test_bench_torch_needs_a_gpu_without_cpu_flag():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: bench_torch.py would run")
    out = subprocess.run([sys.executable, "bench_torch.py", "--scenes", "1"],
                         cwd=ROOT, capture_output=True, text=True, env=_env(),
                         timeout=120)
    assert out.returncode != 0
    assert "device='cpu'" in out.stderr
    assert '"metric"' not in out.stdout
