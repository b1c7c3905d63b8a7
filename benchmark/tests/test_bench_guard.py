"""The import guard compares whole top-level names; the reference imports
nothing of JAX, the JAX package or the program."""

import os
import subprocess
import sys

import guard

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_whole_top_level_names():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax": 1,
            "omg_planner_tpu.ops": 1, "omg_planner_torch": 1,
            "omg_planner_torch.ops": 1, "jaxtyping": 1, "torch": 1}
    assert guard.loaded_forbidden(mods) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "omg_planner_tpu.ops"]


def test_reference_sources_import_nothing_forbidden():
    assert guard.reference_imports(os.path.join(HERE, "reference")) == {}


def test_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r); "
            "from reference import check, plain, primitives; "
            "import guard; "
            "print(guard.loaded_forbidden(forbidden=guard.FORBIDDEN "
            "+ (guard.PROGRAM,)))" % HERE)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_harness_sources_import_no_jax():
    for name in os.listdir(HERE):
        if name.endswith(".py"):
            assert not guard.imports_of(os.path.join(HERE, name)) & set(
                guard.FORBIDDEN), name


def test_run_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, os.path.join(HERE, "run.py"), "--workload",
         "analytic_fresh", "--seed", str(2 ** 31 + 11), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr
