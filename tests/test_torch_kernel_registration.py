"""The plan kernels' operators (``ops/kernels.py``: ``omg_torch::panda_fk``,
``sdf_query_analytic``, ``sdf_query_baked``) cost a fresh process nothing
to reach: no call of theirs imports ``torch._dynamo``,
``torch.distributed.tensor`` or ``sympy`` (a ``torch.library.custom_op``
does on its first call, for seconds).

One fresh interpreter (this test process has JAX and maybe those modules
loaded) times the first ``models/api.py::fk_with_joint_info_batch`` call,
plans a small synthetic scene on the CPU (``tests/test_golden.py``'s
configuration), then runs ``torch.func.vmap`` over ``kernels.sdf_query``
(analytic and baked), and reports which of the modules were loaded after
each.  Bars: none of them, and a first FK call under 0.2 s (it takes a
few milliseconds without the imports)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEAVY = ("torch._dynamo", "torch.distributed.tensor", "sympy")

_PROBE = """
import json, sys, time
import torch
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.models import api, panda
from omg_planner_torch.ops import kernels, sdf
from omg_planner_torch.planner.scene import PlanningScene

torch.set_num_threads(2)
HEAVY = %r


def loaded():
    return sorted(m for m in HEAVY if m in sys.modules)


out = {"at_import": loaded()}
model = panda.load_panda(15, "cpu")
q = (model.joint_lower + model.joint_upper)[None].repeat(4, 1) / 2
t0 = time.perf_counter()
api.fk_with_joint_info_batch(model, q)
out["first_fk_s"] = time.perf_counter() - t0
cfg = OMGConfig(optim_steps=10, extra_smooth_steps=3, goal_set_max_num=12,
                ik_seed_num=4, ik_max_iters=30, learner_interp_steps=10,
                silent=True)
scene = PlanningScene.synthetic(cfg, scene_id=5, n_obstacles=2,
                                device="cpu")
res = scene.step(fast=True)
out["plan_steps"] = int(res.steps_used)
out["fk_launches"] = kernels.panda_fk.launches
out["after_plan"] = loaded()

env = scene.env
params = env.cost_params()
rest = (params.epsilons, params.padding_scales, params.clearances,
        params.disables)
inv = params.inv_poses[None].repeat(3, 1, 1, 1)
inv[1, :, :3, 3] += 0.02
pts = torch.rand(3, 50, 3, generator=torch.Generator().manual_seed(0)) - 0.5
baked = sdf.stage_scene_sdfs([o.sdf for o in env.objects], "cpu",
                             baked=True)
for name, sc in (("analytic", env.scene_sdf()), ("baked", baked)):
    mapped = torch.func.vmap(lambda i, x: kernels.sdf_query(sc, i, x, *rest))(
        inv, pts)
    one = kernels.sdf_query(sc, inv[1], pts[1], *rest)
    out[f"vmap_{name}_rows_equal"] = all(
        torch.equal(a[1], b) for a, b in zip(mapped, one))
out["after_vmap"] = loaded()
out["jax"] = "jax" in sys.modules
print(json.dumps(out))
""" % (HEAVY,)


@pytest.fixture(scope="module")
def probe():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cpu_plan_imports_nothing_heavy(probe):
    assert probe["at_import"] == [] and not probe["jax"]
    assert probe["plan_steps"] > 0
    assert probe["after_plan"] == [], probe["after_plan"]
    assert probe["first_fk_s"] < 0.2, probe["first_fk_s"]
    assert probe["fk_launches"] == 0   # the CPU runs the plain version


def test_vmap_query_imports_nothing_heavy(probe):
    assert probe["vmap_analytic_rows_equal"]
    assert probe["vmap_baked_rows_equal"]
    assert probe["after_vmap"] == [], probe["after_vmap"]
