"""``cfg.report_time`` and ``cfg.report_cost`` of the port's
``PlanningScene.step`` against the JAX package's, on the CPU at
``tests/test_golden.py::CFG``.

Both packages plan synthetic scene 5 with the history-keeping ``plan`` and
both flags on; the port's scene is staged with JAX's goal set (carried
across by ``interop``), since the port's own IK may order converged lanes
differently (``tests/test_torch_goal_set.py``).  The captured standard
output must hold the same ``goal set num`` line and the same number of
table rows, each row's step, collide count and limit flag equal, and its
obs, smooth and cost within 2e-3 + 1e-3 relative of JAX's printed values
(the plans agree within 2e-3 in the trajectory, ``tests/test_torch_plan.py``;
the table prints three decimals)."""

import dataclasses
import re

import jax
import numpy as np
import torch

from omg_planner_tpu.planner.scene import PlanningScene as JScene
from omg_planner_torch import interop
from omg_planner_torch.config import OMGConfig as TConfig
from omg_planner_torch.planner.scene import PlanningScene as TScene
from test_golden import CFG

torch.set_num_threads(2)
ROW = re.compile(r"step +(\d+) \| obs +(\S+) smooth +(\S+) cost +(\S+) \| "
                 r"grad +(\S+) collide +(\S+) reach +(\S+) violate (\w+)")


def _rows(out):
    return [m.groups() for m in map(ROW.match, out.splitlines()) if m]


def _goal_lines(out):
    return [ln for ln in out.splitlines() if ln.startswith("goal set num")]


def test_report_time_and_cost_match_jax(capsys):
    cfg = CFG.replace(report_cost=True, report_time=True)
    js = JScene.synthetic(cfg, scene_id=5, n_obstacles=2)
    jgoals = js.build_problem().goal_set
    capsys.readouterr()
    jres = js.step()
    jout = capsys.readouterr().out

    tcfg = TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(cfg)})
    ts = TScene.synthetic(tcfg, scene_id=5, n_obstacles=2, device="cpu")
    goals = interop.plan_problem(
        jax.tree.map(np.asarray, js.build_problem()._replace(
            goal_set=jgoals)), "cpu").goal_set
    ts._staged = (ts._staged_key(), goals, None)
    tres = ts.step()
    tout = capsys.readouterr().out

    assert _goal_lines(tout) == _goal_lines(jout)
    assert len(_goal_lines(tout)) == 1
    jrows, trows = _rows(jout), _rows(tout)
    assert len(trows) == len(jrows) == int(jres.steps_used) \
        == int(tres.steps_used) > 0
    for j, t in zip(jrows, trows):
        assert (t[0], t[5], t[7]) == (j[0], j[5], j[7])
        for a, b in zip(t[1:4], j[1:4]):
            assert abs(float(a) - float(b)) <= 2e-3 + 1e-3 * abs(float(b)), \
                (t, j)


def test_reports_stay_silent_by_default(capsys):
    """Both flags off (the default): no goal-set line and no table."""
    cfg = TConfig(**{f.name: getattr(CFG, f.name)
                     for f in dataclasses.fields(CFG)})
    assert not (cfg.report_cost or cfg.report_time)
    ts = TScene.synthetic(cfg, scene_id=5, n_obstacles=2, device="cpu")
    ts.build_problem()
    capsys.readouterr()
    assert ts.step() is not None
    out = capsys.readouterr().out
    assert not _goal_lines(out) and not _rows(out)
