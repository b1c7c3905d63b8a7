"""The comparison that decides ``correct``, driven through a whole run on
the CPU (the look for a card skipped): a sound run passes, the control
(the reference in float32 with TF32 products in the program's place)
fails, and each fault that a cell can have, planted in the program
underneath the harness, makes ``correct`` false.  The faults: a CHOMP
step that returns its trajectory unchanged; half of a step's body points
left out of the collision query; the answer's verdict altered where it
is produced.  (A cell on one card has no exchange between cards.)"""

import pytest
import torch

import harness

SECONDS = 2.0


def _run(faults=None, control=False, cell="analytic_fresh"):
    torch.set_num_threads(4)
    return harness.run_cell(cell, 2 ** 33 + 5, SECONDS, False, device="cpu",
                            faults=faults, control=control,
                            log=lambda *a, **k: None)


def _failed(out) -> list:
    return [k for k, c in out["checks"].items() if c["value"] > c["limit"]]


def test_sound_run_is_correct_and_the_control_is_not():
    out = _run(control=True)
    assert out["correct"], _failed(out)
    lim = harness.limits("analytic_fresh")["limits"]
    over = [k for k, v in out["control"].items() if k in lim
            and v > lim[k]]
    assert over, out["control"]


def _unchanged_step():
    from omg_planner_torch.ops import chomp

    orig = chomp.chomp_step

    def broken(model, cfg, hp, xi, *a, **k):
        return xi, orig(model, cfg, hp, xi, *a, **k)[1]
    chomp.chomp_step = broken
    return lambda: setattr(chomp, "chomp_step", orig)


def _half_the_points():
    from omg_planner_torch.ops import chomp

    orig = chomp.sdf_potentials

    def broken(scene, inv, points, *a):
        pot, grad, coll = orig(scene, inv, points, *a)
        half = points.shape[0] // 2
        pot, grad, coll = pot.clone(), grad.clone(), coll.clone()
        pot[half:] = 0
        grad[half:] = 0
        coll[half:] = 0
        return pot, grad, coll
    chomp.sdf_potentials = broken
    return lambda: setattr(chomp, "sdf_potentials", orig)


def _altered_verdict():
    from omg_planner_torch.planner import runner

    orig = runner.PackedResult.result

    def broken(self):
        res, n = orig(self)
        return res._replace(flag=not res.flag), n
    runner.PackedResult.result = broken
    return lambda: setattr(runner.PackedResult, "result", orig)


@pytest.mark.parametrize("plant", [_unchanged_step, _half_the_points,
                                   _altered_verdict])
def test_planted_fault_is_not_correct(plant):
    undo = []
    try:
        out = _run(faults=lambda: undo.append(plant()))
    finally:
        for u in undo:
            u()
    assert not out["correct"]
