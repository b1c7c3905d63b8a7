"""A configuration that brings its own reference and its own counted kernel
as new files only, driven through whole runs on the CPU (the look for a
card skipped).  The stand-in (``standin/``: a configuration file naming
``reference`` and ``kernels``, the reference module, the kernel's work
module and the cells' limits) is found by name in place of
``benchmark/reference/``, ``kernels/`` and ``limits/``.  A configuration
that names no reference still gets ``check.py``'s comparison, called as
it always was."""

import copy
import functools
import os

import pytest
import torch

import harness
import probes
from reference import check

STANDIN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "standin")
SEED = 2 ** 33 + 7
SECONDS = 2.0


def _bench() -> dict:
    """BENCHMARK.json with the stand-in configuration and two cells of it
    on the fresh traffic: ``standin_fresh`` and ``standin_short``, whose
    limits leave out the stand-in's reading."""
    bench = copy.deepcopy(harness.load_benchmark())
    bench["configs"].append({
        "name": "standin", "source": "the harness's tests", "reduced": [],
        "file": os.path.relpath(os.path.join(STANDIN, "configs",
                                             "standin.json"), harness.ROOT),
        "why": "a configuration with its own reference and kernel"})
    for cell in ("standin_fresh", "standin_short"):
        bench["workloads"].append({
            "name": cell, "config": "standin", "traffic": "fresh",
            "chips": 1, "why": "the stand-in on the fresh traffic"})
    return bench


def _run(cell, bench=None, **kw):
    torch.set_num_threads(4)
    return harness.run_cell(cell, SEED, SECONDS, kw.pop("trace", False),
                            device="cpu", bench=bench,
                            log=lambda *a, **k: None, **kw)


@pytest.fixture
def seen(monkeypatch):
    """The stand-in's folders in place of the benchmark's; records the
    reference module and the probes that each run makes."""
    real = harness.folder
    monkeypatch.setattr(
        harness, "folder", lambda kind: os.path.join(STANDIN, kind)
        if kind in ("reference", "kernels", "limits") else real(kind))
    out = {"refs": [], "probes": []}
    load = harness.reference_of

    def reference_of(conf):
        out["refs"].append(load(conf))
        return out["refs"][-1]

    class Recorded(probes.Probes):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            out["probes"].append(self)

    monkeypatch.setattr(harness, "reference_of", reference_of)
    monkeypatch.setattr(probes, "Probes", Recorded)
    return out


@pytest.fixture
def spied(monkeypatch):
    """``check.check_request`` and ``check_control``, each call's
    arguments recorded."""
    calls = {"check_request": [], "check_control": []}
    for name in calls:
        def spy(*a, _orig=getattr(check, name), _calls=calls[name], **k):
            _calls.append((a, k))
            return _orig(*a, **k)
        monkeypatch.setattr(check, name, spy)
    return calls


def test_standin_reference_and_kernel_run_in_place_of_the_primitives(
        seen, spied, monkeypatch):
    from omg_planner_torch.ops import kernels

    # the program's chomp_step, its calls counted beneath the probes
    sizes = []
    orig = kernels.chomp_step

    def chomp_step(*a, **k):
        sizes.append(a[0].numel())
        return orig(*a, **k)

    monkeypatch.setattr(kernels, "chomp_step",
                        functools.update_wrapper(chomp_step, orig))
    window = {}

    def count():
        # after set-up: the kernel is wrapped over the program's function
        # and keeps its attributes; count from here as a profiled window
        # does
        assert kernels.chomp_step.__wrapped__ is chomp_step
        assert kernels.chomp_step.launches == orig.launches
        window["from"] = len(sizes)
        seen["probes"][-1].counting = True

    out = _run("standin_fresh", _bench(), trace=True, faults=count)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"standin_reach_gap", "unanswered",
                                  "plans_checked"}
    ref = seen["refs"][-1]
    assert ref.__name__ == "reference.standin"
    n = out["checks"]["plans_checked"]["value"]
    assert n > 0 and len(ref.CALLS) == n
    assert out["checks"]["standin_reach_gap"]["value"] == max(ref.CALLS)
    assert spied == {"check_request": [], "check_control": []}
    # one count of the stand-in's work module a call in the window
    counted = seen["probes"][-1].named_launch_work()
    assert len(sizes) > window["from"]
    assert counted == {"chomp_step": [(float(s), 4.0 * s)
                                      for s in sizes[window["from"]:]]}
    assert kernels.chomp_step is chomp_step


def _shifted_last_waypoint():
    from omg_planner_torch.planner import runner

    orig = runner.PackedResult.result

    def broken(self):
        res, n = orig(self)
        traj = res.traj.copy()
        traj[-1] += 0.05
        return res._replace(traj=traj), n
    runner.PackedResult.result = broken
    return lambda: setattr(runner.PackedResult, "result", orig)


def test_planted_fault_fails_the_standin_reading(seen):
    undo = []
    try:
        out = _run("standin_fresh", _bench(),
                   faults=lambda: undo.append(_shifted_last_waypoint()))
    finally:
        for u in undo:
            u()
    assert not out["correct"]
    gap = out["checks"]["standin_reach_gap"]
    assert gap["value"] > gap["limit"]


def test_limits_missing_a_reading_are_refused_at_setup(seen):
    with pytest.raises(RuntimeError, match="standin_reach_gap"):
        _run("standin_short", _bench())
    assert seen["probes"] == []


def test_configuration_without_a_reference_calls_check_as_before(spied):
    out = _run("analytic_fresh", control=True)
    assert out["correct"], out["checks"]
    n = out["checks"]["plans_checked"]["value"]
    requests, controls = spied["check_request"], spied["check_control"]
    assert n > 0 and len(requests) == len(controls) == n
    readings = requests[0][1]["out"]
    assert type(readings) is check.Readings
    for (args, kw), (c_args, c_kw) in zip(requests, controls):
        assert len(args) == 2 and args[1] is True
        assert set(args[0]) == {"body", "goal_set", "steps", "result"}
        assert kw.keys() == {"out"} and kw["out"] is readings
        assert len(c_args) == 2 and c_args[0] is args[0] and \
            c_args[1] is True and c_kw == {}
    for name, c in out["checks"].items():
        if name not in ("unanswered", "plans_checked"):
            assert c["value"] == float(readings.get(name, 0.0))
