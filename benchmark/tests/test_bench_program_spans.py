"""The readers of the program's own spans (``program_spans.py`` and the
``plan_step_host_ms.*``, ``host_sync_wait_ms.request`` and
``goal_set_host_ms.*`` metrics) on a synthetic span list, and None where
the program recorded no span."""

import pytest

import harness
import program_spans
from omg_planner_torch.utils import timing
from omg_planner_torch.utils.timing import Span

MS = 1_000_000  # ns


def _run(spans):
    run = harness.Run({"name": "analytic_fresh"}, {})
    if spans is not None:
        run.program_spans = spans
    return run


def _spans():
    """Two requests: the first builds its goal set and plans 3 steps (the
    learner on 2), the second plans 1 step (no learner); host reads in
    both."""
    out, ids = [], iter(range(1, 1000))

    def add(name, t0, t1, parent=0, request=1):
        i = next(ids)
        out.append(Span(name, t0 * MS, t1 * MS, parent, request, i))
        return i

    r1 = add("request", 0, 100)
    gs = add("goal_set", 1, 40, r1)
    add("goal_set.ik", 2, 12, gs)             # 10 ms
    add("sync.ik.chain", 3, 4, gs)            # 1 ms
    add("goal_set.filter", 12, 30, gs)        # 18 ms
    add("goal_set.dedupe", 30, 34, gs)        # 4 ms
    add("sync.goal_set.dedupe", 31, 33, gs)   # 2 ms
    plan = add("plan", 40, 99, r1)
    for k, learner in enumerate((True, False, True)):
        t = 41 + 10 * k
        step = add("plan.step", t, t + 9, plan)
        if learner:
            add("plan.learner", t, t + 3, step)   # 3 ms
        add("plan.chomp", t + 3, t + 7, step)     # 4 ms
        add("sync.plan.terminate", t + 7, t + 8, step)  # 1 ms
    r2 = add("request", 200, 240, 0, 2)
    plan2 = add("plan", 210, 230, r2, 2)
    step = add("plan.step", 211, 220, plan2, 2)
    add("plan.chomp", 212, 218, step, 2)          # 6 ms
    return out


EXPECTED = {
    # 6 ms of learner over 4 steps
    "plan_step_host_ms.learner": 6 / 4,
    # 12 + 6 ms of CHOMP over 4 steps
    "plan_step_host_ms.chomp": 18 / 4,
    # 1 + 2 + 3 ms of reads over 2 requests
    "host_sync_wait_ms.request": 6 / 2,
    "goal_set_host_ms.ik": 10 / 2,
    "goal_set_host_ms.filter": 18 / 2,
    "goal_set_host_ms.dedupe": 4 / 2,
}


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_synthetic_spans(metric):
    assert harness.reader(metric)(_run(_spans())) == \
        pytest.approx(EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_is_none_without_spans(metric):
    assert harness.reader(metric)(_run([])) is None


def test_spans_taken_from_the_tracer_once():
    """A run with no spans of its own takes the tracer's, once: every
    reader of one run sees the same list, and the tracer is left empty."""
    timing.take()
    timing.enable()
    try:
        with timing.request():
            with timing.span("plan.step"):
                with timing.span("plan.chomp"):
                    pass
    finally:
        timing.enable(False)
    run = _run(None)
    first = program_spans.spans(run)
    assert [s.name for s in first] == ["plan.chomp", "plan.step",
                                       "request"]
    assert program_spans.spans(run) is first
    assert harness.reader("plan_step_host_ms.chomp")(run) > 0
    assert harness.reader("plan_step_host_ms.learner")(run) == 0
    assert timing.take() == []
    assert harness.reader("plan_step_host_ms.chomp")(_run(None)) is None
