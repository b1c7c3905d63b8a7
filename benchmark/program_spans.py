"""The program's own spans of a traced run's profiled requests.

The program records spans (``omg_planner_torch/utils/timing.py``) while a
``torch.profiler`` session runs, so a ``--trace 1`` run's profiled
requests leave theirs in the tracer's buffer, on the host clock of the
device trace (``time.perf_counter``, in ns).  ``spans`` takes them once a
run; a checkout whose program records none (no tracer, an untraced run,
the CPU) gives [] and every reader below None.
"""

from __future__ import annotations


def spans(run) -> list:
    """The program's spans of ``run`` (``Span`` tuples: name, start_ns,
    end_ns, parent, request, id), taken from the tracer on the first
    call."""
    taken = getattr(run, "program_spans", None)
    if taken is None:
        try:
            from omg_planner_torch.utils.timing import take
        except ImportError:
            taken = []
        else:
            taken = take()
        run.program_spans = taken
    return taken


def ms_per(run, name: str, per: str):
    """The time of every span named ``name`` (or, for a name ending in
    ``.``, every span whose name starts with it) in ms, over the number
    of ``per`` spans; None where no ``per`` span was recorded."""
    recorded = spans(run)
    n = sum(s.name == per for s in recorded)
    if not n:
        return None
    if name.endswith("."):
        hits = [s for s in recorded if s.name.startswith(name)]
    else:
        hits = [s for s in recorded if s.name == name]
    return sum(s.end_ns - s.start_ns for s in hits) * 1e-6 / n
