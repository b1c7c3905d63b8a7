"""How much of the plan loop runs as CUDA-graph replays: the program's
``plan.graph.replay`` spans (``planner/plan.py::_GraphedUpdates``) over
its ``plan.chomp`` and ``plan.learner`` spans, in percent, in the profiled
requests (a capture, which also runs its update, is not a replay); None
where the program recorded no ``plan.graph.`` span (a checkout without
the graphs, or plans that never reach them)."""

import program_spans


def read(run):
    recorded = program_spans.spans(run)
    if not any(s.name.startswith("plan.graph.") for s in recorded):
        return None
    updates = sum(s.name in ("plan.chomp", "plan.learner") for s in recorded)
    replays = sum(s.name == "plan.graph.replay" for s in recorded)
    return 100.0 * replays / updates if updates else None
