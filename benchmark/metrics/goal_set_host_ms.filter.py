"""The goal-set build's wrist flip and task-space filter a request: the
program's ``goal_set.filter`` spans over the number of ``request`` spans,
in the profiled requests."""

import program_spans


def read(run):
    return program_spans.ms_per(run, "goal_set.filter", "request")
