"""The goal-set build's diversity dedupe a request, its per-round host
reads included: the program's ``goal_set.dedupe`` spans over the number
of ``request`` spans, in the profiled requests."""

import program_spans


def read(run):
    return program_spans.ms_per(run, "goal_set.dedupe", "request")
