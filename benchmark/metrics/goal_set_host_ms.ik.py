"""The goal-set build's IK a request: the program's ``goal_set.ik`` spans
(the IK sweep: prefilter, chain, the ``increment_iks`` pass) over the
number of ``request`` spans, in the profiled requests."""

import program_spans


def read(run):
    return program_spans.ms_per(run, "goal_set.ik", "request")
