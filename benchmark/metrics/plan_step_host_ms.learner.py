"""The learner sweep's host time a plan step: the program's
``plan.learner`` spans (``ops/learner.py::update_goal``) over the number
of ``plan.step`` spans, in the profiled requests (the program's own spans,
no device synchronise)."""

import program_spans


def read(run):
    return program_spans.ms_per(run, "plan.learner", "plan.step")
