"""The CHOMP update's host time a plan step: the program's ``plan.chomp``
spans (``planner/plan.py::_optimize_once``) over the number of
``plan.step`` spans, in the profiled requests."""

import program_spans


def read(run):
    return program_spans.ms_per(run, "plan.chomp", "plan.step")
