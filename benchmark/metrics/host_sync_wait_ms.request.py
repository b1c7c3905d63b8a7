"""The host's wait on the device's reads a request: every program
``sync.<site>`` span (``utils/sync.py``, one a control-flow read) over the
number of ``request`` spans, in the profiled requests."""

import program_spans


def read(run):
    return program_spans.ms_per(run, "sync.", "request")
