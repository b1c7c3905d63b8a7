"""Host reads for control flow (the program's ``utils/sync.py::SYNCS``)
per request of the window."""


def read(run):
    return run.syncs / len(run.requests) if run.requests else None
