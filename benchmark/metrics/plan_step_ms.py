"""The plan loop's time per step: every ``plan_fast`` span over every
step the window's plans took."""


def read(run):
    steps = sum(r["steps"] for r in run.requests)
    if not steps:
        return None
    return run.span_sum("plan") * 1e3 / steps
