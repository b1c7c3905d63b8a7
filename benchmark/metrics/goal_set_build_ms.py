"""The goal-set build per fresh request: ``PlanningScene.build_problem``
(IK, the filters, pruning, dedupe and sampling, the initial goal and
spline) less the collision scene's staging nested in it."""


def _nested(spans, outer, inner):
    outs = [(t0, t1) for n, t0, t1 in spans if n == outer]
    total = 0.0
    for n, t0, t1 in spans:
        if n == inner and any(a <= t0 and t1 <= b for a, b in outs):
            total += t1 - t0
    return total


def read(run):
    n = len(run.requests)
    if not n:
        return None
    own = run.span_sum("goal_set") - _nested(run.spans, "goal_set",
                                             "scene_stage")
    return own * 1e3 / n
