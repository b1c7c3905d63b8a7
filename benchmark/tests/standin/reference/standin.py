"""A stand-in reference for the harness's tests.  Its one reading: how far
the answer's reported distance to the goal lies from its last waypoint's
distance to the nearest valid goal of the plan's goal set, over the
larger of that distance and 1e-3.  ``CALLS`` keeps each request's
reading, in order."""

from __future__ import annotations

import numpy as np

CHECKS = ("standin_reach_gap",)
CALLS = []


def _reach_gap(rec: dict, dtype) -> float:
    grasps, _, mask, _ = rec["goal_set"]
    goals = grasps[mask.bool()].double().numpy().astype(dtype)
    if not len(goals):
        return 0.0
    last = np.asarray(rec["result"]["traj"], np.float64)[-1].astype(dtype)
    reach = rec["result"]["reach"]
    dist = np.linalg.norm(goals - last, axis=-1).astype(np.float64)
    return float(np.abs(dist - reach).min()) / max(reach, 1e-3)


def check_request(rec, conf, cfg, out):
    gap = _reach_gap(rec, np.float64)
    CALLS.append(gap)
    out.worst("standin_reach_gap", gap)


def check_control(rec, conf, cfg):
    return {"standin_reach_gap": _reach_gap(rec, np.float16)}
