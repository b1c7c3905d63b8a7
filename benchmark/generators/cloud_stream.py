"""One robot with a depth camera and no object models: ``/plan_cloud``
bodies of a set of observed clouds (the obstacle points and the target's
hand poses), sent by one client in a closed loop.

A traffic file that names this generator (``"generator":
"cloud_stream"``) holds ``scene_stream``'s keys: ``scenes``, a directory
of ``scene_<k>.npz`` files under ``benchmark/`` (``points`` [N, 3],
``grasps`` [K, 4, 4]) with a ``manifest.json`` whose steps rank them for
the strata; ``start``; ``strata``; ``warmup_scenes`` and
``warmup_start_nudge``.  The order, the warm-up, the answers and the
client are ``scene_stream``'s; only the handler and the bodies differ.
"""

from __future__ import annotations

import os

import numpy as np

import harness

_stream = harness.generator({"generator": "scene_stream"})

HANDLER = "plan_cloud_request"

warmup = _stream.warmup
answers = _stream.answers
drive = _stream.drive


def cloud_body(path: str, start) -> dict:
    """The ``/plan_cloud`` body of a frozen observation: the points, each
    grasp as 16 row-major floats, and the start configuration."""
    d = np.load(path)
    return {"points": d["points"].tolist(),
            "grasps": d["grasps"].reshape(len(d["grasps"]), 16).tolist(),
            "start": [float(v) for v in start]}


def plans(traffic: dict) -> list:
    """Every observation of the traffic's set, as ``/plan_cloud`` bodies,
    by index."""
    root = os.path.join(_stream.BENCH, traffic["scenes"])
    n = len([f for f in os.listdir(root) if f.startswith("scene_")])
    return [cloud_body(os.path.join(root, f"scene_{k}.npz"),
                       traffic["start"]) for k in range(n)]
