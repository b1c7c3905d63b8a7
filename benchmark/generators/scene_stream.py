"""One robot's requests: ``/plan`` bodies of a scene set, sent by one
client in a closed loop (the next request when the last has returned).

A traffic file that names this generator (``"generator":
"scene_stream"``) holds, besides the harness's own keys:

* ``scenes``: the scene set, a directory of ``scene_<k>.npz`` files under
  ``benchmark/``; ``start``: the robot's start configuration;
* ``strata``: the order, every scene once a pass, pass after pass, so
  that each seed sends the same scenes in another order: the scenes
  ranked by their planning steps in the scene set's ``manifest.json`` and
  cut into ``strata`` equal groups, each block of ``strata`` requests one
  scene of every group (groups and members in seeded orders), so that
  every stretch of the stream holds nearly the suite's mix of short and
  long plans, whatever the seed;
* ``warmup_scenes`` and ``warmup_start_nudge``: the set-up's requests,
  those scenes with the start's first joint moved by the nudge, so that
  no measured workspace is staged by them.

Every generator module names the service's handler (``HANDLER``, a
function of ``omg_planner_torch.apps.serve``) and gives ``plans`` (the
plan bodies by index), ``warmup`` (the set-up's request bodies),
``answers`` (a response's per-plan answers) and ``drive`` (the client:
it sends requests through ``client.send`` until ``client.deadline``).
"""

from __future__ import annotations

import json
import os

import numpy as np

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

HANDLER = "plan_request"


def scene_body(path: str, start) -> dict:
    """The ``/plan`` body of a pinned primitive scene: each object's
    name, kind, extents (trailing zeros dropped), row-major pose and
    target flag, and the start configuration."""
    d = dict(np.load(path, allow_pickle=True))
    target = str(d["target_name"])
    objects = []
    for kind, ext, pose, name in zip(d["kinds"], d["extents"], d["poses"],
                                     d["names"]):
        objects.append({
            "name": str(name), "kind": str(kind),
            "extents": [float(v) for v in np.trim_zeros(np.asarray(ext),
                                                        "b")],
            "pose": [float(v) for v in np.asarray(pose).reshape(-1)],
            "target": str(name) == target})
    return {"objects": objects, "start": [float(v) for v in start]}


def plans(traffic: dict) -> list:
    """Every scene of the traffic's set, as ``/plan`` bodies, by index."""
    root = os.path.join(BENCH, traffic["scenes"])
    n = len([f for f in os.listdir(root) if f.startswith("scene_")])
    return [scene_body(os.path.join(root, f"scene_{k}.npz"),
                       traffic["start"]) for k in range(n)]


def strata(traffic: dict, n: int) -> list:
    """The scene set's indices ranked by planning steps (the manifest's),
    cut into ``traffic["strata"]`` equal groups."""
    with open(os.path.join(BENCH, traffic["scenes"], "manifest.json")) as f:
        steps = {s["scene"]: s["steps"] for s in json.load(f)["scenes"]}
    ranked = sorted(range(n), key=lambda k: (steps[k], k))
    g = traffic["strata"]
    if n % g:
        raise ValueError(f"{n} scenes do not cut into {g} equal groups")
    size = n // g
    return [ranked[i * size:(i + 1) * size] for i in range(g)]


def scene_order(traffic: dict, n: int, seed: int):
    """Scene indices, forever: every one of the ``n`` once a pass, in
    the traffic's seeded stratified order."""
    rng = np.random.default_rng(seed)
    groups = strata(traffic, n)
    while True:
        members = [[g[i] for i in rng.permutation(len(g))] for g in groups]
        for i in range(len(groups[0])):
            for s in rng.permutation(len(groups)):
                yield members[s][i]


def warmup(traffic: dict, bodies: list) -> list:
    """The set-up's request bodies: the warm-up scenes with the start
    nudged (never a measured workspace)."""
    out = []
    for k in traffic["warmup_scenes"]:
        b = json.loads(json.dumps(bodies[k]))
        b["start"][0] += traffic["warmup_start_nudge"]
        out.append(b)
    return out


def answers(resp: dict) -> list:
    return [resp]


def drive(traffic: dict, bodies: list, seed: int, client) -> None:
    """One closed-loop client: the next scene's body as soon as the last
    request has returned, until the window closes."""
    order = scene_order(traffic, len(bodies), seed)
    while client.clock() < client.deadline:
        k = next(order)
        client.send(bodies[k], [bodies[k]])
