"""The port's spans and host-read counters (``utils/timing.py``,
``utils/sync.py``) on the planning service's fresh ``/plan`` path, on the
CPU at ``tests/test_golden.py::CFG``'s size.

A fresh request of a suite scene gives the same plan bit for bit with
tracing on and off; off, it records no span.  A ``torch.profiler``
session turns tracing on by itself.  The traced request's spans form one
tree under its ``request`` span: one ``plan.step`` a step taken, a
``plan.learner`` child where the learner ran and a ``plan.chomp`` child in
each, and one ``sync.<site>`` span for each host read, matching the
per-site counts of ``SYNCS``.  The response's ``stage_s`` and ``plan_s``
split the call's wall at the plan loop's start.  The span buffer holds
threads apart and drops past its bound."""

import gc
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from omg_planner_torch.apps import serve
from omg_planner_torch.config import OMGConfig
from omg_planner_torch.utils import timing
from omg_planner_torch.utils.sync import SYNCS, host_bool

torch.set_num_threads(2)

CFG = OMGConfig(optim_steps=10, extra_smooth_steps=3, goal_set_max_num=12,
                ik_seed_num=4, ik_max_iters=30, learner_interp_steps=10,
                silent=True)
SUITE = os.path.join(os.path.dirname(__file__), "..", "data", "suite_v2")
START = [0.0, -1.285, 0.0, -2.356, 0.0, 1.571, 0.785, 0.04, 0.04]


def _suite_body(k: int) -> dict:
    """The ``/plan`` body of suite scene ``k`` (``data/suite_v2``)."""
    d = dict(np.load(os.path.join(SUITE, f"scene_{k}.npz"),
                     allow_pickle=True))
    target = str(d["target_name"])
    objects = [{"name": str(n), "kind": str(kind),
                "extents": [float(v) for v in
                            np.trim_zeros(np.asarray(ext), "b")],
                "pose": [float(v) for v in np.asarray(pose).reshape(-1)],
                "target": str(n) == target}
               for kind, ext, pose, n in zip(d["kinds"], d["extents"],
                                             d["poses"], d["names"])]
    return {"objects": objects, "start": START}


def _fresh_request(traced: bool):
    """A fresh ``/plan`` of suite scene 0: (response, wall s, spans, the
    per-site host reads it took)."""
    body = _suite_body(0)
    serve._SCENE_CACHE.clear()
    sites0 = dict(SYNCS.sites)
    count0 = SYNCS.count
    timing.take()
    timing.enable(traced)
    # a collector pass between the handler's marks and the caller's clock
    # would show as a gap that the timings rightly leave out
    gc.disable()
    try:
        t0 = time.perf_counter()
        code, out = serve.plan_request(body, CFG, "cpu")
        wall = time.perf_counter() - t0
    finally:
        gc.enable()
        timing.enable(False)
        serve._SCENE_CACHE.clear()
    assert code == 200, out
    reads = {k: v - sites0.get(k, 0) for k, v in SYNCS.sites.items()
             if v != sites0.get(k, 0)}
    assert sum(reads.values()) == SYNCS.count - count0
    return out, wall, timing.take(), reads


@pytest.fixture(scope="module")
def runs():
    return {"off": _fresh_request(False), "on": _fresh_request(True)}


def test_tracing_changes_no_bit_of_the_plan(runs):
    off, on = runs["off"][0], runs["on"][0]
    for key in ("traj", "goal_idx", "steps_used", "flag", "n_goals"):
        assert off[key] == on[key], key
    assert runs["off"][3] == runs["on"][3]


def test_no_span_recorded_when_off(runs):
    assert runs["off"][2] == []


def test_profiler_session_turns_tracing_on():
    timing.take()
    assert not timing.active()
    with profile(activities=[ProfilerActivity.CPU]):
        assert timing.active()
        serve._build_scene(CFG, _suite_body(2), "cpu")
    assert not timing.active()
    names = [s.name for s in timing.take()]
    assert sorted(names) == ["scene_build", "scene_build.objects",
                             "scene_build.scene"]


def test_span_tree_of_a_traced_request(runs):
    out, _, spans, reads = runs["on"]
    by_id = {s.id: s for s in spans}
    (req,) = [s for s in spans if s.name == "request"]
    for s in spans:
        assert s.request == req.id, s
        assert req.start_ns <= s.start_ns <= s.end_ns <= req.end_ns, s
        if s is not req:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns <= s.end_ns \
                <= parent.end_ns, s
    names = {s.name for s in spans}
    assert {"scene_build", "scene_build.objects", "scene_build.scene",
            "scene_stage", "goal_set", "goal_set.ik", "goal_set.filter",
            "goal_set.prune", "goal_set.dedupe", "goal_set.sample",
            "goal_set.init", "plan", "plan.init", "plan.step",
            "plan.learner", "plan.chomp", "plan.control", "plan.finish",
            "harvest"} <= names
    for s in spans:
        if s.name.startswith("goal_set."):
            assert by_id[s.parent].name == "goal_set", s
        if s.name in ("plan.init", "plan.step", "plan.finish"):
            assert by_id[s.parent].name == "plan", s

    steps = sorted((s for s in spans if s.name == "plan.step"),
                   key=lambda s: s.start_ns)
    assert len(steps) == out["steps_used"]
    for i, step in enumerate(steps):
        kids = [s.name for s in spans if s.parent == step.id]
        learned = i < CFG.optim_steps and i % CFG.learner_sweep_every == 0
        assert kids.count("plan.learner") == int(learned), (i, kids)
        assert kids.count("plan.chomp") == 1 and \
            kids.count("plan.control") == 1, (i, kids)

    # one sync.<site> span a host read, every read named by its site
    synced = {}
    for s in spans:
        if s.name.startswith("sync."):
            site = s.name[len("sync."):]
            synced[site] = synced.get(site, 0) + 1
    assert synced == reads
    assert "unattributed" not in reads
    assert reads["plan.terminate"] == out["steps_used"] - 1


def test_timings_split_the_call_at_the_plan(runs):
    for out, wall, spans, _ in runs.values():
        t = out["timings"]
        assert abs(t["stage_s"] + t["plan_s"] - wall) < 5e-3, (t, wall)
        assert t["stage_s"] > 0 and t["plan_s"] > 0
    out, _, spans, _ = runs["on"]
    (plan,) = [s for s in spans if s.name == "plan"]
    # the response rounds to 0.1 ms
    assert out["timings"]["plan_s"] + 5e-5 >= (plan.end_ns
                                               - plan.start_ns) * 1e-9


def test_site_counts_sum_to_the_total_from_any_reset():
    saved = dict(SYNCS.sites)
    try:
        SYNCS.count = 0
        assert SYNCS.count == 0 and SYNCS.sites == {}
        t = torch.tensor(True)
        host_bool(t, "a.one")
        host_bool(t, "a.one")
        host_bool(t, "a.two")
        assert SYNCS.sites == {"a.one": 2, "a.two": 1} and SYNCS.count == 3
        SYNCS.count = 5
        host_bool(t, "a.one")
        assert SYNCS.count == 6 == sum(SYNCS.sites.values())
    finally:
        SYNCS.sites = saved


def test_threads_keep_their_own_trees():
    """Eight threads open nested spans and host reads at once, with the
    interpreter switching threads often: every span's parent and request
    are its own thread's, and no read or span is lost."""
    n_threads, rounds = 8, 200
    timing.take()
    reads0 = SYNCS.sites.get("trace_test.read", 0)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    timing.enable()
    errors = []

    def work():
        try:
            t = torch.tensor(True)
            with timing.request():
                for _ in range(rounds):
                    with timing.span("outer"):
                        with timing.span("inner"):
                            host_bool(t, "trace_test.read")
        except Exception as e:  # surfaced by the assertion below
            errors.append(e)

    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        timing.enable(False)
        sys.setswitchinterval(old)
    assert not errors
    spans = timing.take()
    assert SYNCS.sites["trace_test.read"] - reads0 == n_threads * rounds
    by_id = {s.id: s for s in spans}
    requests = [s for s in spans if s.name == "request"]
    assert len(requests) == n_threads
    assert len(spans) == n_threads * (1 + 3 * rounds)
    want = {"outer": "request", "inner": "outer",
            "sync.trace_test.read": "inner"}
    for s in spans:
        if s.name != "request":
            parent = by_id[s.parent]
            assert parent.name == want[s.name]
            assert parent.request == s.request


def test_buffer_drops_past_its_bound(monkeypatch):
    monkeypatch.setattr(timing, "SPAN_LIMIT", 3)
    timing.take()
    dropped0 = timing.TRACE.dropped
    timing.enable()
    try:
        for _ in range(5):
            with timing.span("x"):
                pass
    finally:
        timing.enable(False)
    assert len(timing.take()) == 3
    assert timing.TRACE.dropped - dropped0 == 2
