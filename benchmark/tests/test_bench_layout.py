"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric is found by name, in the contract's shapes."""

import json
import os
import re

import pytest

import harness

ROOT = harness.ROOT
BENCH = harness.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(map(NAME.match, names))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    w = harness.cell_of(BENCH, cell)
    conf = harness.config_of(BENCH, w["config"])
    assert {"omg_config", "published", "assumed"} <= set(conf)
    t = harness.traffic(w["traffic"])
    gen = harness.generator(t)
    assert len(gen.plans(t)) == 100
    assert {"sample_every", "trace_requests"} <= set(t)
    e2e = harness.metrics_for(BENCH, cell, False)
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.metrics_for(BENCH, cell, True)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]
                                    + BENCH["per_layer"]])
def test_metric_reader_loads(metric):
    assert callable(harness.reader(metric))


def test_moves_name_end_to_end_metrics_of_the_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        target = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in target.get("workloads", cells)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_limits_cover_every_check(cell):
    conf = harness.config_of(BENCH, harness.cell_of(BENCH, cell)["config"])
    lim = harness.limits(cell)["limits"]
    assert set(lim) == set(harness.compared(harness.reference_of(conf)))
    # the configuration's own IK acceptance, and the exact comparisons
    if "goal_pose_err" in lim:
        assert lim["goal_pose_err"] == 1.0
    for k in ("collide_excess", "goal_invalid", "flag_flips", "unanswered"):
        if k in lim:
            assert lim[k] == 0


def test_configuration_without_a_reference_compares_the_primitives():
    ref = harness.reference_of({})
    assert ref.__name__ == "reference.primitives"
    assert set(harness.compared(ref)) == {
        "fk_gap_m", "sdf_pot_gap", "sdf_grad_gap", "collide_excess",
        "obstacle_gap", "step_gap", "goal_pose_err",
        "goal_pot_gap", "goal_invalid", "final_gap", "flag_flips",
        "unanswered"}


FRESH = harness.traffic("fresh")
STREAM = harness.generator(FRESH)


def test_seeded_order_is_a_permutation_a_pass():
    gen = STREAM.scene_order(FRESH, 100, 2 ** 40 + 3)
    first = [next(gen) for _ in range(100)]
    second = [next(gen) for _ in range(100)]
    assert sorted(first) == sorted(second) == list(range(100))
    again = STREAM.scene_order(FRESH, 100, 2 ** 40 + 3)
    assert [next(again) for _ in range(100)] == first


def test_warmup_stages_no_measured_workspace():
    bodies = STREAM.plans(FRESH)
    keys = {json.dumps(b, sort_keys=True) for b in bodies}
    for b in STREAM.warmup(FRESH, bodies):
        assert json.dumps(b, sort_keys=True) not in keys


def test_stratified_stretches_hold_the_suites_mix():
    groups = STREAM.strata(FRESH, 100)
    of = {k: i for i, g in enumerate(groups) for k in g}
    for seed in (1, 2 ** 35 + 9):
        gen = STREAM.scene_order(FRESH, 100, seed)
        seq = [next(gen) for _ in range(250)]
        for n in (10, 120, 250):
            counts = [0] * len(groups)
            for k in seq[:n]:
                counts[of[k]] += 1
            assert max(counts) - min(counts) <= 1
        assert sorted(seq[:100]) == list(range(100))


@pytest.mark.parametrize("name", sorted(
    {harness.traffic(w["traffic"])["generator"] for w in BENCH["workloads"]}))
def test_generator_found_by_name_names_a_handler(name):
    from omg_planner_torch.apps import serve

    gen = harness.generator({"generator": name})
    assert callable(getattr(serve, gen.HANDLER))
    for fn in ("plans", "warmup", "answers", "drive"):
        assert callable(getattr(gen, fn))


class _Client:
    """Stands in for the harness's client: its window closes after
    ``n`` requests."""

    def __init__(self, n):
        self.sent, self.n, self.deadline = [], n, 0.5

    def clock(self):
        return len(self.sent) / self.n

    def send(self, body, plans, due=None):
        self.sent.append((body, plans))


def test_closed_loop_client_sends_the_seeded_stream():
    bodies = STREAM.plans(FRESH)
    client = _Client(200)
    STREAM.drive(FRESH, bodies, 2 ** 31 + 17, client)
    assert len(client.sent) == 100
    order = STREAM.scene_order(FRESH, 100, 2 ** 31 + 17)
    for body, plans in client.sent:
        k = next(order)
        assert body is bodies[k] and plans == [bodies[k]]
