"""The arithmetic of the benchmark's numbers over all samples of a
window."""

import numpy as np
import pytest

import stats


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_is_numpys_linear(q):
    rng = np.random.default_rng(3)
    v = rng.exponential(size=257).tolist()
    assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q))


def test_percentile_of_one_sample_and_of_none():
    assert stats.percentile([4.0], 95) == 4.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_rate_and_share():
    assert stats.rate(300, 30.0) == 10.0
    assert stats.share_pct(17, 20) == pytest.approx(85.0)
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)


def test_union_and_gaps_and_idle():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.7)]
    assert stats.union_length(iv) == pytest.approx(3.0)
    assert stats.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0),
                                          (4.0, 5.0)]
    assert stats.idle_pct(3.0, 6.0) == pytest.approx(50.0)


def test_metric_readers_on_a_window():
    import harness

    run = harness.Run({"name": "analytic_fresh"}, {})
    run.window_s = 2.0
    run.requests = [
        {"wall_s": w, "ok": ok, "plans": 1, "successes": s, "steps": 10}
        for w, ok, s in ((0.1, True, 1), (0.3, True, 0), (0.2, False, 0),
                         (0.4, True, 1))]
    run.spans = [("plan", 0.0, 0.5), ("plan", 1.0, 1.5)]
    run.syncs = 40
    assert harness.reader("request_p50_ms")(run) == pytest.approx(300.0)
    assert harness.reader("plan_success_pct")(run) == pytest.approx(50.0)
    assert harness.reader("request_p95_ms")(run) == pytest.approx(390.0)
    assert harness.reader("plan_step_ms")(run) == pytest.approx(25.0)
    assert harness.reader("host_syncs_per_request")(run) == 10
    assert harness.reader("device_idle_pct.request")(run) is None


@pytest.mark.parametrize("base", ["request_p50_ms", "scene_build_ms",
                                  "goal_set_build_ms"])
def test_voxel_readers_read_as_their_base(base):
    import harness

    run = harness.Run({"name": "voxel_fresh"}, {})
    run.requests = [{"wall_s": w, "ok": True, "plans": 1, "successes": 1,
                     "steps": 2} for w in (0.05, 0.07, 0.2)]
    run.spans = [("scene_build", 0.0, 0.004), ("goal_set", 0.004, 0.02),
                 ("scene_stage", 0.005, 0.008), ("scene_build", 1.0, 1.003)]
    value = harness.reader(base + ".voxel")(run)
    assert value is not None and value > 0
    assert value == harness.reader(base)(run)
