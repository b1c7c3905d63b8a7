"""Hand kernels counted by name: in a traced run the probes wrap a kernel
that the configuration names and, while counting, record its work
module's count for each call; the device trace finds the kernel's
operations by the module's ``OPS``; the two kernels that the probes
count themselves may not be named; a configuration that names none gets
the probes it always had."""

import types

import pytest

import devtrace
import harness
import probes
from omg_planner_torch.ops import kernels

# a stand-in kernel's work module: a count from the call's arguments, and
# one that defers its count until after the window
WORK = types.SimpleNamespace(
    OPS=("standin_kernel_fwd",),
    work=lambda args, kwargs: (float(args[0]), 8.0 * kwargs.get("s", 1.0)))
DEFERRED = types.SimpleNamespace(
    OPS=WORK.OPS, work=lambda args, kwargs: lambda: (2.0 * args[0], 1.0))
TODAY = ["plan_fast"] * 3 + ["_chomp_update", "_fk_query", "chomp_obstacle",
                             "sdf_query", "_build_scene", "stage_scene",
                             "build_problem"]


@pytest.fixture
def standin_kernel(monkeypatch):
    calls = []

    def standin_kernel(x, s=1.0):
        calls.append(x)
        return x * s

    standin_kernel.launches = 7
    monkeypatch.setattr(kernels, "standin_kernel", standin_kernel,
                        raising=False)
    return standin_kernel, calls


@pytest.mark.parametrize("mod, expected", [
    (WORK, [(2.0, 24.0), (4.0, 8.0)]),
    (DEFERRED, [(4.0, 1.0), (8.0, 1.0)])])
def test_counting_records_one_work_a_call(standin_kernel, mod, expected):
    orig, calls = standin_kernel
    pr = probes.Probes(spans=True, cuda=False,
                       kernels={"standin_kernel": mod})
    pr.install()
    try:
        wrapped = kernels.standin_kernel
        assert [n for _, n, _ in pr._saved] == TODAY + ["standin_kernel"]
        assert wrapped.__wrapped__ is orig
        assert wrapped.launches == 7 and wrapped.__name__ == "standin_kernel"
        wrapped(1.0)
        pr.counting = True
        assert wrapped(2.0, s=3.0) == 6.0
        wrapped(4.0)
        pr.counting = False
        wrapped(5.0)
    finally:
        pr.uninstall()
    assert kernels.standin_kernel is orig
    assert calls == [1.0, 2.0, 4.0, 5.0]
    assert pr.named_launch_work() == {"standin_kernel": expected}


def test_untraced_run_wraps_no_named_kernel(standin_kernel):
    pr = probes.Probes(spans=False, cuda=False,
                       kernels={"standin_kernel": WORK})
    pr.install()
    try:
        assert kernels.standin_kernel is standin_kernel[0]
    finally:
        pr.uninstall()


def test_no_named_kernel_gets_todays_probes():
    pr = probes.Probes(spans=True, cuda=False)
    pr.install()
    try:
        assert [n for _, n, _ in pr._saved] == TODAY
    finally:
        pr.uninstall()
    assert set(pr.launches) == set(probes.COUNTED)
    assert pr.named_launch_work() == {}
    bench = harness.load_benchmark()
    for w in bench["workloads"]:
        assert harness.kernels_of(harness.config_of(bench, w["config"])) == {}


def test_device_trace_finds_a_named_kernels_operations():
    ops = [("void standin_kernel_fwd<float>(float*)", 0.0, 0.5),
           ("chomp_obstacle_kernel", 1.0, 1.25),
           ("void standin_kernel_fwd<float>(float*)", 2.0, 2.125),
           ("elementwise_kernel", 3.0, 4.0)]
    trace = devtrace.DeviceTrace(ops, 5.0, {}, {"standin_kernel": WORK.OPS})
    assert trace.kernel_seconds("standin_kernel") == (2, 0.625)
    assert trace.kernel_seconds("chomp_obstacle") == (1, 0.25)
    with pytest.raises(KeyError):
        devtrace.DeviceTrace(ops, 5.0, {}).kernel_seconds("standin_kernel")


@pytest.mark.parametrize("name", probes.COUNTED)
def test_configuration_naming_a_probes_own_kernel_is_refused(name):
    with pytest.raises(RuntimeError, match=name):
        harness.kernels_of({"kernels": ["standin_kernel", name]})
