"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

Everything that belongs to a configuration, a traffic mix or a metric is
found by name: ``configs/<config>.json``; ``traffic/<traffic>.json``, the
parameters of a mix, which names its generator
``generators/<generator>.py`` (the service's handler, the request bodies,
the warm-up and the client that sends them: see
``generators/scene_stream.py``) and gives the harness ``sample_every``
(one answered plan in that many, drawn from the seed, is held to the
reference, and the longest plan too) and ``trace_requests`` (the
requests a traced run profiles on the device, from the window's start);
``metrics/<metric>.py`` (each a ``read(run)`` that returns the number or
None); and the limits of the comparison in ``limits/<cell>.json``.

A new configuration is new files only:

* ``configs/<config>.json``: ``omg_config`` (the ``OMGConfig`` fields it
  sets), ``published`` (the source's sizes, checked at set-up),
  ``assumed``, and optionally ``reference`` and ``kernels`` (below);
* ``reference/<reference>.py``, the comparison that decides ``correct``;
  a file that names none gets ``reference/primitives.py``, the
  primitive-obstacle comparison of ``check.py``;
* ``kernels/<kernel>.py`` for each name in ``kernels``, a hand kernel of
  the program (``omg_planner_torch.ops.kernels.<kernel>``) whose launches
  a traced run counts for its roofline: ``OPS``, substrings of the
  kernel's device-operation names, and ``work(args, kwargs)``, a launch's
  ``(flops, bytes)`` counted from its arguments, or a callable that gives
  them after the window where the count reads the device
  (``chomp_obstacle`` and ``sdf_query`` are counted by ``probes.py``
  itself and may not be named);
* its cells' traffic (and generator, where no existing one fits), limits
  and metric readers, as above; a kernel's roofline reader reads
  ``run.kernel_work[<kernel>]`` and ``run.trace.kernel_seconds(<kernel>)``
  as ``metrics/kernel_roofline_pct.sdf_query.py`` does.

A reference module gives:

* ``CHECKS``: the names of its readings; ``limits/<cell>.json`` names
  exactly these and ``unanswered`` (the harness's own reading: requests
  not answered 200), or the run is refused at set-up;
* ``check_request(rec, conf, cfg, out)``: holds one sampled plan to the
  reference; ``rec`` is ``probes.plan_record``'s host copy of it (the
  request body, the goal set, the first and last CHOMP steps' inputs and
  outputs, the answer), ``conf`` the configuration file's contents,
  ``cfg`` the ``OMGConfig`` the program ran with, and ``out`` a
  ``check.Readings`` shared by the run's sample, where it raises each
  reading to the worst seen (``out.worst(name, value)``; entries that are
  not numbers are notes, logged and not compared);
* ``check_control(rec, conf, cfg)``: the control's readings on the same
  plan (the reference at a lower precision in the program's place), a
  new ``Readings``.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

import devtrace
import guard
import probes
import stats

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_benchmark(path: str | None = None) -> dict:
    with open(path or os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_of(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(os.path.join(ROOT, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def folder(kind: str) -> str:
    """``benchmark/<kind>/``, where the files of one kind are found by
    name."""
    return os.path.join(HERE, kind)


def _module(kind: str, name: str, module: str | None = None):
    """``<kind>/<name>.py``, loaded by its path, under the module name
    ``module`` where given."""
    path = os.path.join(folder(kind), f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        module or f"bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_of(conf: dict):
    """The reference module that the configuration names; a module of the
    ``reference`` package, so that it may import ``plain`` and ``check``
    from it."""
    name = conf.get("reference", "primitives")
    return _module("reference", name, f"reference.{name}")


def compared(ref) -> tuple:
    """The readings a run compares: the reference's and ``unanswered``."""
    return tuple(ref.CHECKS) + ("unanswered",)


def kernels_of(conf: dict) -> dict:
    """The work modules of the hand kernels the configuration names."""
    names = conf.get("kernels", [])
    own = sorted(set(names) & set(probes.COUNTED))
    if own:
        raise RuntimeError(f"kernels {own} are counted by probes.py itself; "
                           f"a configuration may not name them")
    return {k: _module("kernels", k) for k in names}


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    return _module("metrics", metric).read


def traffic(name: str) -> dict:
    """The parameters of ``traffic/<name>.json``."""
    with open(os.path.join(folder("traffic"), f"{name}.json")) as f:
        return json.load(f)


def generator(traffic: dict):
    """The generator module that the traffic names."""
    return _module("generators", traffic["generator"])


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The cell's metric entries: its end-to-end ones, or with ``trace``
    its per-layer ones."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def limits(cell: str) -> dict:
    """The cell's limits of the comparison (``limits/<cell>.json``)."""
    with open(os.path.join(folder("limits"), f"{cell}.json")) as f:
        return json.load(f)


def limits_of(cell: str, ref) -> dict:
    """The cell's limits, refused unless they name exactly the readings
    that the run compares."""
    lim = limits(cell)["limits"]
    want = compared(ref)
    if set(lim) != set(want):
        raise RuntimeError(
            f"limits/{cell}.json names {sorted(lim)}; {ref.__name__} and "
            f"the harness compare {sorted(want)}")
    return lim


def card_power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


class Run:
    """What a metric reader reads: the cell, the window's requests, the
    spans, the counters and the device trace."""

    def __init__(self, cell, traffic, bench=None):
        self.bench = bench
        self.cell = cell
        self.traffic = traffic
        self.setup_s = None
        self.window_s = None
        self.requests = []      # dicts: wall_s, ok, plans, successes, steps
        self.syncs = 0
        self.spans = []
        self.trace = None       # trace.DeviceTrace of the profiled prefix
        self.kernel_work = {}   # kernel -> [(flops, bytes)]

    # conveniences for the readers
    @property
    def plans(self) -> int:
        return sum(r["plans"] for r in self.requests)

    def span_sum(self, name: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.spans if n == name)


def _number(v) -> bool:
    return isinstance(v, (int, float))


def _sampled(seed: int, index: int, every: int) -> bool:
    """Is answered plan ``index`` in the sample drawn from ``seed``."""
    rng = np.random.default_rng([seed, index])
    return int(rng.integers(every)) == 0


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, bench: dict | None = None, faults=None,
             log=print, control: bool = False,
             started: float | None = None) -> dict:
    """One run of ``workload``; returns the result line's object (with
    ``checks``).  ``device`` is ``cuda`` unless given; ``faults`` is a
    callable that breaks the program after set-up (the tests' planted
    faults).  ``control`` adds ``control``: the control's readings on the
    same plans (the reference module's ``check_control``).  The
    configuration's reference, the cell's limits and the counted kernels
    are found, and refused where they do not fit, before anything runs.
    ``started`` is the process's start on
    ``time.perf_counter``'s clock, where set-up is counted from."""
    t_setup = time.perf_counter() if started is None else started
    import torch

    bench = bench or load_benchmark()
    cell = cell_of(bench, workload)
    conf = config_of(bench, cell["config"])
    ref = reference_of(conf)
    lim = limits_of(workload, ref)
    counted = kernels_of(conf)
    mix = traffic(cell["traffic"])
    gen = generator(mix)
    run = Run(cell, mix, bench)

    from omg_planner_torch.apps import serve
    from omg_planner_torch.config import OMGConfig
    from omg_planner_torch.utils.sync import SYNCS

    dev = torch.device(device or "cuda")
    cuda = dev.type == "cuda"
    base_cfg = OMGConfig(silent=True).replace(**conf["omg_config"])
    for key, val in conf["published"].items():
        if getattr(base_cfg, key) != val:
            raise RuntimeError(f"config {cell['config']}: {key} is "
                               f"{getattr(base_cfg, key)}, not {val}")
    handler = getattr(serve, gen.HANDLER)
    bodies = gen.plans(mix)
    pr = probes.Probes(spans=trace, cuda=cuda, kernels=counted)
    pr.install()
    try:
        for body in gen.warmup(mix, bodies):
            code, _ = handler(body, base_cfg, dev)
            if code != 200:
                raise RuntimeError(f"warm-up request answered {code}")
        if cuda and trace:
            # the profiler's first session in a process is slow to start
            devtrace.warm_profiler()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        pr.plans.clear()
        pr.spans.clear()
        # what set-up made stays: the collector need not walk it again
        gc.collect()
        gc.freeze()
        if faults is not None:
            faults()
        run.setup_s = time.perf_counter() - t_setup
        result = _window(run, pr, gen, handler, base_cfg, dev, bodies,
                         seed, seconds, trace, log, SYNCS, control,
                         (ref, conf, lim))
    finally:
        pr.uninstall()
    return result


class Client:
    """What a generator's client sends through: ``send`` calls the
    service's handler in this process, times the request (from ``due``
    where the generator gives it, else from the call) and keeps its
    answers for the metrics and the comparison; ``deadline`` is the
    window's close on ``clock``'s time."""

    clock = staticmethod(time.perf_counter)

    def __init__(self, run, pr, gen, handler, base_cfg, dev, seed, seconds,
                 trace, log):
        self.run, self.pr, self.gen = run, pr, gen
        self.handler, self.base_cfg, self.dev = handler, base_cfg, dev
        self.seed, self.log = seed, log
        self.every = run.traffic["sample_every"]
        self.answered = []      # (plan index, body, answer) of answered plans
        self.keep = set()
        self.longest = (-1, None)
        self.prof = None
        self.n_traced = run.traffic["trace_requests"] \
            if trace and dev.type == "cuda" else 0
        if self.n_traced:
            self.prof = devtrace.DeviceProfile()
            self.prof.start()
            pr.counting = True
        self.t_start = self.clock()
        self.deadline = self.t_start + seconds

    def send(self, body: dict, plans: list, due: float | None = None):
        pr, run = self.pr, self.run
        n_plans0 = len(pr.plans)
        t0 = self.clock()
        try:
            code, resp = self.handler(body, self.base_cfg, self.dev)
        except Exception:  # a request that raises counts as failed
            self.log(traceback.format_exc(), file=sys.stderr)
            code, resp = None, None
        t_from = t0 if due is None else due
        rec = {"wall_s": self.clock() - t_from, "ok": code == 200,
               "plans": len(plans), "successes": 0, "steps": 0,
               "t0": t_from}
        if code == 200:
            answers = self.gen.answers(resp)
            caps = range(n_plans0, len(pr.plans))
            if len(caps) != len(answers):
                caps = [None] * len(answers)
            for plan, cap, ans in zip(plans, caps, answers):
                rec["successes"] += bool(ans.get("flag"))
                steps = int(ans.get("steps_used", 0))
                rec["steps"] += steps
                if cap is None or "traj" not in ans:
                    continue
                self.answered.append((cap, plan, ans))
                if _sampled(self.seed, len(self.answered) - 1, self.every):
                    self.keep.add(cap)
                elif steps > self.longest[0]:
                    if self.longest[1] is not None and \
                            self.longest[1] not in self.keep:
                        pr.drop(self.longest[1])
                    self.longest = (steps, cap)
                else:
                    pr.drop(cap)
        run.requests.append(rec)
        if self.prof is not None and len(run.requests) == self.n_traced:
            self.prof.stop()
            pr.counting = False


def _window(run, pr, gen, handler, base_cfg, dev, bodies, seed, seconds,
            trace, log, syncs, control, comparison):
    import torch

    cuda = dev.type == "cuda"
    s0 = syncs.count
    client = Client(run, pr, gen, handler, base_cfg, dev, seed, seconds,
                    trace, log)
    t_start = client.t_start
    gen.drive(run.traffic, bodies, seed, client)
    prof, answered, keep = client.prof, client.answered, client.keep
    longest = client.longest
    if cuda:
        torch.cuda.synchronize()
    t_end = time.perf_counter()
    run.window_s = t_end - t_start
    run.syncs = syncs.count - s0
    if prof is not None and prof.running:
        prof.stop()
        pr.counting = False
    run.spans = list(pr.spans)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    forbidden = guard.loaded_forbidden()
    if forbidden:
        raise SystemExit(f"modules of JAX or the JAX package loaded: "
                         f"{forbidden}")
    if prof is not None:
        run.trace = prof.read(pr.spans, {k: tuple(m.OPS) for k, m in
                                         pr.kernels.items()})
        run.kernel_work = {"chomp_obstacle": pr.launches["chomp_obstacle"],
                           "sdf_query": pr.sdf_launch_work(),
                           **pr.named_launch_work()}
    if longest[1] is not None:
        keep.add(longest[1])

    # the comparison with the reference, after the window
    from reference.check import Readings
    ref, conf, lim = comparison
    readings = Readings()
    ctl = Readings()
    t_ref = time.perf_counter()
    n_checked = 0
    with torch.device(dev):
        for cap, body, ans in answered:
            if cap not in keep:
                continue
            rec = probes.plan_record(pr.plans[cap], body, ans)
            ref.check_request(rec, conf, base_cfg, readings)
            if control:
                for k, v in ref.check_control(rec, conf, base_cfg).items():
                    if _number(v):
                        ctl.worst(k, v)
            n_checked += 1
    readings.worst("unanswered", sum(not r["ok"] for r in run.requests))
    notes = {k: v for k, v in readings.items() if not _number(v)}
    log(f"reference: {n_checked} plans checked in "
        f"{time.perf_counter() - t_ref:.1f} s; notes {notes}",
        file=sys.stderr)
    checks = {}
    correct = n_checked > 0
    for name, limit in lim.items():
        value = float(readings.get(name, 0.0))
        checks[name] = {"value": value, "limit": limit}
        correct = correct and value <= limit
    checks["plans_checked"] = {"value": n_checked, "limit": 1}

    metrics = {}
    for m in metrics_for(run.bench, run.cell["name"], trace):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = run.plans
    failed = sum(r["plans"] for r in run.requests if not r["ok"])
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": int(memory_peak)}
    if cuda:
        device["power_limit"] = card_power_limit()
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device}
    if run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    lat = [r["wall_s"] for r in run.requests if r["ok"]]
    thirds = [[r["wall_s"] * 1e3 for r in run.requests if r["ok"] and
               i <= 3 * (r["t0"] - t_start) / run.window_s < i + 1]
              for i in range(3)]
    log("request p50 by third of the window (ms): " + ", ".join(
        f"{stats.percentile(t, 50):.2f} ({len(t)})" for t in thirds if t),
        file=sys.stderr)
    log(f"window {run.window_s:.3f} s: {len(run.requests)} requests, "
        f"{attempted} plans, {failed} failed, {len(lat)} latency samples, "
        f"{run.syncs} host syncs", file=sys.stderr)
    for name, c in checks.items():
        log(f"check {name}: {c['value']:.6g} (limit {c['limit']})",
            file=sys.stderr)
    out["checks"] = checks
    if control:
        out["control"] = dict(ctl)
    return out
