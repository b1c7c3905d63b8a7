"""The device trace of a traced run's profiled requests: ``torch.profiler``
over the device alone (a trace that also holds the host's operations is
slow to read in Python), the union of the device's operations as its busy
time, the idle gaps named by the benchmark's host span that was open, and
the time of each hand kernel (``KERNELS``, and those whose operations a
configuration's kernel modules name)."""

from __future__ import annotations

import time

import stats

# host span names as the breakdown gives them
SPAN_LABELS = {
    "scene_build": "service: scene build (_build_scene)",
    "scene_stage": "scene staging (Env.stage_scene)",
    "goal_set": "goal-set build (build_problem)",
    "plan": "plan loop (plan_fast)",
}
KERNELS = {"chomp_obstacle": ("chomp_obstacle_kernel",),
           "sdf_query": ("sdf_spread_kernel", "sdf_loop_kernel")}


class DeviceTrace:
    def __init__(self, ops, window_s, gap_names, kernels=None):
        self.ops = ops                  # (name, start_s, end_s), host clock
        self.window_s = window_s
        self.busy_s = stats.union_length([(s, e) for _, s, e in ops])
        self.gap_names = gap_names      # {label: idle seconds}
        # kernel -> substrings of its device operations' names
        self.kernels = {**KERNELS, **(kernels or {})}

    def kernel_seconds(self, kernel: str) -> tuple:
        """(launches, seconds) of a hand kernel's device operations."""
        names = self.kernels[kernel]
        hits = [e - s for n, s, e in self.ops if any(k in n for k in names)]
        return len(hits), sum(hits)

    def breakdown(self) -> dict:
        by_name = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gap_names.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, v] for n, v in top],
                "idle_gaps": [[n, v] for n, v in gaps]}


def warm_profiler():
    """One short device profile, so that the window's starts at once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()


class DeviceProfile:
    """``torch.profiler`` over the device, from ``start`` to ``stop``."""

    def __init__(self):
        self.prof = None
        self.running = False

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        # the first device operation after an idle device marks the
        # profiler's clock against the host's
        self.h_mark = time.perf_counter()
        torch.zeros(1, device="cuda").add_(1.0)
        self.h0 = time.perf_counter()
        self.running = True

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.h1 = time.perf_counter()
        self.prof.__exit__(None, None, None)
        self.running = False

    def read(self, spans, kernels=None) -> DeviceTrace:
        """The trace; ``kernels`` adds kernels' operation names
        (``DeviceTrace``)."""
        from torch.autograd import DeviceType

        evs = [e for e in self.prof.events()
               if e.device_type == DeviceType.CUDA]
        if not evs:
            raise RuntimeError("the profiler recorded no device operation")
        evs.sort(key=lambda e: e.time_range.start)
        # device microseconds -> host seconds, by the marker
        off = self.h_mark - evs[0].time_range.start * 1e-6
        ops = [(e.name, e.time_range.start * 1e-6 + off,
                e.time_range.end * 1e-6 + off) for e in evs[2:]]
        ops = [(n, max(s, self.h0), min(e, self.h1)) for n, s, e in ops
               if e > self.h0 and s < self.h1]
        window = self.h1 - self.h0
        names = {}
        inner = sorted((t0, t1, n) for n, t0, t1 in spans
                       if t1 > self.h0 and t0 < self.h1)
        for g0, g1 in stats.gaps([(s, e) for _, s, e in ops], self.h0,
                                 self.h1):
            label = "harness (between requests)"
            best = None
            mid = 0.5 * (g0 + g1)
            for t0, t1, n in inner:
                if t0 <= mid <= t1 and (best is None or t0 >= best[0]):
                    best = (t0, n)
            if best is not None:
                label = SPAN_LABELS.get(best[1], best[1])
            names[label] = names.get(label, 0.0) + (g1 - g0)
        return DeviceTrace(ops, window, names, kernels)
