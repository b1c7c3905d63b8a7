"""100 minus the union of the device's operations over the profiled
requests' window, from ``torch.profiler``'s device trace."""

import stats


def read(run):
    t = run.trace
    return None if t is None else stats.idle_pct(t.busy_s, t.window_s)
