"""``min_dist_grid``'s share of its roofline over the profiled requests:
the least time of each launch's work (counted from its arguments,
``kernels/min_dist_grid.py``) summed, over the launches' device time."""

import stats
import work


def read(run):
    t, launches = run.trace, run.kernel_work.get("min_dist_grid", [])
    if t is None or not launches:
        return None
    n, seconds = t.kernel_seconds("min_dist_grid")
    if n != len(launches) or seconds <= 0:
        return None
    return stats.share_pct(sum(work.bound_s(f, b) for f, b in launches),
                           seconds)
