"""Median wall of every answered request of the window, each timed from
its call to its return with the harvested result on the host."""

import stats


def read(run):
    lat = [r["wall_s"] * 1e3 for r in run.requests if r["ok"]]
    return stats.percentile(lat, 50) if lat else None
