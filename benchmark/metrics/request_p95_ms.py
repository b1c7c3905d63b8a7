"""95th percentile of the same requests as ``request_p50_ms``."""

import stats


def read(run):
    lat = [r["wall_s"] * 1e3 for r in run.requests if r["ok"]]
    return stats.percentile(lat, 95) if lat else None
