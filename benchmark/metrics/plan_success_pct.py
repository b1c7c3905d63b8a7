"""Share of every plan attempted in the window whose verdict is success
(a failed request's plans count as unsuccessful)."""

import stats


def read(run):
    return stats.share_pct(sum(r["successes"] for r in run.requests),
                           run.plans)
