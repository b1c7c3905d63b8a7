"""Phase timing, profiler traces and retries (counterpart of
``omg_planner_tpu/utils/timing.py``).

``retry_transient`` retries only listed infrastructure faults and counts
every retry in ``RETRIES`` (as ``utils/sync.py`` counts host syncs), so a
run can fail when any retry fired.  A CUDA fault is sticky: the context is
lost and every later call fails, so it is raised at once and never
retried, whatever its type.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

#: Infrastructure faults that can pass: the host's connections and
#: timeouts (a rendezvous, a shared filesystem).
TRANSIENT = (ConnectionError, TimeoutError)


class PhaseTimer:
    """Accumulating named-phase timer.

    >>> timer = PhaseTimer(enabled=True)
    >>> with timer("fk"):
    ...     ...
    >>> timer.report()
    """

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            print(f"{name} time: {dt:.4f}")

    def report(self) -> dict:
        out = {k: {"total_s": round(v, 4), "calls": self.counts[k]}
               for k, v in self.totals.items()}
        if self.enabled:
            for k, v in out.items():
                print(f"[timing] {k}: {v['total_s']}s over {v['calls']} calls")
        return out


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """Wrap a region in a ``torch.profiler`` trace (CPU and, when a GPU is
    present, CUDA activity) written to ``log_dir`` as a Chrome trace when
    ``log_dir`` is set."""
    if not log_dir:
        yield
        return
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class RetryCounter:
    """Counts the retries :func:`retry_transient` made."""

    def __init__(self):
        self.count = 0


RETRIES = RetryCounter()


def _is_cuda_fault(e: BaseException) -> bool:
    return "CUDA" in str(e) or type(e).__name__ == "AcceleratorError"


def retry_transient(fn, what: str = "device call", attempts: int = 4,
                    wait_s: float = 75.0, log=None):
    """Call ``fn()``, retrying across the infrastructure faults of
    ``TRANSIENT`` (waiting ``wait_s``, doubled each time); anything else,
    and any CUDA fault, re-raises at once."""
    emit = log or (lambda m: print(m, flush=True))
    for k in range(attempts):
        try:
            return fn()
        except TRANSIENT as e:
            if _is_cuda_fault(e) or k == attempts - 1:
                raise
            RETRIES.count += 1
            emit(f"[retry] transient fault during {what} "
                 f"(attempt {k + 1}/{attempts}): {type(e).__name__}: "
                 f"{str(e)[:200]}; retrying in {wait_s:.0f}s")
            time.sleep(wait_s)
            wait_s *= 2
