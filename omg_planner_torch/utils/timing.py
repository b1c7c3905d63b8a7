"""Host spans of the program's phases, and retries (counterpart of
``omg_planner_tpu/utils/timing.py``).

**Spans.** ``with span("plan.step"):`` marks a phase on the host.  A span
records its name, start and end (``time.perf_counter_ns``, the clock onto
which a ``torch.profiler`` device trace can be mapped), the span that
encloses it on the same thread, and the id of its request: ``with
request():`` opens a ``request`` span whose own id is the request's id,
which every span inside it shares.  A span never synchronises the device,
reads the host or touches a tensor, so it times what the host spends in a
phase, the host's waits included only where the phase itself reads the
device (``utils/sync.py``'s reads are spans ``sync.<site>``).

Tracing is on after :func:`enable` and while a ``torch.profiler`` session
runs (torch's own flag, the one ``record_function`` reads), so every
device profile carries the program's spans.  Off, a span site costs a
flag check and a shared no-op context manager, and allocates nothing.
Spans are kept in memory, at most :data:`SPAN_LIMIT` between two
:func:`take` calls; later ones are dropped and counted
(``TRACE.dropped``, over the process's life).

**Marks.** :func:`mark` keeps the host's time of a named moment on the
thread, tracing on or off (the service times a fresh request's staging up
to the plan's start with it).

**Retries.** ``retry_transient`` retries only listed infrastructure
faults and counts every retry in ``RETRIES`` (as ``utils/sync.py`` counts
host reads), so a run can fail when any retry fired.  A CUDA fault is
sticky: the context is lost and every later call fails, so it is raised
at once and never retried, whatever its type.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

from torch.autograd import profiler as _torch_profiler

#: Infrastructure faults that can pass: the host's connections and
#: timeouts (a rendezvous, a shared filesystem).
TRANSIENT = (ConnectionError, TimeoutError)

#: Spans kept between two :func:`take` calls (a traced benchmark run
#: records ~150 a request; 24 requests are profiled).
SPAN_LIMIT = 1 << 18


class Span(NamedTuple):
    """One recorded span.  Times are ``time.perf_counter_ns``; ``parent``
    is the enclosing span's ``id`` (0 at the top of a thread), ``request``
    the id of the request it belongs to (0 outside any request)."""

    name: str
    start_ns: int
    end_ns: int
    parent: int
    request: int
    id: int


class _Trace:
    """The process's span buffer and switch."""

    def __init__(self):
        self.enabled = False
        self.records = []           # Span fields as plain tuples
        self.dropped = 0
        self.lock = threading.Lock()
        self.local = threading.local()  # .stack: open spans; .marks
        self.ids = itertools.count(1)

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack


TRACE = _Trace()


class _Open:
    """A span being recorded (tracing on)."""

    __slots__ = ("name", "request", "parent", "id", "t0")

    def __init__(self, name: str, request: int):
        self.name = name
        self.request = request

    def __enter__(self):
        stack = TRACE.stack()
        top = stack[-1] if stack else None
        self.parent = top.id if top is not None else 0
        if not self.request:
            self.request = top.request if top is not None else 0
        self.id = next(TRACE.ids)
        if self.request < 0:        # a request span names its request
            self.request = self.id
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        TRACE.stack().pop()
        rec = (self.name, self.t0, t1, self.parent, self.request, self.id)
        with TRACE.lock:
            if len(TRACE.records) < SPAN_LIMIT:
                TRACE.records.append(rec)
            else:
                TRACE.dropped += 1
        return False


class _Off:
    """The span of a site while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def active() -> bool:
    """Is tracing on (:func:`enable`, or a ``torch.profiler`` session)?"""
    return TRACE.enabled or _torch_profiler._is_profiler_enabled


def span(name: str):
    """A context manager that records the phase ``name`` while tracing is
    on, and does nothing otherwise."""
    # active() inlined: this runs at every span site
    if TRACE.enabled or _torch_profiler._is_profiler_enabled:
        return _Open(name, 0)
    return _OFF


def request():
    """A ``request`` span whose own id is the request id that every span
    opened inside it on this thread shares."""
    return _Open("request", -1) if active() else _OFF


def enable(on: bool = True):
    """Record spans from now on (or, with ``on=False``, only while a
    ``torch.profiler`` session runs)."""
    TRACE.enabled = on


def take() -> list:
    """The spans recorded since the last call, in the order they closed,
    and clear them."""
    with TRACE.lock:
        recs, TRACE.records = TRACE.records, []
    return [Span(*r) for r in recs]


def mark(name: str) -> int:
    """Keep the host's time of the moment ``name`` on this thread (tracing
    on or off); returns it (``time.perf_counter_ns``)."""
    t = time.perf_counter_ns()
    try:
        TRACE.local.marks[name] = t
    except AttributeError:
        TRACE.local.marks = {name: t}
    return t


def marked(name: str) -> int | None:
    """The time :func:`mark` last kept for ``name`` on this thread."""
    return getattr(TRACE.local, "marks", {}).get(name)


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
