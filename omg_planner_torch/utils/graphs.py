"""CUDA graphs of the plan loop's updates, and their count.

:func:`capture` records what a function launches on the card into a
:class:`Graph` and runs it once; :meth:`Graph.replay` runs the same work
again on the current stream, with one launch a segment.  It captures on a
side stream of its thread (the legacy default stream cannot be captured),
ordered after the current stream's work and before its later work, and
without the synchronise and cache flush that ``torch.cuda.graph`` makes on
entry.

A kernel wrapper that is called while a capture runs (:func:`capturing`)
may hand its call to :func:`outside`: the capture is cut there, and the
call runs eagerly between the segments, at the capture and at every
replay, through the wrapper's module attribute.  So each of its launches
is a call of the wrapper, which counts it and which anything put around
the wrapper sees, and its outputs are copied into the tensors that the
next segment reads.

Every capture of a thread on one card allocates from one memory pool, so
a plan's graphs and the next plan's reuse one set of blocks: the graphs of
the last plan that captured stay alive (:func:`retain`), which keeps the
pool in use.  A graph's outputs therefore live in blocks that another
graph of the pool may also use: whatever must outlast the next replay of
another graph is copied into tensors allocated outside the capture.

``GRAPHS`` counts, by piece of the plan step (``chomp``, ``learner``), the
captures, the replays and the updates that ran eagerly on the card, as
``utils/sync.py``'s ``SYNCS`` counts host reads by site.
"""

from __future__ import annotations

import threading

import torch

PIECES = ("chomp", "learner")
KINDS = ("capture", "replay", "eager")


class GraphCounter:
    """Captures, replays and eager updates by piece:
    ``counts[piece][kind]``."""

    def __init__(self):
        self._lock = threading.Lock()
        self.reset()

    def reset(self):
        with self._lock:
            self.counts = {p: dict.fromkeys(KINDS, 0) for p in PIECES}

    def add(self, piece: str, kind: str):
        with self._lock:
            self.counts[piece][kind] += 1


GRAPHS = GraphCounter()


class _Pool:
    """A thread's capture stream and memory pool on one card, and the
    graphs that keep the pool in use."""

    def __init__(self, device):
        self.id = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.live = []


_LOCAL = threading.local()


def _pool(device) -> _Pool:
    pools = _LOCAL.__dict__.setdefault("pools", {})
    pool = pools.get(device.index)
    if pool is None:
        pool = pools[device.index] = _Pool(device)
    return pool


class Graph:
    """A captured function: its segments (``torch.cuda.CUDAGraph``) and,
    between them, the calls that run eagerly (owner, name, arguments,
    the positions of the arguments each call gets a copy of, the outputs
    the next segment reads)."""

    def __init__(self, pool: _Pool):
        self.pool = pool
        self.parts = []
        self._open = None

    def replay(self):
        for part in self.parts:
            if isinstance(part, torch.cuda.CUDAGraph):
                part.replay()
                continue
            owner, name, args, fresh, outs = part
            args = tuple(a.clone() if i in fresh else a
                         for i, a in enumerate(args))
            new = getattr(owner, name)(*args)
            torch._foreach_copy_(list(outs), list(new))

    def _begin(self):
        self._open = torch.cuda.CUDAGraph()
        self._open.capture_begin(pool=self.pool.id,
                                 capture_error_mode="thread_local")
        _LOCAL.graph = self

    def _end(self):
        """Close the open segment and run it (what it captured has not
        run yet)."""
        seg, self._open = self._open, None
        _LOCAL.graph = None
        seg.capture_end()
        seg.replay()
        self.parts.append(seg)

    def _abort(self):
        _LOCAL.graph = None
        if self._open is not None:
            try:
                self._open.capture_end()
            except RuntimeError:
                pass  # the capture was invalidated by the error raised
            self._open = None


def capturing() -> bool:
    """Is a :func:`capture` of this thread recording now?"""
    return getattr(_LOCAL, "graph", None) is not None


def outside(owner, name: str, fn, args: tuple, fresh: tuple = ()):
    """Run ``fn(*args)`` eagerly, out of the capture that is recording, and
    have every replay call ``getattr(owner, name)(*args)`` at this point,
    with a copy of each argument at a position in ``fresh``; returns
    ``fn``'s outputs, which the replays overwrite.  ``fn`` is the launch
    behind the wrapper ``owner.name``, not the wrapper: its caller is that
    wrapper, called once already for this launch."""
    graph = _LOCAL.graph
    graph._end()
    out = fn(*args)
    graph.parts.append((owner, name, args, fresh, out))
    graph._begin()
    return out


def capture(fn, device):
    """Capture what ``fn()`` launches on CUDA ``device`` and run it once:
    returns (the :class:`Graph`, ``fn``'s result, whose tensors the
    graph's replays write)."""
    pool = _pool(device)
    cur = torch.cuda.current_stream(device)
    pool.stream.wait_stream(cur)
    graph = Graph(pool)
    with torch.cuda.stream(pool.stream):
        graph._begin()
        try:
            out = fn()
        except BaseException:
            graph._abort()
            raise
        graph._end()
    cur.wait_stream(pool.stream)
    pool.live.append(graph)
    return graph, out


def retain(graphs: list, device):
    """Keep ``graphs`` (one plan's, all captured by :func:`capture` on this
    thread) alive in place of the graphs kept before, so the pool stays in
    use for the next plan's captures; no-op without graphs."""
    if graphs:
        pool = _pool(device)
        pool.live = list(graphs)
