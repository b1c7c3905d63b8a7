"""Device-to-host reads that decide control flow, or that bring back data
the host keeps.

The JAX package keeps its data-dependent loops on device (``while_loop``);
in eager PyTorch each such condition is read on the host, which waits for
the device.  Every such read, and every copy of device data that the host
keeps (``pointsdf.field``, a perception grid), goes through these helpers,
named by its call site (a short dotted name: ``plan.terminate``,
``goal_set.dedupe``), so a run can count them: ``SYNCS.count`` in all,
``SYNCS.sites`` by site (``chip_smoke.py`` prints the count per plan).
While tracing is on (``utils/timing.py``) each read is also a span
``sync.<site>``, the host's wait for the device.
"""

from __future__ import annotations

import threading

import torch

from .timing import active, span


class SyncCounter:
    """Counts device-to-host reads taken for control flow, by call site.
    ``count`` is their total; assigning it (``SYNCS.count = 0``) starts the
    per-site counts over, so that they always sum to it."""

    def __init__(self):
        self.sites = {}
        self._lock = threading.Lock()

    @property
    def count(self) -> int:
        with self._lock:
            return sum(self.sites.values())

    @count.setter
    def count(self, value: int):
        with self._lock:
            self.sites = {"unattributed": value} if value else {}

    def add(self, site: str):
        with self._lock:
            self.sites[site] = self.sites.get(site, 0) + 1


SYNCS = SyncCounter()


def _read(convert, t: torch.Tensor, site: str):
    SYNCS.add(site)
    if not active():
        return convert(t)
    with span("sync." + site):
        return convert(t)


def host_bool(t: torch.Tensor, site: str = "unattributed") -> bool:
    return _read(bool, t, site)


def host_int(t: torch.Tensor, site: str = "unattributed") -> int:
    return _read(int, t, site)


def _bools(t: torch.Tensor) -> list:
    return [bool(v) for v in t.tolist()]


def host_bools(t: torch.Tensor, site: str = "unattributed") -> list:
    """A 1-d bool tensor as a list, in one read (a scene batch's per-scene
    flags)."""
    return _read(_bools, t, site)


def _numpy(t: torch.Tensor):
    return t.cpu().numpy()


def host_array(t: torch.Tensor, site: str = "unattributed"):
    """A tensor's values as a host numpy array, in one read (a field that
    the host keeps)."""
    return _read(_numpy, t, site)
