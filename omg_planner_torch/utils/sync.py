"""Device-to-host reads that decide control flow.

The JAX package keeps its data-dependent loops on device (``while_loop``);
in eager PyTorch each such condition is read on the host, which waits for
the device.  Every such read goes through these helpers so a run can
count them (``SYNCS.count``; ``chip_smoke.py`` prints the count per plan).
"""

from __future__ import annotations

import torch


class SyncCounter:
    """Counts device-to-host reads taken for control flow."""

    def __init__(self):
        self.count = 0


SYNCS = SyncCounter()


def host_bool(t: torch.Tensor) -> bool:
    SYNCS.count += 1
    return bool(t)


def host_int(t: torch.Tensor) -> int:
    SYNCS.count += 1
    return int(t)


def host_bools(t: torch.Tensor) -> list:
    """A 1-d bool tensor as a list, in one read (a scene batch's per-scene
    flags)."""
    SYNCS.count += 1
    return [bool(v) for v in t.tolist()]
