"""Trajectories pushed past the Panda's joint limits: the inputs on which
the joint-limit projection (``ops/kernels.py::joint_limit``) is checked by
the port's tests, ``chip_smoke.py`` phase 3c and
``scripts/joint_limit_gaps.py`` (numpy only, no JAX)."""

from __future__ import annotations

import numpy as np

#: timesteps of a pushed trajectory (``OMGConfig().timesteps``)
T = 30


def pushed(limits, seed: int, push) -> np.ndarray:
    """A [30, 9] float32 trajectory between two in-limit configurations
    drawn from ``seed`` (``limits``: the lower and upper limits [9]), with
    joint j's timesteps a..b moved past its limit for each (j, a, b,
    amount) of ``push``: by ``amount`` at a, rising linearly to twice that
    at b - 1 (amount > 0: past the upper limit, < 0: the lower)."""
    lo, hi = limits
    rng = np.random.default_rng(seed)
    mid, span = (lo + hi) / 2, (hi - lo) / 2
    ends = mid + span * rng.uniform(-0.8, 0.8, (2, 9))
    u = np.linspace(0.0, 1.0, T)[:, None]
    xi = (ends[0] + u * (ends[1] - ends[0])).astype(np.float32)
    for j, a, b, amount in push:
        b = min(b, T)
        ramp = amount * (1.0 + np.linspace(0.0, 1.0, b - a))
        xi[a:b, j] = (hi[j] + ramp) if amount > 0 else (lo[j] + ramp)
    return xi


def random_pushes(rng, most: int = 3, reach: float = 0.4) -> list:
    """One to ``most`` pushes for :func:`pushed` drawn from ``rng``: an
    arm joint, a stretch of 1 to 11 timesteps, 0.005 to ``reach`` rad past
    its upper or lower limit (rising to twice that)."""
    out = []
    for _ in range(rng.integers(1, most + 1)):
        j, a = int(rng.integers(0, 7)), int(rng.integers(0, 25))
        out.append((j, a, a + int(rng.integers(1, 12)),
                    float(rng.choice([-1, 1]) * rng.uniform(0.005, reach))))
    return out


def seeded(limits, seeds, most: int = 3, reach: float = 0.4) -> np.ndarray:
    """[len(seeds), 30, 9]: for each seed its trajectory, pushed as
    :func:`random_pushes` draws it from the same seed (no case chosen)."""
    return np.stack([pushed(limits, s, random_pushes(
        np.random.default_rng(s), most, reach)) for s in seeds])
