"""The port's arm dynamics and robot surface
(``omg_planner_torch/physics/{dynamics,panda_ctrl}.py``) against the JAX
package's on the CPU.

Tolerances, and why: the mass matrix, gravity and bias torques, inverse
and forward dynamics at three seeded configurations within 1e-4 relative
to the largest entry (float32 FK; ``torch.func`` and ``jax`` derivatives
of the same expressions); ``NativePanda`` hold, track and free fall over
200 substeps within 1e-4 (semi-implicit Euler of the same dynamics)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from omg_planner_tpu.models import panda as jpanda
from omg_planner_tpu.physics import dynamics as jd
from omg_planner_tpu.physics.panda_ctrl import NativePanda as JPanda
from omg_planner_torch.models import panda as tpanda
from omg_planner_torch.physics import dynamics as td
from omg_planner_torch.physics.panda_ctrl import HOME_POSE, NativePanda

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def models():
    return jpanda.load_panda(), tpanda.load_panda(device="cpu")


def _configs():
    rng = np.random.default_rng(0)
    for _ in range(3):
        q = rng.uniform(-1.0, 1.0, 9).astype(np.float32)
        q[7:] = rng.uniform(0.0, 0.04, 2)
        yield (q, rng.normal(size=9).astype(np.float32),
               rng.normal(size=9).astype(np.float32))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


@pytest.mark.parametrize("name", ["mass_matrix", "gravity_torque",
                                  "bias_torque", "inverse_dynamics",
                                  "forward_dynamics", "link_jacobians"])
def test_dynamics_match_jax(models, name):
    jm, tm = models
    nargs = {"mass_matrix": 1, "gravity_torque": 1, "link_jacobians": 1,
             "bias_torque": 2}.get(name, 3)
    for q, qd, qdd in _configs():
        args = (q, qd, qdd)[:nargs]
        a = getattr(jd, name)(jm, *[jnp.asarray(x) for x in args])
        b = getattr(td, name)(tm, *[torch.as_tensor(x) for x in args])
        if name == "link_jacobians":
            for x, y in zip(b, a):
                assert _rel(x.numpy(), y) < 1e-4
        else:
            assert _rel(b.numpy(), a) < 1e-4, name


def test_mass_matrix_symmetric_pd(models):
    _, tm = models
    for q, _, _ in _configs():
        m = td.mass_matrix(tm, torch.as_tensor(q)).double()
        assert torch.allclose(m, m.T, atol=1e-6)
        assert float(torch.linalg.eigvalsh(m).min()) > 0.0


@pytest.mark.parametrize("mode", ["hold", "track", "free"])
def test_native_panda_matches_jax(mode):
    """200 substeps of the position hold at home, a position track to
    another configuration, and the freed arm falling."""
    j, t = JPanda(), NativePanda(device="cpu")
    for r in (j, t):
        if mode == "track":
            r.setTargetPositions([0.2, -1.0, 0.1, -2.0, 0.1, 1.4, 0.6,
                                  0.03, 0.03])
        elif mode == "free":
            r.resetController()
        r.step(200)
    np.testing.assert_allclose(t.q, j.q, atol=1e-4)
    np.testing.assert_allclose(t.qd, j.qd, atol=1e-4)
    assert t.t == pytest.approx(0.2)
    if mode == "hold":
        assert np.abs(t.q - HOME_POSE).max() < 1e-2
    if mode == "free":
        assert np.abs(t.q - HOME_POSE).max() > 1e-2   # it fell


def test_surface_layouts_and_solvers(models):
    """The 10-slot Bullet layout, the torque clamp, and the inverse
    dynamics and kinematics surfaces against JAX's."""
    j, t = JPanda(), NativePanda(device="cpu")
    ten = list(HOME_POSE[:7]) + [0.0] + list(HOME_POSE[7:])
    t.reset(ten)
    assert np.allclose(t.q, HOME_POSE)
    with pytest.raises(ValueError):
        t.reset([0.0] * 8)
    zeros = [0.0] * 9
    np.testing.assert_allclose(t.solveInverseDynamics(HOME_POSE, zeros,
                                                      zeros),
                               j.solveInverseDynamics(HOME_POSE, zeros,
                                                      zeros), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(t.gravityTorques(), j.gravityTorques(),
                               rtol=1e-4, atol=1e-4)
    pos, orn = [0.5, 0.0, 0.4], [1.0, 0.0, 0.0, 0.0]
    np.testing.assert_allclose(t.solveInverseKinematics(pos, orn),
                               j.solveInverseKinematics(pos, orn), atol=1e-3)
    t.setTargetTorques([1e4] * 9)            # clamped at MAX_TORQUE
    t.step(5)
    assert np.isfinite(t.q).all()
