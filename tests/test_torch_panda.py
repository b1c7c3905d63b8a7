"""Panda kinematics of the port against the JAX package on the CPU.

Random in-limit configurations (numpy, fixed seed) go through both
packages.  Tolerance: atol 1e-5 m on poses and points of O(1) size — both
sides evaluate the same float32 chain in the same association order, so
they differ by a few ulps accumulated over the 10 links (the CPU
backends contract multiply-adds differently)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.models import api as japi
from omg_planner_tpu.models import panda as jpanda
from omg_planner_torch import interop
from omg_planner_torch.models import api as tapi
from omg_planner_torch.models import panda as tpanda

torch.set_num_threads(2)

ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    jm = jpanda.load_panda(collision_point_num=15)
    tm = tpanda.load_panda(15, "cpu")
    return jm, tm


def _configs(n, seed):
    rng = np.random.default_rng(seed)
    lo = np.asarray(jpanda.load_panda().joint_lower)
    hi = np.asarray(jpanda.load_panda().joint_upper)
    return rng.uniform(lo, hi, (n, 9)).astype(np.float32)


def test_load_panda_tables_equal(models):
    jm, tm = models
    for name in jm._fields:
        np.testing.assert_array_equal(getattr(tm, name).numpy(),
                                      np.asarray(getattr(jm, name)), name)
    # interop carries the JAX model across field by field
    cm = interop.panda_model(jax.tree.map(np.asarray, jm), "cpu")
    for name in jm._fields:
        assert torch.equal(getattr(cm, name), getattr(tm, name)), name
    lo_j, hi_j = jm.soft_limits(0.2)
    lo_t, hi_t = tm.soft_limits(0.2)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))


@pytest.mark.parametrize("seed", [0, 1])
def test_fk_batch_and_joint_info(models, seed):
    jm, tm = models
    q = _configs(64, seed)
    jp, jo, ja = jax.jit(jpanda.fk_with_joint_info_batch)(jm, jnp.asarray(q))
    tp, to, ta = tpanda.fk_with_joint_info_batch(tm, torch.as_tensor(q))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=ATOL)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=ATOL)
    # plain-offset chain and the generic model api
    np.testing.assert_allclose(
        tapi.fk_batch(tm, torch.as_tensor(q)).numpy(),
        np.asarray(japi.fk_batch(jm, jnp.asarray(q))), atol=ATOL)


def test_single_fk_and_hand_pose(models):
    jm, tm = models
    q = _configs(8, 2)
    for row in q:
        np.testing.assert_allclose(
            tpanda.forward_kinematics(tm, torch.as_tensor(row)).numpy(),
            np.asarray(jpanda.forward_kinematics(jm, jnp.asarray(row))),
            atol=ATOL)
        np.testing.assert_allclose(
            tpanda.hand_pose(tm, torch.as_tensor(row)).numpy(),
            np.asarray(jpanda.hand_pose(jm, jnp.asarray(row))), atol=ATOL)
    np.testing.assert_allclose(
        tpanda.hand_pose_batch(tm, torch.as_tensor(q)).numpy(),
        np.asarray(jpanda.hand_pose_batch(jm, jnp.asarray(q))), atol=ATOL)


def test_points_and_jacobians(models):
    jm, tm = models
    q = _configs(16, 3)
    jp, jo, ja = jpanda.fk_with_joint_info_batch(jm, jnp.asarray(q))
    jx = jpanda.collision_point_positions(jm, jp)
    jjac = jpanda.point_jacobians(jm, jo, ja, jx)
    # same inputs on both sides, so the Jacobian check isolates its own math
    tp, to, ta = (torch.tensor(np.asarray(a)) for a in (jp, jo, ja))
    tx = tpanda.collision_point_positions(tm, tp)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL)
    tjac = tpanda.point_jacobians(tm, to, ta, torch.tensor(np.asarray(jx)))
    assert tjac.shape == (16, 10, 15, 9, 3)
    np.testing.assert_allclose(tjac.numpy(), np.asarray(jjac), atol=ATOL)
    np.testing.assert_allclose(
        tapi.point_positions(tm, tp).numpy(),
        np.asarray(japi.point_positions(jm, jp)), atol=ATOL)
    np.testing.assert_array_equal(tapi.finger_link_mask(tm),
                                  japi.finger_link_mask(jm))
    np.testing.assert_array_equal(tapi.arm_dof_mask(tm),
                                  japi.arm_dof_mask(jm))
    xi = jnp.asarray(_configs(30, 4))
    np.testing.assert_allclose(
        tapi.gripper_clamp(tm, torch.tensor(np.asarray(xi))).numpy(),
        np.asarray(japi.gripper_clamp(jm, xi)), atol=0)
