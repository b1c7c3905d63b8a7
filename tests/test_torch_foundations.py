"""Port foundations against the JAX package: config, horizon operators,
cost schedule, pose/spline/diff/linalg utilities.

Inputs are made with numpy from fixed seeds and go through both packages.
Tolerances: float32 elementwise math agrees to a few ulps (atol 1e-5 on
O(1) values); the host-numpy operators are identical code (exact)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu import config as jcfg
from omg_planner_tpu.utils import diff as jdiff
from omg_planner_tpu.utils import linalg as jlinalg
from omg_planner_tpu.utils import pose as jpose
from omg_planner_tpu.utils import spline as jspline
from omg_planner_torch import config as tcfg
from omg_planner_torch.utils import diff as tdiff
from omg_planner_torch.utils import linalg as tlinalg
from omg_planner_torch.utils import pose as tpose
from omg_planner_torch.utils import spline as tspline

torch.set_num_threads(2)


def T(a):
    return torch.tensor(np.asarray(a, np.float32))


def close(t, j, atol=1e-5):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=atol,
                               rtol=0)


def test_config_fields_and_defaults_equal():
    jf = dataclasses.fields(jcfg.OMGConfig)
    tf = dataclasses.fields(tcfg.OMGConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    j, t = jcfg.OMGConfig(), tcfg.OMGConfig()
    diffs = [f.name for f in jf if getattr(j, f.name) != getattr(t, f.name)]
    assert not diffs, diffs
    assert t.total_steps == j.total_steps and t.num_interp == j.num_interp
    s, e = np.zeros(9), np.full(9, 0.7)
    assert t.dynamic_timesteps(s, e) == j.dynamic_timesteps(s, e)


@pytest.mark.parametrize("n,proj,tail", [(30, True, 5), (30, False, 5),
                                         (12, True, 3)])
def test_horizon_operators_equal(n, proj, tail):
    j = jcfg.OMGConfig(timesteps=n, goal_set_proj=proj,
                       reach_tail_length=tail).horizon()
    t = tcfg.OMGConfig(timesteps=n, goal_set_proj=proj,
                       reach_tail_length=tail).horizon()
    for a, b in ((t.diff_matrices, j.diff_matrices), (t.A, j.A),
                 (t.Ainv, j.Ainv)):
        np.testing.assert_array_equal(a, b)
    for k in (1, tail):
        np.testing.assert_array_equal(t.proj[k][0], j.proj[k][0])
        np.testing.assert_array_equal(t.proj[k][1], j.proj[k][1])
    dev = t.on("cpu")
    np.testing.assert_array_equal(dev.Ainv.numpy(), j.Ainv)


def test_schedule_weights():
    jc, tc = jcfg.OMGConfig(), tcfg.OMGConfig()
    for step in (1, 7, 50, 70):
        jw = jcfg.schedule_weights(jc, step)
        tw = tcfg.schedule_weights(tc, step)
        for a, b in zip(tw, jw):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-6)


def _rotations(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q


def test_pose_utils():
    rng = np.random.default_rng(0)
    q = _rotations(rng, 64)
    close(tpose.quat_to_mat(T(q)), jpose.quat_to_mat(jnp.asarray(q)))
    r = np.asarray(jpose.quat_to_mat(jnp.asarray(q)))
    close(tpose.mat_to_quat(T(r)), jpose.mat_to_quat(jnp.asarray(r)), 1e-5)
    # so3_log away from the pi degeneracy (its sensitivity is the trace's)
    small = np.asarray(jpose.quat_to_mat(jnp.asarray(
        np.concatenate([np.full((64, 1), 3.0), q[:, 1:]], 1))))
    close(tpose.so3_log(T(small)), jpose.so3_log(jnp.asarray(small)), 1e-4)
    close(tpose.so3_angle(T(small)), jpose.so3_angle(jnp.asarray(small)),
          1e-4)
    p7 = np.concatenate([rng.normal(size=(64, 3)), q], 1).astype(np.float32)
    m = np.asarray(jpose.unpack_pose(jnp.asarray(p7)))
    close(tpose.unpack_pose(T(p7)), m)
    close(tpose.pack_pose(T(m)), jpose.pack_pose(jnp.asarray(m)), 1e-5)
    close(tpose.se3_inverse(T(m)), jpose.se3_inverse(jnp.asarray(m)))
    a = rng.uniform(-np.pi, np.pi, 16).astype(np.float32)
    for tf, jf in ((tpose.rot_x, jpose.rot_x), (tpose.rot_y, jpose.rot_y),
                   (tpose.rot_z, jpose.rot_z)):
        close(tf(T(a)), jf(jnp.asarray(a)))
    pts = rng.normal(size=(64, 10, 3)).astype(np.float32)
    close(tpose.transform_points(T(m), T(pts)),
          jpose.transform_points(jnp.asarray(m), jnp.asarray(pts)))


def test_splines():
    rng = np.random.default_rng(1)
    s, e = rng.normal(size=(2, 9)).astype(np.float32)
    goals = rng.normal(size=(7, 9)).astype(np.float32)
    close(tspline.cubic_interpolate(T(s), T(e), 30),
          jspline.cubic_interpolate(jnp.asarray(s), jnp.asarray(e), 30))
    close(tspline.linear_interpolate(T(s), T(e), 30),
          jspline.linear_interpolate(jnp.asarray(s), jnp.asarray(e), 30))
    close(tspline.multi_linear_interpolate(T(s), T(goals), 15),
          jspline.multi_linear_interpolate(jnp.asarray(s), jnp.asarray(goals),
                                           15))
    close(tspline.multi_cubic_interpolate(T(s), T(goals), 15),
          jspline.multi_cubic_interpolate(jnp.asarray(s), jnp.asarray(goals),
                                          15))


@pytest.mark.parametrize("order", [1, 2])
def test_get_derivative(order):
    rng = np.random.default_rng(2)
    jhp = jcfg.OMGConfig().horizon()
    thp = tcfg.OMGConfig().horizon().on("cpu")
    data = rng.normal(size=(4, 10, 30, 3)).astype(np.float32)
    s = rng.normal(size=(4, 10, 3)).astype(np.float32)
    e = rng.normal(size=(4, 10, 3)).astype(np.float32)
    # values are O(1 / dt^order) = O(1e2 .. 1e4): relative tolerance
    np.testing.assert_allclose(
        tdiff.get_derivative(thp, T(data), T(s), T(e), order).numpy(),
        np.asarray(jdiff.get_derivative(jhp, jnp.asarray(data),
                                        jnp.asarray(s), jnp.asarray(e),
                                        order)),
        rtol=1e-5, atol=1e-3)


def test_solve_spd_unrolled():
    rng = np.random.default_rng(3)
    m = rng.normal(size=(32, 6, 7)).astype(np.float32)
    a = m @ m.transpose(0, 2, 1) + 1e-4 * np.eye(6, dtype=np.float32)
    b = rng.normal(size=(32, 6)).astype(np.float32)
    x_t = tlinalg.solve_spd_unrolled(T(a), T(b)).numpy()
    x_j = np.asarray(jlinalg.solve_spd_unrolled(jnp.asarray(a),
                                                jnp.asarray(b)))
    np.testing.assert_allclose(x_t, x_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(a @ x_t[..., None], b[..., None], atol=1e-3)


def test_top_k_tie_order_matches_lax():
    """Equal values (and masked -inf lanes) come lower index first."""
    x = np.array([0.5, -np.inf, 0.5, 2.0, -np.inf, 0.5, 2.0, -np.inf],
                 np.float32)
    for k in (3, 6, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        tv, ti = tlinalg.top_k(T(x), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    a = np.arange(24, dtype=np.float32).reshape(6, 4)
    idx = np.array([4, 0, 5])
    np.testing.assert_array_equal(
        tlinalg.take_rows(T(a), torch.as_tensor(idx)).numpy(),
        np.asarray(jlinalg.take_rows(jnp.asarray(a), jnp.asarray(idx))))
