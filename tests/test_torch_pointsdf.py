"""Point-cloud distance grid of the port against the JAX package.

On the CPU the JAX package runs its plain XLA path (``min_dist_grid_xla``,
chunked), and the port's wrapper takes its plain PyTorch version because
the tensors lie on the CPU.  The CUDA kernel itself is held against the
plain version by the ``gpu``-marked test below, which needs the card.

Tolerance: 1e-3 m.  Both plain versions use the expansion
|g|^2 + |p|^2 - 2 g.p, which in float32 loses up to ~5e-4 m near d = 0
(the square root amplifies the cancellation); the grid cell is 0.02 m."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omg_planner_tpu.io.assets import synthetic_tabletop_scene as jscene
from omg_planner_tpu.ops import pallas_kernels as jpk
from omg_planner_tpu.ops import pointsdf as jpsdf
from omg_planner_tpu.viz import camera as jcam
from omg_planner_torch.io.assets import synthetic_tabletop_scene as tscene
from omg_planner_torch.ops import kernels
from omg_planner_torch.ops import pointsdf as tpsdf
from omg_planner_torch.viz import camera as tcam

torch.set_num_threads(2)

TOL = 1e-3


def _direct(grid, pts, chunk=4096):
    """float64 direct-form oracle, chunked over cells."""
    return np.concatenate([
        np.sqrt(((g[:, None, :].astype(np.float64) - pts[None, :, :]) ** 2)
                .sum(-1)).min(1)
        for g in np.array_split(grid, max(1, -(-len(grid) // chunk)))])


@pytest.mark.parametrize("g,n", [(1000, 1), (777, 1035), (16384 + 5, 64)])
def test_min_dist_grid_plain_matches_xla(g, n):
    rng = np.random.default_rng(g + n)
    grid = rng.uniform(-0.5, 0.5, (g, 3)).astype(np.float32)
    pts = rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    before = kernels.min_dist_grid.launches
    t = kernels.min_dist_grid(torch.tensor(grid), torch.tensor(pts))
    assert kernels.min_dist_grid.launches == before  # CPU: no kernel launch
    assert t.dtype == torch.float32 and t.shape == (g,)
    np.testing.assert_allclose(
        t.numpy(), np.asarray(jpk.min_dist_grid_xla(jnp.asarray(grid),
                                                    jnp.asarray(pts))),
        atol=TOL)
    np.testing.assert_allclose(t.numpy(), _direct(grid, pts), atol=TOL)
    # chunking does not change the result
    np.testing.assert_array_equal(
        kernels.min_dist_grid_plain(torch.tensor(grid), torch.tensor(pts),
                                    chunk=100).numpy(), t.numpy())


def test_min_dist_grid_rejects_other_devices():
    grid = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError):
        kernels.min_dist_grid(grid, grid)


def _observed_cloud(tscene_fn, cam, scene_id=5):
    objects, target = tscene_fn(scene_id, n_obstacles=2)
    pts, labels, depth, seg = cam.render_point_observation(objects)
    return pts, labels, depth, seg, [o.name for o in objects].index(target)


def test_camera_render_equal():
    jp, jl, jd, js, jt = _observed_cloud(jscene, jcam)
    tp, tl, td, ts, tt = _observed_cloud(tscene, tcam)
    assert jt == tt
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ts, js)
    assert (tl != tt).sum() > 100  # the cloud sees the obstacles


@pytest.mark.parametrize("resolution,margin", [(0.02, 0.24), (0.03, 0.1)])
def test_sdf_from_points_matches_jax(resolution, margin):
    pts, labels, _, _, target = _observed_cloud(tscene, tcam)
    cloud = pts[labels != target].astype(np.float32)
    jf = jpsdf.sdf_from_points(cloud, resolution=resolution, margin=margin)
    tf = tpsdf.sdf_from_points(cloud, resolution=resolution, margin=margin,
                               device="cpu")
    assert tf.shape == jf.shape
    np.testing.assert_array_equal(tf.origin, jf.origin)
    assert tf.delta == jf.delta
    np.testing.assert_allclose(tf.data, jf.data, atol=TOL)
    # the grid the port builds is the JAX package's float32 grid
    grid = tpsdf.grid_cells(tf.shape, tuple(float(v) for v in tf.origin),
                            resolution, "cpu").numpy()
    sub = np.random.default_rng(0).choice(len(grid), 2000, replace=False)
    np.testing.assert_allclose(tf.data.reshape(-1)[sub],
                               _direct(grid[sub], cloud), atol=TOL)


def test_sdf_from_points_empty_cloud():
    jf = jpsdf.sdf_from_points(np.zeros((0, 3)), resolution=0.05, margin=0.1)
    tf = tpsdf.sdf_from_points(np.zeros((0, 3)), resolution=0.05, margin=0.1,
                               device="cpu")
    assert tf.shape == jf.shape
    np.testing.assert_allclose(tf.data, jf.data, atol=TOL)


@pytest.mark.gpu
def test_min_dist_grid_kernel_matches_plain_on_card():
    """The kernel against the plain version (1e-3 m) and the float64
    direct form.  The kernel uses the TPU kernel's expansion
    |g'|^2 + |p'|^2 - 2 g'.p' about a per-block centre.  Its float32
    rounding of d^2 is about eps |g'|^2, which the square root turns into
    about eps |g'|^2 / (2 d): well under 1e-4 m on the random shapes below,
    which are held to that.  Where the points are grid cells (d = 0) the
    cancellation is at its worst, about sqrt(eps |g'|^2), ~3e-4 m at
    |g'| ~ 1 m, and the bar is 1e-3 m."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(7)

    def uniform(n):
        return rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)

    grid = tpsdf.grid_cells((40, 50, 30), (-0.4, -0.5, -0.3), 0.02,
                            "cpu").numpy()
    cases = [(uniform(g), uniform(n), 1e-4) for g, n in
             ((1000, 1), (777, 1035), (4099, 3072), (70000, 2049))]
    cases.append((grid, grid[rng.choice(len(grid), 1035, replace=False)],
                  TOL))  # d = 0
    cases.append((grid, rng.uniform(grid.min(0), grid.max(0), (3072, 3))
                  .astype(np.float32), 1e-4))  # the observed cloud's cap
    for g_np, p_np, atol in cases:
        grid_t = torch.tensor(g_np, device="cuda")
        pts = torch.tensor(p_np, device="cuda")
        before = kernels.min_dist_grid.launches
        out = kernels.min_dist_grid(grid_t, pts)
        torch.cuda.synchronize()
        assert kernels.min_dist_grid.launches == before + 1
        ref = kernels.min_dist_grid_plain(grid_t, pts)
        assert float((out - ref).abs().max()) <= TOL
        np.testing.assert_allclose(out.cpu().numpy(), _direct(g_np, p_np),
                                   atol=atol)
