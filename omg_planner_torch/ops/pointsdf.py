"""Point-cloud SDF construction (counterpart of
``omg_planner_tpu/ops/pointsdf.py``).

Replaces the reference's perception-mode SDF build — a host-side
``scipy.spatial.cKDTree.query`` over every workspace voxel
(``omg/core.py:426-457``) — with a brute-force nearest-point distance grid:
the hand-written CUDA kernel ``ops/kernels.py::min_dist_grid`` on the GPU
(one launch over the whole grid: it never materializes the [G, N]
distance matrix), its chunked plain version on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..utils.sync import host_array
from . import kernels
from .sdf import SignedDensityField


def grid_cells(dims: tuple, origin: tuple, delta: float,
               device) -> torch.Tensor:
    """Cell coordinates ``origin + i * delta`` of a ``dims`` grid as
    [G, 3] float32 (x-major), built in float32 as the JAX package does."""
    ax = [torch.tensor(origin[i], dtype=torch.float32, device=device)
          + torch.arange(dims[i], dtype=torch.float32, device=device) * delta
          for i in range(3)]
    gx, gy, gz = torch.meshgrid(*ax, indexing="ij")
    return torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def _min_dist_grid(points: torch.Tensor, dims: tuple, origin: tuple,
                   delta: float) -> torch.Tensor:
    """[N, 3] points -> [dims] grid of nearest-point distances."""
    grid = grid_cells(dims, origin, delta, points.device)
    return kernels.min_dist_grid(grid, points.contiguous()).reshape(dims)


def grid_layout(points: np.ndarray, resolution: float, margin: float):
    """(points float32, dims, origin) of the distance grid around a cloud:
    bounds from the points, ``margin`` on every side (``core.py:435-452``)."""
    points = np.asarray(points, np.float32)
    if points.shape[0] == 0:
        points = np.full((2, 3), 3.0, np.float32)  # core.py:433-434
    lo = points.min(0) - margin
    hi = points.max(0) + margin
    dims = tuple(int(np.ceil((hi[i] - lo[i]) / resolution)) for i in range(3))
    return points, dims, lo


def sdf_from_points(points: np.ndarray, resolution: float = 0.02,
                    margin: float = 0.24,
                    device=None) -> SignedDensityField:
    """An (unsigned) distance field around a point cloud, computed on
    ``device`` (``cuda`` unless named) and read back to the host (site
    ``pointsdf.field``); cell centers at ``origin + i * resolution``."""
    points, dims, lo = grid_layout(points, resolution, margin)
    data = _min_dist_grid(torch.as_tensor(points,
                                          device=resolve_device(device)), dims,
                          tuple(float(v) for v in lo), resolution)
    return SignedDensityField(host_array(data, "pointsdf.field"),
                              lo.astype(np.float64), resolution)
