"""Point-based camera observations (depth / segmentation / point cloud).

Replaces the reference's perception observation source — rendered
depth/mask frames back-projected into the robot base frame
(``omg/core.py:826-867``, GL renderer) — with a point-splat z-buffer over
the scenes' object surface points: project every object's points through a
pinhole camera, keep the nearest per pixel, and return the visible points
with per-point object labels.  Produces genuinely partial (self-occluded)
views like a depth camera without a GL stack.

Numpy copy of ``omg_planner_tpu/viz/camera.py``.
"""

from __future__ import annotations

import numpy as np

# the reference CLI's fixed view matrix (omg/core.py:806-813)
DEFAULT_VIEW = np.array([
    [-0.9351, 0.3518, 0.0428, 0.3037],
    [0.2065, 0.639, -0.741, 0.132],
    [-0.2881, -0.684, -0.6702, 1.8803],
    [0.0, 0.0, 0.0, 1.0],
])


def render_point_observation(
    objects,
    view: np.ndarray = DEFAULT_VIEW,
    width: int = 160,
    height: int = 120,
    fx: float | None = None,
    fy: float | None = None,
    densify: int = 4,
):
    """Returns (points [N,3] base frame, labels [N] object index,
    depth [H,W], seg [H,W]).

    ``view`` maps base -> camera.  ``densify`` jitters each surface point
    into several splats so sparse point sets cover pixels.
    """
    fx = fx or 131.25 * width / 160
    fy = fy or 131.25 * height / 120
    cx, cy = width / 2, height / 2

    pts_w, labels = [], []
    rng = np.random.default_rng(0)
    for i, o in enumerate(objects):
        if o.points is None:
            continue
        p = o.points[:, :3]
        if densify > 1:
            p = np.repeat(p, densify, axis=0)
            p = p + rng.normal(scale=0.004, size=p.shape)
        w = p @ o.pose_mat[:3, :3].T + o.pose_mat[:3, 3]
        pts_w.append(w)
        labels.append(np.full(len(w), i))
    if not pts_w:
        empty = np.zeros((0, 3))
        return empty, np.zeros(0, int), np.full((height, width), np.inf), \
            np.full((height, width), -1)
    pts_w = np.concatenate(pts_w)
    labels = np.concatenate(labels)

    cam = pts_w @ view[:3, :3].T + view[:3, 3]
    z = cam[:, 2]
    front = z > 0.05
    u = np.round(fx * cam[:, 0] / z + cx).astype(int)
    v = np.round(fy * cam[:, 1] / z + cy).astype(int)
    ok = front & (u >= 0) & (u < width) & (v >= 0) & (v < height)

    depth = np.full((height, width), np.inf)
    seg = np.full((height, width), -1)
    winner = np.full((height, width), -1)
    idx = np.nonzero(ok)[0]
    # z-buffer: nearest point wins per pixel
    order = idx[np.argsort(-z[idx])]  # far to near; near overwrites
    depth[v[order], u[order]] = z[order]
    seg[v[order], u[order]] = labels[order]
    winner[v[order], u[order]] = order

    vis = winner[winner >= 0]
    return pts_w[vis], labels[vis], depth, seg



def back_project(depth: np.ndarray, view: np.ndarray,
                 fx: float, fy: float) -> np.ndarray:
    """Depth image -> base-frame points (the reference's perception
    back-projection, ``omg/core.py:851-854``)."""
    h, w = depth.shape
    cx, cy = w / 2, h / 2
    v, u = np.nonzero(np.isfinite(depth))
    z = depth[v, u]
    cam = np.stack([(u - cx) * z / fx, (v - cy) * z / fy, z], axis=1)
    inv = np.linalg.inv(view)
    return cam @ inv[:3, :3].T + inv[:3, 3]
