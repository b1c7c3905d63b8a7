"""Software RGB rendering: z-buffered triangle rasterizer for primitive
scenes (host-side numpy).

The reference's RGB observations come from a ~9k-line EGL/CUDA renderer
(``ycb_render/ycb_renderer.py:1242-1491``); this framework's visual output
is a host concern, not a device-path one (DESIGN.md §6), so RGB appearance
frames come from a small painter: tessellate each primitive, project
through the same pinhole/view convention as ``viz/camera.py``, rasterize
with per-pixel z-test and Lambert + ambient shading.  Intended for
perception-mode RGB observations, debug frames, and demo videos —
deterministic, dependency-free, fast enough at observation resolutions
(~10 ms at 160x120).

Numpy copy of ``omg_planner_tpu/viz/raster.py``.
"""

from __future__ import annotations

import numpy as np

from .camera import DEFAULT_VIEW

# a stable categorical palette (object index -> rgb)
PALETTE = np.array([
    [227, 119, 60], [92, 124, 186], [122, 208, 138], [228, 198, 98],
    [194, 122, 208], [118, 205, 205], [205, 118, 130], [160, 160, 160],
    [140, 108, 84], [188, 189, 94], [110, 130, 80], [90, 90, 140],
], np.float64) / 255.0


def primitive_mesh(kind: str, extents, n_seg: int = 24):
    """(vertices [V, 3], faces [F, 3] int) for box/cylinder/sphere in the
    object frame, matching ``io/assets.py`` extents conventions."""
    extents = np.resize(np.asarray(extents, np.float64), 3)
    if kind == "box":
        hx, hy, hz = extents / 2
        v = np.array([[sx * hx, sy * hy, sz * hz]
                      for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])
        f = np.array([
            [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],  # x faces
            [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],  # y faces
            [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],  # z faces
        ])
        return v, f
    if kind == "cylinder":
        r, h = extents[0], extents[1]
        a = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
        ring = np.stack([r * np.cos(a), r * np.sin(a)], axis=1)
        bot = np.concatenate([ring, np.full((n_seg, 1), -h / 2)], axis=1)
        top = np.concatenate([ring, np.full((n_seg, 1), h / 2)], axis=1)
        v = np.concatenate([bot, top,
                            [[0, 0, -h / 2]], [[0, 0, h / 2]]])
        cb, ct = 2 * n_seg, 2 * n_seg + 1
        f = []
        for i in range(n_seg):
            j = (i + 1) % n_seg
            f += [[i, j, n_seg + i], [j, n_seg + j, n_seg + i],
                  [cb, j, i], [ct, n_seg + i, n_seg + j]]
        return v, np.asarray(f)
    # sphere (uv, single pole vertices so the mesh is watertight)
    r = extents[0]
    n_lat = max(n_seg // 2, 3)
    lats = np.linspace(0, np.pi, n_lat + 1)[1:-1]   # interior rings only
    lons = np.linspace(0, 2 * np.pi, n_seg, endpoint=False)
    verts = [[0.0, 0.0, r]]
    for th in lats:
        for ph in lons:
            verts.append([r * np.sin(th) * np.cos(ph),
                          r * np.sin(th) * np.sin(ph),
                          r * np.cos(th)])
    verts.append([0.0, 0.0, -r])
    v = np.asarray(verts)
    south = len(v) - 1
    ring = lambda i, j: 1 + i * n_seg + (j % n_seg)
    f = []
    for j in range(n_seg):              # north cap fan
        f.append([0, ring(0, j), ring(0, j + 1)])
    for i in range(len(lats) - 1):      # quad strips
        for j in range(n_seg):
            f += [[ring(i, j), ring(i + 1, j), ring(i, j + 1)],
                  [ring(i, j + 1), ring(i + 1, j), ring(i + 1, j + 1)]]
    last = len(lats) - 1
    for j in range(n_seg):              # south cap fan
        f.append([south, ring(last, j + 1), ring(last, j)])
    return v, np.asarray(f)


def render_rgb(
    objects,
    view: np.ndarray = DEFAULT_VIEW,
    width: int = 160,
    height: int = 120,
    fx: float | None = None,
    fy: float | None = None,
    light_dir=(0.3, -0.5, -0.8),
    background=(0.09, 0.09, 0.11),
    robot_points: np.ndarray | None = None,
):
    """Render the scene: (rgb [H, W, 3] uint8, depth [H, W], seg [H, W]).

    ``view`` maps base -> camera (same convention as
    ``camera.render_point_observation``).  ``robot_points`` ([..., 3],
    base frame) splat on top in green for debug frames.
    """
    fx = fx or 131.25 * width / 160
    fy = fy or 131.25 * height / 120
    cx, cy = width / 2, height / 2
    light = np.asarray(light_dir, np.float64)
    light = light / np.linalg.norm(light)

    rgb = np.empty((height, width, 3))
    rgb[:] = background
    depth = np.full((height, width), np.inf)
    seg = np.full((height, width), -1)

    for oi, o in enumerate(objects):
        if getattr(o, "mesh", None) is not None:
            v, f = o.mesh          # true triangle mesh when available
        else:
            kind = getattr(o, "kind", "box")
            ext = (o.extents if o.extents is not None
                   else np.array([0.06, 0.06, 0.06]))
            v, f = primitive_mesh(kind, ext)
        w = v @ o.pose_mat[:3, :3].T + o.pose_mat[:3, 3]
        cam = w @ view[:3, :3].T + view[:3, 3]
        base = (PALETTE[oi % len(PALETTE)] if not o.target
                else np.array([0.92, 0.78, 0.30]))
        # textured path: per-corner UVs + texture image on the object
        # (capability parity with the reference's textured GL draw,
        # ycb_renderer.py:1242-1491)
        uv_faces = getattr(o, "mesh_uv", None)
        tex = getattr(o, "texture", None)
        textured = (uv_faces is not None and tex is not None
                    and len(uv_faces) == len(f))
        if textured:
            tex = np.asarray(tex, np.float64)
            if tex.max() > 1.5:      # uint8 image
                tex = tex / 255.0
            th, tw = tex.shape[:2]

        tri = cam[f]                                  # [F, 3, 3]
        # world-frame normals for shading
        wn = np.cross(w[f][:, 1] - w[f][:, 0], w[f][:, 2] - w[f][:, 0])
        nrm = np.linalg.norm(wn, axis=1, keepdims=True)
        wn = wn / np.maximum(nrm, 1e-12)
        shade = 0.35 + 0.65 * np.clip(-wn @ light, 0.0, None)

        z = tri[..., 2]
        keep = (z > 0.05).all(axis=1)
        for ti in np.nonzero(keep)[0]:
            t = tri[ti]
            u = fx * t[:, 0] / t[:, 2] + cx
            vv = fy * t[:, 1] / t[:, 2] + cy
            lo_u = max(int(np.floor(u.min())), 0)
            hi_u = min(int(np.ceil(u.max())) + 1, width)
            lo_v = max(int(np.floor(vv.min())), 0)
            hi_v = min(int(np.ceil(vv.max())) + 1, height)
            if lo_u >= hi_u or lo_v >= hi_v:
                continue
            gu, gv = np.meshgrid(np.arange(lo_u, hi_u),
                                 np.arange(lo_v, hi_v))
            # barycentric in screen space
            d = ((vv[1] - vv[2]) * (u[0] - u[2])
                 + (u[2] - u[1]) * (vv[0] - vv[2]))
            if abs(d) < 1e-12:
                continue
            l0 = ((vv[1] - vv[2]) * (gu - u[2])
                  + (u[2] - u[1]) * (gv - vv[2])) / d
            l1 = ((vv[2] - vv[0]) * (gu - u[2])
                  + (u[0] - u[2]) * (gv - vv[2])) / d
            l2 = 1.0 - l0 - l1
            inside = (l0 >= -1e-6) & (l1 >= -1e-6) & (l2 >= -1e-6)
            if not inside.any():
                continue
            # perspective-correct depth via 1/z interpolation
            iz = l0 / t[0, 2] + l1 / t[1, 2] + l2 / t[2, 2]
            zpix = 1.0 / np.maximum(iz, 1e-12)
            win = inside & (zpix < depth[lo_v:hi_v, lo_u:hi_u])
            if not win.any():
                continue
            sub_d = depth[lo_v:hi_v, lo_u:hi_u]
            sub_rgb = rgb[lo_v:hi_v, lo_u:hi_u]
            sub_seg = seg[lo_v:hi_v, lo_u:hi_u]
            sub_d[win] = zpix[win]
            if textured:
                # perspective-correct UV: interpolate uv/z, rescale by z
                tuv = uv_faces[ti]   # [3, 2]
                uq = (l0 * tuv[0, 0] / t[0, 2] + l1 * tuv[1, 0] / t[1, 2]
                      + l2 * tuv[2, 0] / t[2, 2]) * zpix
                vq = (l0 * tuv[0, 1] / t[0, 2] + l1 * tuv[1, 1] / t[1, 2]
                      + l2 * tuv[2, 1] / t[2, 2]) * zpix
                # wrap + nearest texel; OBJ v runs bottom-up, rows top-down
                ui = np.clip((uq[win] % 1.0) * tw, 0, tw - 1).astype(int)
                vi = np.clip((1.0 - vq[win] % 1.0) * th, 0, th - 1).astype(int)
                sub_rgb[win] = np.clip(tex[vi, ui] * shade[ti], 0, 1)
            else:
                sub_rgb[win] = np.clip(base * shade[ti], 0, 1)
            sub_seg[win] = oi

    if robot_points is not None and len(robot_points):
        p = np.asarray(robot_points).reshape(-1, 3)
        cam = p @ view[:3, :3].T + view[:3, 3]
        z = cam[:, 2]
        ok = z > 0.05
        u = np.round(fx * cam[ok, 0] / z[ok] + cx).astype(int)
        v = np.round(fy * cam[ok, 1] / z[ok] + cy).astype(int)
        zz = z[ok]
        m = (u >= 0) & (u < width) & (v >= 0) & (v < height)
        u, v, zz = u[m], v[m], zz[m]
        vis = zz <= depth[v, u] + 0.01
        rgb[v[vis], u[vis]] = [0.45, 0.85, 0.5]

    return (np.clip(rgb * 255, 0, 255).astype(np.uint8), depth, seg)
