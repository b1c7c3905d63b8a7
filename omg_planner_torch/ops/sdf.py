"""Signed-distance-field containers, scene stacking and the collision
query (counterpart of ``omg_planner_tpu/ops/sdf.py``).

Host side: :class:`SignedDensityField` (numpy) as in the JAX package.
Device side, the collision query's three backends:

* :class:`AnalyticScene` — true primitive SDF + closed-form gradient at
  the query points (all-primitive scenes, the production default);
* :class:`SceneSDF` — the padded voxel stack, read by the exact query:
  seven trilinear sweeps per (point, object), the value and the central
  differences of the interpolated field (``sdf_baked=False``);
* :class:`BakedSceneSDF` — the padded voxel stack with baked
  central-difference gradient channels, one 4-channel trilinear read per
  (point, object) (the grid default, and perception point clouds);
* :class:`WorldPotential` — the learner's scene-fused scoring field;
* :class:`WorldField` — the scene-fused 5-channel CHOMP field of
  ``cfg.sdf_fused``: one trilinear read per point replaces the
  per-object query.

:func:`stage_scene_sdfs` synthesises the voxel stack of a primitive scene
on the device from ~13 floats per object (``sdf_analytic=False``).  Grid
conventions are kept exactly: C-style ``trunc`` of ``pg - 0.5`` and
out-of-volume value 1.0 in the trilinear query (``kernel.cu:37-64``), the
``floor`` nearest cell in the world-potential and world-field bakes and
lookups, and out-of-grid potential 0.

The analytic and the baked query run as the hand-written ``sdf_query``
kernel on the card (``ops/kernels.py``, ``csrc/sdf_query.cu``) and as
their plain versions here on the CPU; the exact query and the fused field
stay in torch.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import kernels

ANALYTIC_KINDS = {"box": 0, "sphere": 1, "cylinder": 2}


class SignedDensityField:
    """A voxelized SDF ``data[x, y, z]`` with uniform cell size ``delta``.

    Analytic primitives (:meth:`from_analytic`) are lazy: only metadata is
    stored and the host grid is built on first ``.data`` access."""

    def __init__(self, data: np.ndarray | None, origin: np.ndarray,
                 delta: float):
        self._data = None if data is None else np.asarray(data, np.float32)
        if self._data is not None:
            self.nx, self.ny, self.nz = self._data.shape
        self.origin = np.asarray(origin, np.float64).copy()
        self.delta = float(delta)
        # (kind_code, half_extents[3], inside_penalty) for primitives
        self.analytic: tuple | None = None

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            self._data = self._build_analytic_grid()
        return self._data

    @data.setter
    def data(self, value):
        self._data = np.asarray(value, np.float32)

    @property
    def shape(self) -> tuple:
        return (self.nx, self.ny, self.nz)

    @property
    def min_coords(self) -> np.ndarray:
        return self.origin

    @property
    def max_coords(self) -> np.ndarray:
        return self.origin + self.delta * np.array(self.shape)

    def resize(self, ratio: float) -> "SignedDensityField":
        """Uniform metric rescale (reference ``sdf_tools.py:37-45``).  The
        SDFs of box, sphere and cylinder are positively homogeneous, so the
        analytic metadata rescales exactly and a lazy grid stays lazy."""
        if self._data is not None:
            self._data = self._data * ratio
        if self.analytic is not None:
            k, half, pen = self.analytic
            self.analytic = (k, half * ratio, pen)
        self.delta *= ratio
        self.origin = self.origin * ratio
        return self

    def penalize_inside(self, constant: float) -> "SignedDensityField":
        """Scale negative (inside) distances (reference ``core.py:110``)."""
        if self.analytic is not None:
            k, half, pen = self.analytic
            self.analytic = (k, half, pen * float(constant))
        if self._data is not None:
            self._data = np.where(
                self._data < 0, self._data * constant, self._data)
        return self

    # host-side nearest-cell lookups (reference sdf_tools.py:47-111)
    def _idx(self, rel_pos):
        idx = ((rel_pos - self.origin) / self.delta).astype(int)
        return np.clip(idx, 0, np.array(self.data.shape) - 1)

    def get_distance(self, rel_pos):
        i = self._idx(rel_pos)
        return self.data[i[..., 0], i[..., 1], i[..., 2]]

    # ---- loaders of the reference's formats
    @classmethod
    def from_pth(cls, path: str) -> "SignedDensityField":
        """Load the reference's ``*_chomp.pth`` layout (a torch dict with
        ``sdf_torch [1,1,X,Y,Z]``, ``min_coords``, ``max_coords``,
        ``delta``; written by ``real_world/convert_sdf.py:66-78``)."""
        # weights_only=False: the layout stores numpy scalars beside the
        # tensor (convert_sdf.py:66-78)
        d = torch.load(path, map_location="cpu", weights_only=False)
        # the reference loader swaps the first two axes of the stored
        # volume (sdf_tools.py:191: ``permute(1, 0, 2)``), which its writer
        # relies on for pose and limits
        data = d["sdf_torch"][0, 0].permute(1, 0, 2).numpy()
        origin = np.asarray(d["min_coords"], np.float64)
        delta = float(np.asarray(d["delta"]).reshape(-1)[0])
        return cls(data, origin, delta)

    @classmethod
    def from_sdf_file(cls, path: str) -> "SignedDensityField":
        """Parse SDFGen's text format (``sdf_tools.py:168-183``)."""
        with open(path) as f:
            dims = [int(v) for v in f.readline().split()]
            origin = np.array([float(v) for v in f.readline().split()])
            delta = float(f.readline().strip())
            data = np.loadtxt(f).reshape(dims[::-1]).transpose(2, 1, 0)
        return cls(data, origin, delta)

    @classmethod
    def from_pkl(cls, path: str) -> "SignedDensityField":
        """Load a field written by :meth:`dump` (pickle: only load files
        this program wrote)."""
        import pickle

        with open(path, "rb") as f:
            d = pickle.load(f)
        return cls(d["data"], d["origin"], d["delta"])

    def dump(self, path: str):
        """Write the grid, origin and cell size as a pickle."""
        import pickle

        with open(path, "wb") as f:
            pickle.dump({"data": self.data, "origin": self.origin,
                         "delta": self.delta}, f)

    @classmethod
    def from_analytic(cls, kind: str, extents, delta: float = 0.0075,
                      padding: int = 12) -> "SignedDensityField":
        """Exact SDF of a primitive centered at the origin (lazy).

        kind: 'box' (extents = full xyz size), 'sphere' (extents = [r]),
        'cylinder' (extents = [radius, height])."""
        extents = np.asarray(extents, np.float64)
        if kind == "box":
            half = extents / 2.0
        elif kind == "sphere":
            half = np.array([extents[0]] * 3)
        elif kind == "cylinder":
            half = np.array([extents[0], extents[0], extents[1] / 2.0])
        else:
            raise ValueError(kind)
        dims = (np.ceil(2 * half / delta) + 2 * padding).astype(int)
        origin = -(dims * delta) / 2.0
        obj = cls(None, origin, delta)
        obj.nx, obj.ny, obj.nz = (int(v) for v in dims)
        obj.analytic = (ANALYTIC_KINDS[kind], half, 1.0)
        return obj

    def _build_analytic_grid(self) -> np.ndarray:
        """Host materialization of a lazy analytic primitive (float64 math,
        float32 cast)."""
        kind_code, half, pen = self.analytic
        dims = self.shape
        ax = [self.origin[i] + (np.arange(dims[i]) + 0.5) * self.delta
              for i in range(3)]
        x, y, z = np.meshgrid(*ax, indexing="ij")
        if kind_code == 0:  # box
            qx, qy, qz = (np.abs(x) - half[0], np.abs(y) - half[1],
                          np.abs(z) - half[2])
            outside = np.sqrt(np.maximum(qx, 0) ** 2 + np.maximum(qy, 0) ** 2
                              + np.maximum(qz, 0) ** 2)
            inside = np.minimum(np.maximum(qx, np.maximum(qy, qz)), 0.0)
            data = outside + inside
        elif kind_code == 1:  # sphere
            data = np.sqrt(x * x + y * y + z * z) - half[0]
        else:  # cylinder: half = [r, r, height/2]
            dr = np.sqrt(x * x + y * y) - half[0]
            dz = np.abs(z) - half[2]
            outside = np.sqrt(np.maximum(dr, 0) ** 2 + np.maximum(dz, 0) ** 2)
            inside = np.minimum(np.maximum(dr, dz), 0.0)
            data = outside + inside
        data = data.astype(np.float32)
        if pen != 1.0:
            data = np.where(data < 0, data * np.float32(pen), data)
        return data


class SceneSDF(NamedTuple):
    """Padded per-object SDF stack ``data [O, X, Y, Z]`` with
    ``limits[o] = [xmin, ymin, zmin, xmax_pad, ymax_pad, zmax_pad, d0, d1,
    d2, delta]`` as ``Env.combine_sdfs`` builds them
    (``omg/core.py:366-411``)."""

    data: torch.Tensor
    limits: torch.Tensor

    @property
    def num_objects(self) -> int:
        return self.data.shape[0]


def scene_limits(fields: Sequence[SignedDensityField],
                 pad_to: tuple | None = None,
                 pad_multiple: int = 16) -> tuple:
    """``(limits [O,10] float32, max_shape [3] int)`` of the padded stack:
    padded cells count as +1 and the max coordinate is stretched so the
    cell size is preserved."""
    shapes = np.array([f.shape for f in fields])
    max_shape = shapes.max(axis=0) if pad_to is None else np.asarray(pad_to)
    if pad_multiple > 1:
        max_shape = ((max_shape + pad_multiple - 1)
                     // pad_multiple) * pad_multiple
    limits = np.zeros((len(fields), 10), np.float32)
    for i, f in enumerate(fields):
        sx, sy, sz = f.shape
        mn, mx = f.min_coords, f.max_coords
        limits[i, 0:3] = mn
        limits[i, 3] = mn[0] + (mx[0] - mn[0]) * max_shape[0] / sx
        limits[i, 4] = mn[1] + (mx[1] - mn[1]) * max_shape[1] / sy
        limits[i, 5] = mn[2] + (mx[2] - mn[2]) * max_shape[2] / sz
        limits[i, 6:9] = max_shape
        limits[i, 9] = f.delta
    return limits, max_shape


def combine_sdfs(fields: Sequence[SignedDensityField], device,
                 pad_to: tuple | None = None,
                 pad_multiple: int = 16) -> SceneSDF:
    """Stack per-object volumes on ``device``, padded to a common shape
    (dims rounded up to ``pad_multiple``) with +1 fill."""
    limits, max_shape = scene_limits(fields, pad_to, pad_multiple)
    data = np.ones((len(fields), *max_shape), np.float32)
    for i, f in enumerate(fields):
        sx, sy, sz = f.shape
        data[i, :sx, :sy, :sz] = f.data
    return SceneSDF(torch.as_tensor(data, device=device),
                    torch.as_tensor(limits, device=device))


def analytic_prim_arrays(fields: Sequence[SignedDensityField],
                         pad_to: tuple | None = None,
                         pad_multiple: int = 16):
    """Per-object analytic metadata for device synthesis, or None when any
    field is data-backed: ``(kinds, halfs, penals, origins, deltas,
    dims_actual, limits, max_shape)`` as numpy arrays."""
    if not fields or any(f.analytic is None for f in fields):
        return None
    limits, max_shape = scene_limits(fields, pad_to, pad_multiple)
    return (np.array([f.analytic[0] for f in fields], np.int32),
            np.array([f.analytic[1] for f in fields], np.float32),
            np.array([f.analytic[2] for f in fields], np.float32),
            np.array([f.origin for f in fields], np.float32),
            np.array([f.delta for f in fields], np.float32),
            np.array([f.shape for f in fields], np.int32),
            limits, max_shape)


def _synth_stack(kind, half, penal, origin, delta, dims, bucket):
    """Padded analytic SDF stack ``[O, X, Y, Z]`` on the device: the
    primitive formulas of :meth:`SignedDensityField.from_analytic` at every
    (object, cell), selected by kind code, the inside penalty applied, and
    cells beyond an object's own dims filled with +1 as ``combine_sdfs``
    pads."""
    nx, ny, nz = bucket
    dev = kind.device

    def axis(n, a):
        # cell centres rounded once to float32, as a fused multiply-add
        # gives them: the baked gradient channels scale a centre's
        # rounding by 1 / (2 delta)
        i = torch.arange(n, dtype=torch.float64, device=dev)
        return (origin[:, a, None].double()
                + (i[None, :] + 0.5) * delta[:, None].double()).float()

    x, y, z = axis(nx, 0), axis(ny, 1), axis(nz, 2)          # [O, n] each
    qx = (torch.abs(x) - half[:, 0:1])[:, :, None, None]     # [O,X,1,1]
    qy = (torch.abs(y) - half[:, 1:2])[:, None, :, None]     # [O,1,Y,1]
    qz = (torch.abs(z) - half[:, 2:3])[:, None, None, :]     # [O,1,1,Z]
    box = (torch.sqrt(torch.clamp(qx, min=0.0) ** 2
                      + torch.clamp(qy, min=0.0) ** 2
                      + torch.clamp(qz, min=0.0) ** 2)
           + torch.clamp(torch.maximum(qx, torch.maximum(qy, qz)), max=0.0))
    r2 = (x * x)[:, :, None, None] + (y * y)[:, None, :, None]
    rad = half[:, 0, None, None, None]
    sphere = torch.sqrt(r2 + (z * z)[:, None, None, :]) - rad
    dr = torch.sqrt(r2) - rad                                # [O,X,Y,1]
    cyl = (torch.sqrt(torch.clamp(dr, min=0.0) ** 2
                      + torch.clamp(qz, min=0.0) ** 2)
           + torch.clamp(torch.maximum(dr, qz), max=0.0))
    k = kind[:, None, None, None]
    d = torch.where(k == 0, box, torch.where(k == 1, sphere, cyl))
    d = torch.where(d < 0.0, d * penal[:, None, None, None], d)

    def inside(n, a):
        return torch.arange(n, device=dev)[None, :] < dims[:, a:a + 1]

    pad_ok = (inside(nx, 0)[:, :, None, None] & inside(ny, 1)[:, None, :, None]
              & inside(nz, 2)[:, None, None, :])
    return torch.where(pad_ok, d, torch.ones_like(d))


def stage_scene_sdfs(fields: Sequence[SignedDensityField], device,
                     baked: bool = False, pad_to: tuple | None = None,
                     pad_multiple: int = 16):
    """The scene's padded voxel stack on ``device`` (baked when asked).

    When every field is an analytic primitive the stack is synthesised on
    the device from the per-object metadata (no host grid, no volume
    transfer); data-backed fields are stacked on the host."""
    prims = analytic_prim_arrays(fields, pad_to, pad_multiple)
    if prims is not None:
        kinds, halfs, pens, origins, deltas, dims, limits, max_shape = prims

        def t(a):
            return torch.as_tensor(a, device=device)

        stack = SceneSDF(
            _synth_stack(t(kinds), t(halfs), t(pens), t(origins), t(deltas),
                         t(dims), tuple(int(v) for v in max_shape)),
            t(limits))
    else:
        stack = combine_sdfs(fields, device, pad_to=pad_to,
                             pad_multiple=pad_multiple)
    return bake_scene(stack) if baked else stack


def _bcast(a: torch.Tensor, p_ndim: int) -> torch.Tensor:
    """Append ``p_ndim - 2`` singleton axes to a per-object array."""
    return a.reshape(a.shape + (1,) * (p_ndim - 2))


def _round_radius(rounds, half, p_ndim):
    """Edge-rounding radii ``rounds [O]`` broadcast against points,
    clamped so thin objects can't invert (r < 0.45 * min half extent)."""
    r = torch.minimum(rounds, 0.45 * half.min(-1).values)
    return _bcast(r, p_ndim)


def _half_b(half, rounds, p_ndim):
    hb = half.reshape(half.shape[:1] + (1,) * (p_ndim - 2) + (3,))
    if rounds is None:
        return 0.0, hb
    rr = _round_radius(rounds, half, p_ndim)
    return rr, hb - rr[..., None]


def _analytic_sdf_points(kind, half, penal, p, rounds=None):
    """Analytic primitive SDF at object-frame points ``p [O, ..., 3]``
    with the inside penalty (and optional edge rounding) applied."""
    rr, hb = _half_b(half, rounds, p.ndim)
    q = torch.abs(p) - hb
    qx, qy, qz = q[..., 0], q[..., 1], q[..., 2]
    box = (torch.sqrt(torch.clamp(qx, min=0.0) ** 2
                      + torch.clamp(qy, min=0.0) ** 2
                      + torch.clamp(qz, min=0.0) ** 2)
           + torch.clamp(torch.maximum(qx, torch.maximum(qy, qz)), max=0.0))
    rad = hb[..., 0]
    sph = torch.sqrt((p * p).sum(-1)) - rad
    dr = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2) - rad
    cyl = (torch.sqrt(torch.clamp(dr, min=0.0) ** 2
                      + torch.clamp(qz, min=0.0) ** 2)
           + torch.clamp(torch.maximum(dr, qz), max=0.0))
    k = _bcast(kind, p.ndim)
    d = torch.where(k == 0, box, torch.where(k == 1, sph, cyl)) - rr
    pen = _bcast(penal, p.ndim)
    return torch.where(d < 0.0, d * pen, d)


def _analytic_sdf_grad(kind, half, penal, p, rounds=None):
    """(penalized SDF, object-frame gradient) at points ``p [O, ..., 3]``:
    the closed-form derivatives of :func:`_analytic_sdf_points`."""
    tiny = 1e-12
    rr, hb = _half_b(half, rounds, p.ndim)
    sp = torch.sign(p)
    q = torch.abs(p) - hb
    qp = torch.clamp(q, min=0.0)
    qx, qy, qz = q[..., 0], q[..., 1], q[..., 2]

    # box
    l_out = torch.sqrt((qp * qp).sum(-1))
    qmax = torch.maximum(qx, torch.maximum(qy, qz))
    box = l_out + torch.clamp(qmax, max=0.0)
    g_out = sp * qp / torch.clamp(l_out, min=tiny)[..., None]
    is_max = (q == qmax[..., None]).to(p.dtype)
    is_max = is_max / torch.clamp(is_max.sum(-1, keepdim=True), min=1.0)
    g_in = sp * is_max
    box_g = torch.where((l_out > 0.0)[..., None], g_out, g_in)

    # sphere
    rad = hb[..., 0]
    pn = torch.sqrt((p * p).sum(-1))
    sph = pn - rad
    sph_g = p / torch.clamp(pn, min=tiny)[..., None]

    # cylinder (axis z, radius hb[..., 0], half-height hb[..., 2])
    rho = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
    dr = rho - rad
    a = torch.clamp(dr, min=0.0)
    b = torch.clamp(qz, min=0.0)
    l_cyl = torch.sqrt(a * a + b * b)
    cyl = l_cyl + torch.clamp(torch.maximum(dr, qz), max=0.0)
    er = p[..., :2] / torch.clamp(rho, min=tiny)[..., None]
    sz = sp[..., 2]
    l_safe = torch.clamp(l_cyl, min=tiny)
    cg_out = torch.cat([(a / l_safe)[..., None] * er,
                        ((b / l_safe) * sz)[..., None]], dim=-1)
    radial_in = (dr >= qz)[..., None]
    cg_in = torch.where(
        radial_in,
        torch.cat([er, torch.zeros_like(sz)[..., None]], dim=-1),
        torch.cat([torch.zeros_like(er), sz[..., None]], dim=-1))
    cyl_g = torch.where((l_cyl > 0.0)[..., None], cg_out, cg_in)

    k = _bcast(kind, p.ndim)
    d = torch.where(k == 0, box, torch.where(k == 1, sph, cyl)) - rr
    g = torch.where(k[..., None] == 0, box_g,
                    torch.where(k[..., None] == 1, sph_g, cyl_g))
    pen = _bcast(penal, p.ndim)
    scale = torch.where(d < 0.0, pen, torch.ones_like(pen))
    return d * scale, g * scale[..., None]


class AnalyticScene(NamedTuple):
    """Grid-free scene of analytic primitives: the collision query
    evaluates the true primitive SDF and its closed-form gradient."""

    kinds: torch.Tensor   # [O] int32 (0 box, 1 sphere, 2 cylinder)
    halfs: torch.Tensor   # [O, 3]
    penals: torch.Tensor  # [O] inside-penalty scale
    rounds: torch.Tensor  # [O] edge-rounding radius (= the grid delta)

    @property
    def num_objects(self) -> int:
        return self.kinds.shape[0]


def make_analytic_scene(fields: Sequence[SignedDensityField], device):
    """AnalyticScene for an all-analytic field list, else None."""
    if not fields or any(f.analytic is None for f in fields):
        return None
    return AnalyticScene(
        kinds=torch.as_tensor([f.analytic[0] for f in fields],
                              dtype=torch.int32, device=device),
        halfs=torch.as_tensor(
            np.stack([f.analytic[1] for f in fields]).astype(np.float32),
            device=device),
        penals=torch.as_tensor([f.analytic[2] for f in fields],
                               dtype=torch.float32, device=device),
        rounds=torch.as_tensor([float(f.delta) for f in fields],
                               dtype=torch.float32, device=device))


def _to_object_frame(inv_poses, points):
    r = inv_poses[:, :3, :3]
    t = inv_poses[:, :3, 3]
    return r, torch.einsum("oab,pb->opa", r, points) + t[:, None, :]


def _hinge(value, epsilons, padding_scales):
    """CHOMP hinge potential and its gradient scale (kernel.cu:149-195)::

        d <= 0:        -d + eps/2,                  scale -1
        0 < d <= eps:  (d-eps)^2/(2 eps) * pad,     scale (d-eps)/eps * pad
        d > eps:       0                            scale 0
    """
    eps = epsilons[:, None]
    pad = padding_scales[:, None]
    inside = value <= 0
    band = (value > 0) & (value <= eps)
    zero = torch.zeros_like(value)
    pot = torch.where(inside, -value + 0.5 * eps, zero)
    pot = torch.where(band, (value - eps) ** 2 / (2 * eps) * pad, pot)
    gscale = torch.where(inside, -torch.ones_like(value),
                         torch.where(band, (value - eps) / eps * pad, zero))
    return pot, gscale


def _hinge_and_reduce(value, grad_obj, r, epsilons, padding_scales,
                      clearances, disables):
    """Hinge potential + world rotation + object reduction
    (kernel.cu:149-195): (pot [P], grad [P, 3], collide [P])."""
    pot, gscale = _hinge(value, epsilons, padding_scales)
    grad_obj = grad_obj * gscale[..., None]
    collide = (value < clearances[:, None]).to(pot.dtype)
    grad_w = torch.einsum("oba,opb->opa", r, grad_obj)
    keep = (disables <= 0).to(pot.dtype)[:, None]
    return ((pot * keep).sum(0), (grad_w * keep[..., None]).sum(0),
            (collide * keep).sum(0))


def sdf_potentials_analytic(scene: AnalyticScene, inv_poses, points,
                            epsilons, padding_scales, clearances, disables):
    """Grid-free exact query: same signature/semantics as
    :func:`sdf_potentials` without voxelization error.  The ``sdf_query``
    kernel on the card, :func:`sdf_potentials_analytic_plain` on the
    CPU."""
    return kernels.sdf_query(scene, inv_poses, points, epsilons,
                             padding_scales, clearances, disables)


def sdf_potentials_analytic_plain(scene: AnalyticScene, inv_poses, points,
                                  epsilons, padding_scales, clearances,
                                  disables):
    """The plain version of :func:`sdf_potentials_analytic` (of the
    ``sdf_query`` kernel's analytic form)."""
    r, pts_obj = _to_object_frame(inv_poses, points)
    value, grad_obj = _analytic_sdf_grad(
        scene.kinds, scene.halfs, scene.penals, pts_obj,
        rounds=scene.rounds)
    return _hinge_and_reduce(value, grad_obj, r, epsilons, padding_scales,
                             clearances, disables)


class BakedSceneSDF(NamedTuple):
    """SDF stack with pre-baked central-difference gradient channels:
    ``data4[o, x, y, z] = [value, dx, dy, dz]``."""

    data4: torch.Tensor   # [O, X, Y, Z, 4]
    limits: torch.Tensor  # [O, 10]

    @property
    def num_objects(self) -> int:
        return self.data4.shape[0]


def bake_scene(scene) -> BakedSceneSDF:
    """One-time per-scene bake of the gradient channels: one-cell central
    differences over delta, with +1 beyond each border.  Idempotent."""
    if isinstance(scene, BakedSceneSDF):
        return scene
    v = scene.data  # [O, X, Y, Z]
    delta = scene.limits[:, 9][:, None, None, None]

    def cdiff(axis):
        n = v.shape[axis]
        ones = torch.ones_like(v.narrow(axis, 0, 1))
        upper = torch.cat([v.narrow(axis, 1, n - 1), ones], dim=axis)
        lower = torch.cat([ones, v.narrow(axis, 0, n - 1)], dim=axis)
        return 0.5 * (upper - lower) / delta

    data4 = torch.stack([v, cdiff(1), cdiff(2), cdiff(3)], dim=-1)
    return BakedSceneSDF(data4=data4, limits=scene.limits)


def _grid_coords(limits, pts_obj):
    """(grid coordinates [O, P, 3] of object-frame points, dims [O, 3]
    int32) of every object's padded volume."""
    dims = limits[:, 6:9].to(torch.int32)
    mn = limits[:, None, 0:3]
    mx = limits[:, None, 3:6]
    pg = (pts_obj - mn) / (mx - mn) * dims[:, None, :].to(pts_obj.dtype)
    return pg, dims


def _trilinear(vol, dims, pg):
    """Trilinear read of every object's volume ``vol [O, V, C]`` (cells in
    x, y, z order) at its grid coordinates ``pg [O, P, 3]``: ``(out [O, P,
    C], inb [O, P])``, with ``inb`` False where the 8-cell stencil leaves
    the volume.  C-style truncation of ``pg - 0.5`` as
    ``getValueInterpolated`` (kernel.cu:37-64)."""
    o, vcells = vol.shape[:2]
    flat = vol.reshape(o * vcells, -1)
    p = pg - 0.5
    c0 = torch.trunc(p).to(torch.int32)
    f = p - c0
    d0, d1, d2 = (dims[:, i:i + 1] for i in range(3))   # [O, 1]
    x0, y0, z0 = c0[..., 0], c0[..., 1], c0[..., 2]
    inb = ((x0 >= 0) & (x0 + 1 < d0) & (y0 >= 0) & (y0 + 1 < d1)
           & (z0 >= 0) & (z0 + 1 < d2))
    x0c = torch.minimum(torch.clamp(x0, min=0), d0 - 2)
    y0c = torch.minimum(torch.clamp(y0, min=0), d1 - 2)
    z0c = torch.minimum(torch.clamp(z0, min=0), d2 - 2)
    off = (torch.arange(o, device=pg.device) * vcells)[:, None]
    base = ((x0c * d1 + y0c) * d2 + z0c).long() + off
    d1l, d2l = d1.long(), d2.long()

    def val(dx, dy, dz):
        return flat[base + (dx * d1l + dy) * d2l + dz]

    fx = f[..., 0:1]
    fy = f[..., 1:2]
    fz = f[..., 2:3]
    dx00 = val(0, 0, 0) * (1 - fx) + val(1, 0, 0) * fx
    dx01 = val(0, 0, 1) * (1 - fx) + val(1, 0, 1) * fx
    dx10 = val(0, 1, 0) * (1 - fx) + val(1, 1, 0) * fx
    dx11 = val(0, 1, 1) * (1 - fx) + val(1, 1, 1) * fx
    dxy0 = dx00 * (1 - fy) + dx10 * fy
    dxy1 = dx01 * (1 - fy) + dx11 * fy
    return dxy0 * (1 - fz) + dxy1 * fz, inb


def _query_exact(scene: SceneSDF, pts_obj: torch.Tensor):
    """The exact grid query of every object (the JAX package's
    ``_query_one_object``, vmapped over objects there): the trilinear value
    (out of volume 1.0) and the central differences of the interpolated
    field one cell apart (kernel.cu:66-86) -> (value [O, P], object-frame
    grad [O, P, 3])."""
    pg, dims = _grid_coords(scene.limits, pts_obj)
    vol = scene.data.reshape(scene.num_objects, -1, 1)
    delta = scene.limits[:, 9, None]

    def value_at(q):
        out, inb = _trilinear(vol, dims, q)
        return torch.where(inb, out[..., 0], torch.ones_like(out[..., 0]))

    eye = torch.eye(3, dtype=pg.dtype, device=pg.device)
    grad = torch.stack([0.5 * (value_at(pg + eye[a]) - value_at(pg - eye[a]))
                        / delta for a in range(3)], dim=-1)
    return value_at(pg), grad


def _query_baked(scene: BakedSceneSDF, pts_obj: torch.Tensor):
    """4-channel trilinear read of every object: (value [O, P],
    object-frame grad [O, P, 3]); out of volume -> (1.0, 0)."""
    pg, dims = _grid_coords(scene.limits, pts_obj)
    out, inb = _trilinear(scene.data4.reshape(scene.num_objects, -1, 4),
                          dims, pg)                      # [O, P, 4]
    value = torch.where(inb, out[..., 0], torch.ones_like(out[..., 0]))
    grad = torch.where(inb[..., None], out[..., 1:],
                       torch.zeros_like(out[..., 1:]))
    return value, grad


def _query_one_object_baked(scene: BakedSceneSDF, o: int, pts_obj):
    """(value [P], grad [P, 3]) of object ``o`` at its object-frame
    points (the JAX package's per-object form, vmapped there)."""
    one = BakedSceneSDF(scene.data4[o:o + 1], scene.limits[o:o + 1])
    value, grad = _query_baked(one, pts_obj[None])
    return value[0], grad[0]


def sdf_potentials_baked(scene: BakedSceneSDF, inv_poses, points, epsilons,
                         padding_scales, clearances, disables):
    """Query over a pre-baked 4-channel stack (see :class:`BakedSceneSDF`):
    the ``sdf_query`` kernel on the card, :func:`sdf_potentials_baked_plain`
    on the CPU."""
    return kernels.sdf_query(scene, inv_poses, points, epsilons,
                             padding_scales, clearances, disables)


def sdf_potentials_baked_plain(scene: BakedSceneSDF, inv_poses, points,
                               epsilons, padding_scales, clearances,
                               disables):
    """The plain version of :func:`sdf_potentials_baked` (of the
    ``sdf_query`` kernel's baked form)."""
    r, pts_obj = _to_object_frame(inv_poses, points)
    value, grad_obj = _query_baked(scene, pts_obj)
    return _hinge_and_reduce(value, grad_obj, r, epsilons, padding_scales,
                             clearances, disables)


def sdf_potentials(scene, inv_poses, points, epsilons, padding_scales,
                   clearances, disables):
    """Returns (potentials [P], grads [P, 3] world frame, collides [P]) of
    world points ``[P, 3]`` against every object (``inv_poses [O, 4, 4]``
    world -> object; ``disables > 0`` drops an object)."""
    if isinstance(scene, AnalyticScene):
        return sdf_potentials_analytic(scene, inv_poses, points, epsilons,
                                       padding_scales, clearances, disables)
    if isinstance(scene, BakedSceneSDF):
        return sdf_potentials_baked(scene, inv_poses, points, epsilons,
                                    padding_scales, clearances, disables)
    r, pts_obj = _to_object_frame(inv_poses, points)
    value, grad_obj = _query_exact(scene, pts_obj)
    return _hinge_and_reduce(value, grad_obj, r, epsilons, padding_scales,
                             clearances, disables)


class WorldPotential(NamedTuple):
    """Scene-fused hinge-potential field on a world-frame grid, the online
    learner's goal-candidate scoring field; 0 outside the grid."""

    data: torch.Tensor    # [X, Y, Z]
    origin: torch.Tensor  # [3]
    delta: torch.Tensor   # scalar

    @property
    def dims(self):
        return self.data.shape


# default workspace bounds for the Panda at the origin (meters)
WORLD_BOUNDS = (np.array([-0.4, -0.9, -0.15]), np.array([1.1, 0.9, 1.25]))


def _world_cells(bounds, resolution, device):
    lo, hi = bounds
    dims = tuple(int(np.ceil((hi[i] - lo[i]) / resolution)) for i in range(3))
    ax = [float(lo[i]) + (torch.arange(dims[i], dtype=torch.float32,
                                       device=device) + 0.5) * resolution
          for i in range(3)]
    gx, gy, gz = torch.meshgrid(*ax, indexing="ij")
    return dims, torch.stack([gx, gy, gz], dim=-1).reshape(-1, 3)


def _nearest_cells(limits, vcells: int, pts_obj):
    """Nearest (``floor``) cell of every object-frame point in its object's
    padded volume of ``vcells`` cells: (flat index [O, P] into the
    ``[O * vcells]`` stack, in-volume mask [O, P])."""
    d_i32 = limits[:, 6:9].to(torch.int32)
    mn = limits[:, None, 0:3]
    mx = limits[:, None, 3:6]
    pg = (pts_obj - mn) / (mx - mn) * d_i32[:, None, :].to(pts_obj.dtype)
    idx = torch.floor(pg).to(torch.int32)
    inb = torch.all((idx >= 0) & (idx < d_i32[:, None, :]), dim=-1)
    ic = torch.minimum(torch.clamp(idx, min=0), d_i32[:, None, :] - 1)
    obj_off = torch.arange(limits.shape[0], device=limits.device) * vcells
    lin = (((ic[..., 0] * d_i32[:, None, 1] + ic[..., 1])
            * d_i32[:, None, 2] + ic[..., 2]).long() + obj_off[:, None])
    return lin, inb


def bake_world_potential(scene, inv_poses, epsilons, padding_scales,
                         clearances, disables, resolution: float = 0.015,
                         bounds=WORLD_BOUNDS, chunk: int = 262144,
                         nearest: bool = True) -> WorldPotential:
    """Summed hinge potential on a world grid, once per scene.

    ``nearest=True`` reads each object's value channel at the ``floor``
    nearest cell (1 gather per cell x object; out of volume -> 1.0), as
    the JAX package does for grid scenes; otherwise (and for analytic
    scenes) the full query runs at every cell."""
    device = inv_poses.device
    dims, cells = _world_cells(bounds, resolution, device)
    lo = bounds[0]
    if nearest and not isinstance(scene, AnalyticScene):
        vals = (scene.data4[..., 0] if isinstance(scene, BakedSceneSDF)
                else scene.data)                        # [O, X, Y, Z]
        vcells = int(np.prod(vals.shape[1:4]))
        flat_all = vals.reshape(-1)
        keep = (disables <= 0)[:, None]

        def body(c):
            _, pts_obj = _to_object_frame(inv_poses, c)
            lin, inb = _nearest_cells(scene.limits, vcells, pts_obj)
            value = torch.where(inb, flat_all[lin],
                                torch.ones_like(lin, dtype=vals.dtype))
            pot, _ = _hinge(value, epsilons, padding_scales)
            return torch.where(keep, pot, torch.zeros_like(pot)).sum(0)
    else:
        def body(c):
            return sdf_potentials(scene, inv_poses, c, epsilons,
                                  padding_scales, clearances, disables)[0]

    pots = torch.cat([body(c) for c in torch.split(cells, chunk)])
    return WorldPotential(
        data=pots.reshape(dims),
        origin=torch.as_tensor(lo, dtype=torch.float32, device=device),
        delta=torch.tensor(resolution, dtype=torch.float32, device=device))


def bake_world_potential_analytic(kinds, halfs, penals, limits, inv_poses,
                                  epsilons, padding_scales, disables,
                                  dims_actual, resolution: float = 0.015,
                                  bounds=WORLD_BOUNDS, snap: bool = True,
                                  chunk: int = 262144) -> WorldPotential:
    """Learner scoring field of a primitive scene staged on the grid
    backend, with no voxel stack: the summed hinge potential of the sharp
    primitive SDF (``rounds`` is not used) at every world cell.

    ``snap=True`` (parity mode) reproduces :func:`bake_world_potential`'s
    nearest-cell read: the value at the point's ``floor`` object cell is
    the primitive SDF at that cell's centre, and +1.0 outside the object's
    actual dims ``dims_actual [O, 3]``.  ``snap=False`` (production)
    evaluates the true SDF at the world cell centre."""
    device = inv_poses.device
    dims, cells = _world_cells(bounds, resolution, device)
    keep = (disables <= 0)[:, None]
    mn = limits[:, None, 0:3]
    mx = limits[:, None, 3:6]
    dpad = limits[:, None, 6:9]
    delta = limits[:, 9]
    da = dims_actual[:, None, :]

    def body(c):
        _, pts_obj = _to_object_frame(inv_poses, c)
        if snap:
            idx = torch.floor((pts_obj - mn) / (mx - mn) * dpad)
            inb = torch.all((idx >= 0) & (idx < da.to(idx.dtype)), dim=-1)
            center = mn + (idx + 0.5) * delta[:, None, None]
            value = torch.where(
                inb, _analytic_sdf_points(kinds, halfs, penals, center),
                torch.ones_like(idx[..., 0]))
        else:
            value = _analytic_sdf_points(kinds, halfs, penals, pts_obj)
        pot, _ = _hinge(value, epsilons, padding_scales)
        return torch.where(keep, pot, torch.zeros_like(pot)).sum(0)

    pots = torch.cat([body(c) for c in torch.split(cells, chunk)])
    return WorldPotential(
        data=pots.reshape(dims),
        origin=torch.as_tensor(bounds[0], dtype=torch.float32, device=device),
        delta=torch.tensor(resolution, dtype=torch.float32, device=device))


def world_potential_lookup_nearest(wp: WorldPotential, points):
    """Nearest-cell potential lookup (``floor`` cell; out of grid -> 0).
    The field may be a strided view (the fused field's potential
    channel): it is gathered in place, not flattened.  The grid's dims
    bound the indices as Python ints, so a captured graph reads no
    constant tensor."""
    idx = torch.floor((points - wp.origin) / wp.delta).to(torch.int32)
    cols = idx.unbind(-1)
    cells = [torch.clamp(c, 0, n - 1) for c, n in zip(cols, wp.data.shape)]
    inb = ((cells[0] == cols[0]) & (cells[1] == cols[1])
           & (cells[2] == cols[2]))
    v = wp.data[tuple(c.long() for c in cells)]
    return torch.where(inb, v, torch.zeros_like(v))


def _world_trilinear(data, origin, delta, points):
    """Trilinear read of a world grid ``data [X, Y, Z, C]`` (cell-centre
    convention) at ``points [P, 3]``: (out [P, C], in-grid [P]).  The
    8-cell stencil must fit (``x0 + 1 < dims``) and clamps to ``dims -
    2``; ``data`` may be a strided view, it is gathered in place."""
    dims = data.shape[:3]
    pg = (points - origin) / delta - 0.5
    c0 = torch.floor(pg).to(torch.int32)
    f = pg - c0
    x0, y0, z0 = c0[..., 0], c0[..., 1], c0[..., 2]
    inb = ((x0 >= 0) & (x0 + 1 < dims[0]) & (y0 >= 0) & (y0 + 1 < dims[1])
           & (z0 >= 0) & (z0 + 1 < dims[2]))
    x0c = torch.clamp(x0, 0, dims[0] - 2).long()
    y0c = torch.clamp(y0, 0, dims[1] - 2).long()
    z0c = torch.clamp(z0, 0, dims[2] - 2).long()

    def val(dx, dy, dz):
        return data[x0c + dx, y0c + dy, z0c + dz]

    fx, fy, fz = f[..., 0:1], f[..., 1:2], f[..., 2:3]
    dx00 = val(0, 0, 0) * (1 - fx) + val(1, 0, 0) * fx
    dx01 = val(0, 0, 1) * (1 - fx) + val(1, 0, 1) * fx
    dx10 = val(0, 1, 0) * (1 - fx) + val(1, 1, 0) * fx
    dx11 = val(0, 1, 1) * (1 - fx) + val(1, 1, 1) * fx
    dxy0 = dx00 * (1 - fy) + dx10 * fy
    dxy1 = dx01 * (1 - fy) + dx11 * fy
    return dxy0 * (1 - fz) + dxy1 * fz, inb


def world_potential_lookup(wp: WorldPotential, points):
    """Trilinear potential lookup, out-of-grid => 0. points [P,3] -> [P]."""
    out, inb = _world_trilinear(wp.data[..., None], wp.origin, wp.delta,
                                points)
    return torch.where(inb, out[..., 0], torch.zeros_like(out[..., 0]))


class WorldField(NamedTuple):
    """Scene-fused 5-channel CHOMP field on a world-frame grid
    (``cfg.sdf_fused``): ``data5[x, y, z] = [pot, gx, gy, gz, mindist]``,
    the hinge potential and its world-frame gradient summed over enabled
    objects, and ``min_o (value_o - clearance_o)`` (``mindist < 0`` is the
    per-point collide flag for non-overlapping objects).  One trilinear
    read per point replaces the per-object query; the bake resolution and
    single counting of points inside several objects are its deviations
    from the exact query."""

    data5: torch.Tensor   # [X, Y, Z, 5]
    origin: torch.Tensor  # [3]
    delta: torch.Tensor   # scalar


def _fuse_objects(value, pot, g_world, keep, clearances):
    """[P, 5] field cells from per-object values, hinge potentials and
    world gradients [O, P(, 3)]; the min-distance channel is capped at 1e3
    so a scene with every object disabled stays finite."""
    zero = torch.zeros((), dtype=pot.dtype, device=pot.device)
    pot_sum = torch.where(keep, pot, zero).sum(0)
    grad_sum = torch.where(keep[..., None], g_world, zero).sum(0)
    mind = torch.where(keep, value - clearances[:, None],
                       torch.full_like(value, torch.inf)).amin(0)
    mind = torch.clamp(mind, max=1e3)
    return torch.cat([pot_sum[:, None], grad_sum, mind[:, None]], dim=-1)


def _bake_field(bounds, resolution, chunk, device, body) -> WorldField:
    """Run ``body`` over the world grid's cell centres, at most ``chunk``
    cells at a time, into one ``[X, Y, Z, 5]`` field."""
    dims, cells = _world_cells(bounds, resolution, device)
    out = torch.empty((cells.shape[0], 5), dtype=torch.float32,
                      device=device)
    for s in range(0, cells.shape[0], chunk):
        out[s:s + chunk] = body(cells[s:s + chunk])
    return WorldField(
        data5=out.reshape(*dims, 5),
        origin=torch.as_tensor(bounds[0], dtype=torch.float32,
                               device=device),
        delta=torch.tensor(resolution, dtype=torch.float32, device=device))


def bake_world_field(scene: BakedSceneSDF, inv_poses, epsilons,
                     padding_scales, clearances, disables,
                     resolution: float = 0.01, bounds=WORLD_BOUNDS,
                     chunk: int = 131072) -> WorldField:
    """The fused field of a data-backed scene: a nearest-cell (``floor``)
    read of the baked 4-channel stack per (cell, object), out of volume
    (1.0, 0), then the hinge and the object reduction."""
    vcells = int(np.prod(scene.data4.shape[1:4]))
    flat4 = scene.data4.reshape(-1, 4)
    r = inv_poses[:, :3, :3]
    keep = (disables <= 0)[:, None]

    def body(c):
        _, pts_obj = _to_object_frame(inv_poses, c)
        lin, inb = _nearest_cells(scene.limits, vcells, pts_obj)
        v4 = flat4[lin]                                     # [O, P, 4]
        value = torch.where(inb, v4[..., 0], torch.ones_like(v4[..., 0]))
        g_obj = torch.where(inb[..., None], v4[..., 1:],
                            torch.zeros_like(v4[..., 1:]))
        pot, gscale = _hinge(value, epsilons, padding_scales)
        g_world = torch.einsum("oba,opb->opa", r, g_obj * gscale[..., None])
        return _fuse_objects(value, pot, g_world, keep, clearances)

    return _bake_field(bounds, resolution, chunk, inv_poses.device, body)


def bake_world_field_analytic(kinds, halfs, penals, limits, inv_poses,
                              epsilons, padding_scales, clearances, disables,
                              dims_actual, resolution: float = 0.01,
                              bounds=WORLD_BOUNDS, chunk: int = 262144,
                              snap: bool = True) -> WorldField:
    """The fused field of a primitive scene, with no voxel stack.

    ``snap=True`` (parity mode) reproduces :func:`bake_world_field` on the
    stack the primitives would voxelise to: the value at the point's
    nearest object cell is the primitive SDF at that cell's centre (+1.0
    outside the object's own dims), the gradient the one-cell central
    differences of those values.  ``snap=False`` (the production fused
    backend) evaluates the true SDF at the world cell centre and its
    world-frame central difference at ``h = resolution / 2``."""
    r = inv_poses[:, :3, :3]
    mn = limits[:, 0:3]
    mx = limits[:, 3:6]
    dpad = limits[:, 6:9]
    delta = limits[:, 9]
    da = dims_actual
    keep = (disables <= 0)[:, None]

    def sdf(p):
        return _analytic_sdf_points(kinds, halfs, penals, p)

    def pval(idx):
        """Stack value at integer cell ``idx [O, P, 3]`` (float): the SDF at
        the cell centre inside the actual dims, else 1.0.  The centre is
        rounded once from float64, as :func:`_synth_stack` rounds the
        stack's, so both read the same values."""
        ok = torch.all((idx >= 0) & (idx < da[:, None, :].to(idx.dtype)),
                       dim=-1)
        center = (mn[:, None, :].double() + (idx + 0.5).double()
                  * delta[:, None, None].double()).float()
        return torch.where(ok, sdf(center), torch.ones_like(idx[..., 0]))

    def body(c):
        _, pts_obj = _to_object_frame(inv_poses, c)
        if snap:
            pg = ((pts_obj - mn[:, None, :]) / (mx - mn)[:, None, :]
                  * dpad[:, None, :])
            idx = torch.floor(pg)
            inb = torch.all((idx >= 0) & (idx < dpad[:, None, :]), dim=-1)
            value = torch.where(inb, pval(idx), torch.ones_like(pg[..., 0]))
            eye = torch.eye(3, dtype=idx.dtype, device=idx.device)
            g_obj = torch.stack(
                [0.5 * (pval(idx + eye[a]) - pval(idx - eye[a]))
                 / delta[:, None] for a in range(3)], dim=-1)
            g_obj = torch.where(inb[..., None], g_obj,
                                torch.zeros_like(g_obj))
        else:
            value = sdf(pts_obj)
            h = 0.5 * resolution
            # a world offset h * e_a is the object-frame offset h * R[:, a]
            g_sdf = torch.stack(
                [(sdf(pts_obj + h * r[:, None, :, a])
                  - sdf(pts_obj - h * r[:, None, :, a])) / (2.0 * h)
                 for a in range(3)], dim=-1)              # world frame
        pot, gscale = _hinge(value, epsilons, padding_scales)
        if snap:
            g_world = torch.einsum("oba,opb->opa", r,
                                   g_obj * gscale[..., None])
        else:
            g_world = g_sdf * gscale[..., None]
        return _fuse_objects(value, pot, g_world, keep, clearances)

    return _bake_field(bounds, resolution, chunk, inv_poses.device, body)


def world_field_query(wf: WorldField, points):
    """Trilinear 5-channel read: (pot [P], grad [P, 3], collide [P]).
    Out of the grid is free space (0, 0, no collision)."""
    out, inb = _world_trilinear(wf.data5, wf.origin, wf.delta, points)
    zero = torch.zeros((), dtype=out.dtype, device=out.device)
    pot = torch.where(inb, out[..., 0], zero)
    grad = torch.where(inb[..., None], out[..., 1:4], zero)
    collide = torch.where(inb, (out[..., 4] < 0.0).to(out.dtype), zero)
    return pot, grad, collide
