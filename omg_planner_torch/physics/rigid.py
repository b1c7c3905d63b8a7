"""Single-dynamic-body rigid physics: SDF contacts and projected impulses
(counterpart of ``omg_planner_tpu/physics/rigid.py``).

The grasp target is the one dynamic body (6-DOF); the scene's other
objects, the table and the position-controlled robot are kinematic.  Each
substep generates contacts from SDF queries (robot collision spheres and
finger-pad samples against the body's SDF, the body's surface samples
against every static collider), compacts each pool to its deepest ``k``
contacts, and solves them with a warm-started projected-Jacobi impulse
loop, two patch-level friction brakes and a split-impulse pseudo pass.
See the JAX module for why each piece is there.

Two forms of the rollout:

* :func:`rollout_plain` — plain PyTorch, a Python loop over substeps with a
  leading batch dimension of rollouts.  Each helper (``_robot_contacts``,
  ``_solve_contacts``, ...) is the JAX function of the same name with that
  batch dimension added.
* :func:`rollout` — the entry point.  CPU tensors take the plain version;
  CUDA tensors launch the hand-written kernel ``csrc/rigid_rollout.cu``
  (one thread block per rollout, the whole substep loop inside one launch:
  8 warps score and rank the candidates, one warp runs the solve with warp
  shuffles only; :func:`omg_planner_torch.ops.kernels.rigid_rollout`, at
  most 256 contact lanes) or raise.  The kernel reassociates a few of
  this module's sums and quotients (its header lists them), so the two
  agree to float32 rounding, not bit for bit.

Every tensor of a call lives on one device; builders take ``device`` and
resolve it as the entry points do (``cuda`` unless the caller names
another).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.sdf import _analytic_sdf_grad, _grid_coords, _trilinear
from ..utils.linalg import top_k
from ..utils.pose import quat_to_mat

#: trace keys of a rollout, in the kernel's packed order, with their widths
TRACE_FIELDS = (("x", 3), ("v", 3), ("q", 4), ("w", 3), ("jv", 2),
                ("robot_impulse", 1), ("robot_contacts", 1),
                ("world_contacts", 1), ("pad_pen_max", 1))


class NoMassModelError(ValueError):
    """The target has no buildable mass model (no interior voxels, no
    surface points): execution is impossible and the planner's verdict
    stands alone.  Drivers catch exactly this."""


class PhysParams(NamedTuple):
    """Solver constants (0-dim float32 tensors; ``gravity`` is [3])."""

    dt: torch.Tensor             # substep, s
    mu: torch.Tensor             # Coulomb friction coefficient
    beta: torch.Tensor           # position-projection factor (pseudo pass)
    slop: torch.Tensor           # penetration allowance, m
    v_depen_max: torch.Tensor    # position-projection velocity cap, m/s
    damp_lin: torch.Tensor       # linear velocity damping, 1/s
    damp_ang: torch.Tensor       # angular velocity damping, 1/s
    sphere_radius: torch.Tensor  # robot collision-point contact radius, m
    pinch_force: torch.Tensor    # finger motor stall force, N
    stall_pen: torch.Tensor      # pad penetration that stalls the motor
    finger_rate: torch.Tensor    # finger joint speed toward command, m/s
    gravity: torch.Tensor        # [3]


def default_params(dt: float = 1.0 / 240.0, device=None) -> PhysParams:
    dev = resolve_device(device)

    def f(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    return PhysParams(
        dt=f(dt), mu=f(0.8), beta=f(0.2), slop=f(5e-4), v_depen_max=f(0.05),
        damp_lin=f(0.3), damp_ang=f(0.6), sphere_radius=f(0.006),
        pinch_force=f(20.0), stall_pen=f(3.5e-3), finger_rate=f(0.12),
        gravity=f([0.0, 0.0, -9.81]))


class RigidBodySpec(NamedTuple):
    """The dynamic target body in its COM-centred frame: an analytic
    primitive (``grid4`` empty) or a baked 4-channel grid SDF."""

    kind: torch.Tensor         # [] int32 (0 box, 1 sphere, 2 cylinder)
    half: torch.Tensor         # [3]
    round: torch.Tensor        # [] edge rounding
    inv_mass: torch.Tensor     # []
    inv_inertia: torch.Tensor  # [3, 3] body frame
    surf: torch.Tensor         # [S, 3] body-frame surface samples
    com: torch.Tensor          # [3] COM in the object's original frame
    grid4: torch.Tensor        # [X*Y*Z, 4] baked SDF, or [0, 4] (analytic)
    grid_limits: torch.Tensor  # [10] mn/mx/dims/delta (COM-centred)


class StaticWorld(NamedTuple):
    """Kinematic colliders (target excluded): analytic primitives plus
    optional baked-grid colliders (``grid4`` None when there are none)."""

    kinds: torch.Tensor      # [O] int32
    halfs: torch.Tensor      # [O, 3]
    rounds: torch.Tensor     # [O]
    inv_poses: torch.Tensor  # [O, 4, 4] world -> object
    mask: torch.Tensor       # [O] 1 = active collider
    grid4: torch.Tensor | None = None           # [Og, N, 4]
    grid_limits: torch.Tensor | None = None     # [Og, 10]
    grid_inv_poses: torch.Tensor | None = None  # [Og, 4, 4]


class BodyState(NamedTuple):
    x: torch.Tensor  # [..., 3] position of the COM
    q: torch.Tensor  # [..., 4] wxyz orientation
    v: torch.Tensor  # [..., 3] linear velocity
    w: torch.Tensor  # [..., 3] angular velocity (world frame)


class Contacts(NamedTuple):
    """Fixed-size compacted contact set, [B, C, ...] (masked)."""

    p: torch.Tensor        # world contact point
    n: torch.Tensor        # impulse direction on the body (unit)
    pen: torch.Tensor      # penetration depth (>= 0 where active)
    v_other: torch.Tensor  # kinematic collider velocity at the contact
    active: torch.Tensor   # float mask
    finger: torch.Tensor   # pad index + 1 for finger-pad contacts, else 0
    src: torch.Tensor      # index in the candidate pool (warm-start key)


# -- host builders (numpy, as in the JAX package) ---------------------------

def _primitive_mass_inertia(kind: int, half, density: float):
    """Closed-form solid mass and body-frame inertia of a primitive."""
    a, b, c = [float(h) for h in half]
    if kind == 0:     # box, half extents a, b, c
        m = 8.0 * a * b * c * density
        ix = m / 3.0 * (b * b + c * c)
        iy = m / 3.0 * (a * a + c * c)
        iz = m / 3.0 * (a * a + b * b)
    elif kind == 1:   # sphere radius a
        m = 4.0 / 3.0 * np.pi * a ** 3 * density
        ix = iy = iz = 0.4 * m * a * a
    else:             # cylinder radius a, half-height c (axis z)
        h = 2.0 * c
        m = np.pi * a * a * h * density
        ix = iy = m * (3.0 * a * a + h * h) / 12.0
        iz = 0.5 * m * a * a
    return m, np.diag([ix, iy, iz])


def _fibonacci_sphere(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1.0 - 2.0 * i / n)
    theta = np.pi * (1.0 + 5 ** 0.5) * i
    return np.stack([np.cos(theta) * np.sin(phi),
                     np.sin(theta) * np.sin(phi), np.cos(phi)], -1)


def box_face_grid(half, m: int) -> np.ndarray:
    """``m x m`` sample grid on each face of the box [-half, half] (6 m^2
    points): the body's surface sampler and the finger-pad geometry."""
    half = np.asarray(half, np.float64).ravel()[:3]
    pts = []
    for ax in range(3):
        u, v = [i for i in range(3) if i != ax]
        gu, gv = np.meshgrid(np.linspace(-half[u], half[u], m),
                             np.linspace(-half[v], half[v], m),
                             indexing="ij")
        for s in (-1.0, 1.0):
            p = np.zeros((m, m, 3))
            p[..., ax] = s * half[ax]
            p[..., u] = gu
            p[..., v] = gv
            pts.append(p.reshape(-1, 3))
    return np.concatenate(pts)


def primitive_surface_samples(kind: int, half, n: int = 96) -> np.ndarray:
    """Canonical body-frame surface samples of an analytic primitive, with
    its support features (bottom face, rims) present by construction."""
    half = np.asarray(half, np.float64).ravel()[:3]
    if kind == 1:                                 # sphere
        pts = _fibonacci_sphere(n) * half[0]
    elif kind == 2:                               # cylinder r, r, hh
        r, hh = half[0], half[2]
        pts = []
        n_rim = 14
        ang = np.linspace(0.0, 2 * np.pi, n_rim, endpoint=False)
        ring = np.stack([np.cos(ang), np.sin(ang), np.zeros(n_rim)], -1)
        for s in (-1.0, 1.0):                     # caps: rim + r/2 + centre
            for rr in (r, 0.5 * r):
                p = ring.copy() * rr
                p[:, 2] = s * hh
                pts.append(p)
            pts.append(np.array([[0.0, 0.0, s * hh]]))
        for z in np.linspace(-hh, hh, 3 + 2)[1:-1]:   # side rings
            p = ring.copy() * r
            p[:, 2] = z
            pts.append(p)
        pts = np.concatenate(pts)
    else:                                         # box: 6 face grids
        m = max(int(np.ceil(np.sqrt(n / 6.0))), 2)
        pts = box_face_grid(half, m)
    if len(pts) < n:      # pad/trim to exactly n (one shape across scenes)
        pts = np.concatenate([pts, pts[np.arange(n - len(pts)) % len(pts)]])
    return pts[:n].astype(np.float32)


def _spec(device, kind, half, round_r, m, inertia, pts, com, grid4, limits):
    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return RigidBodySpec(
        kind=torch.tensor(int(kind), dtype=torch.int32, device=device),
        half=f32(half), round=f32(round_r), inv_mass=f32(1.0 / m),
        inv_inertia=f32(np.linalg.inv(inertia)), surf=f32(pts), com=f32(com),
        grid4=f32(grid4), grid_limits=f32(limits))


def body_spec_from_primitive(kind: int, half, surf_pts: np.ndarray = None,
                             density: float = 300.0, n_surf: int = 96,
                             round_r: float = 0.004,
                             device=None) -> RigidBodySpec:
    """The body spec of a scene primitive: ``half`` is the analytic SDF's
    half-extent triple, so the body is exactly the planner's collision
    geometry.  ``surf_pts`` is accepted for the JAX signature and ignored
    (the primitive's own surface samples are used)."""
    dev = resolve_device(device)
    half = np.asarray(half, np.float32).ravel()[:3]
    m, inertia = _primitive_mass_inertia(kind, half, density)
    pts = primitive_surface_samples(kind, half, n_surf)
    return _spec(dev, kind, half, round_r, m, inertia, pts, np.zeros(3),
                 np.zeros((0, 4)), np.zeros(10))


def bake_grid_sdf(field, inside_penalty: float = 5.0):
    """Bake a data-backed SDF into the flat 4-channel layout (value +
    central-difference gradient); ``inside_penalty`` undoes the inside
    scaling so depths are metric.  Returns numpy ``(data [X, Y, Z],
    grid4 [X*Y*Z, 4], limits [10])`` in the field's own frame."""
    data = np.asarray(field.data, np.float32)
    data = np.where(data < 0, data / float(inside_penalty), data)
    delta = float(field.delta)
    origin = np.asarray(field.origin, np.float64)
    g = np.zeros(data.shape + (3,), np.float32)
    g[1:-1, :, :, 0] = (data[2:] - data[:-2]) / (2 * delta)
    g[:, 1:-1, :, 1] = (data[:, 2:] - data[:, :-2]) / (2 * delta)
    g[:, :, 1:-1, 2] = (data[:, :, 2:] - data[:, :, :-2]) / (2 * delta)
    grid4 = np.concatenate([data[..., None], g], -1).reshape(-1, 4)
    mn = origin
    mx = mn + delta * np.asarray(data.shape)
    limits = np.concatenate(
        [mn, mx, np.asarray(data.shape, np.float64), [delta]])
    return data, grid4, limits


def body_spec_from_grid(field, surf_pts: np.ndarray, density: float = 300.0,
                        inside_penalty: float = 5.0, n_surf: int = 96,
                        device=None) -> RigidBodySpec:
    """The body spec of a data-backed SDF: mass, COM and inertia by voxel
    integration of the inside region, frame re-centred at the COM (its
    original-frame offset in ``com``), contacts through the baked grid."""
    dev = resolve_device(device)
    data, grid4, limits = bake_grid_sdf(field, inside_penalty)
    delta = float(field.delta)
    origin = np.asarray(field.origin, np.float64)
    inside = data < 0.0
    n_in = int(inside.sum())
    if n_in == 0:
        raise NoMassModelError(
            "grid SDF has no interior voxels: no mass model")
    idx = np.argwhere(inside)
    pos = origin[None] + (idx + 0.5) * delta     # voxel centres
    dv = delta ** 3
    m = density * dv * n_in
    com = pos.mean(0)
    rp = pos - com[None]
    r2 = np.einsum("na,na->n", rp, rp)
    inertia = density * dv * (
        r2.sum() * np.eye(3) - np.einsum("na,nb->ab", rp, rp))
    # thin shells can have near-singular inertia along one axis
    inertia += np.eye(3) * max(1e-8, 1e-4 * np.trace(inertia))

    limits = limits.copy()
    limits[0:3] -= com            # COM-centred body frame
    limits[3:6] -= com
    mn, mx = limits[0:3], limits[3:6]

    pts = np.asarray(surf_pts, np.float32)[:, :3] - com[None].astype(
        np.float32)
    # evenly spaced over the whole cloud (a stride + truncate would drop a
    # trailing chunk, and with it whole faces of world-contact candidates)
    idx = np.linspace(0, len(pts) - 1, min(n_surf, len(pts))).astype(int)
    pts = pts[idx]
    if len(pts) < n_surf:
        pts = np.concatenate(
            [pts, pts[np.arange(n_surf - len(pts)) % len(pts)]])
    half = ((mx - mn) / 2.0).astype(np.float32)
    return _spec(dev, 0, half, 0.0, m, inertia, pts, com, grid4, limits)


# -- the plain substep, [B, ...] --------------------------------------------

def _grid_phi_grad(grid4, limits, pts):
    """4-channel trilinear read of flat baked grids ``grid4 [G, N, 4]``
    (``limits [G, 10]``) at their own-frame points ``pts [G, P, 3]``:
    ``(value [G, P], grad [G, P, 3])``, out of volume ``(1.0, 0)`` — the
    JAX package's ``ops/sdf.py::_query_one_object_baked`` for each grid."""
    pg, dims = _grid_coords(limits, pts)
    out, inb = _trilinear(grid4, dims, pg)
    value = torch.where(inb, out[..., 0], torch.ones_like(out[..., 0]))
    grad = torch.where(inb[..., None], out[..., 1:],
                       torch.zeros_like(out[..., 1:]))
    return value, grad


def _body_phi_grad(spec: RigidBodySpec, rel: torch.Tensor):
    """Body SDF value and gradient at body-frame points ``rel [..., 3]``:
    the analytic closed form, or the baked grid when ``grid4`` is set."""
    flat = rel.reshape(-1, 3)
    if spec.grid4.shape[0]:
        phi, g = _grid_phi_grad(spec.grid4[None], spec.grid_limits[None],
                                flat[None])
    else:
        phi, g = _analytic_sdf_grad(
            spec.kind[None], spec.half[None],
            torch.ones(1, dtype=flat.dtype, device=flat.device), flat[None],
            rounds=spec.round[None])
    return phi[0].reshape(rel.shape[:-1]), g[0].reshape(rel.shape)


def _quat_integrate(q, w, dt):
    """``q [B, 4]`` advanced by the angular velocity ``w [B, 3]``."""
    w1 = torch.zeros_like(q[..., 0])
    x1, y1, z1 = w.unbind(-1)
    w2, x2, y2, z2 = q.unbind(-1)
    dq = torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], -1)
    qn = q + 0.5 * dt * dq
    return qn / torch.clamp(torch.linalg.norm(qn, dim=-1, keepdim=True),
                            min=1e-9)


def _topk_contacts(p, n, pen, v_other, active, finger, k):
    """Compact each rollout's candidates ``[B, M, ...]`` to its ``k``
    deepest active contacts (``jax.lax.top_k`` order: ties to the lower
    index)."""
    score = torch.where(active > 0.5, pen, torch.full_like(pen, -torch.inf))
    top, idx = top_k(score, min(k, score.shape[-1]))

    def take(a):
        if a.ndim == 3:
            return torch.gather(a, 1, idx[..., None].expand(-1, -1, 3))
        return torch.gather(a, 1, idx)

    act = (top > -torch.inf).to(pen.dtype)
    return Contacts(p=take(p), n=take(n), pen=torch.clamp(take(pen), min=0.0),
                    v_other=take(v_other), active=act,
                    finger=take(finger) * act, src=idx)


def _unit(a):
    return a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True),
                           min=1e-9)


def _robot_contacts(spec: RigidBodySpec, state: BodyState, sph, sph_v,
                    is_finger, radius, k: int) -> Contacts:
    """Robot collision spheres ``sph [B, K, 3]`` against the body's SDF;
    the impulse on the body points into it.  Finger-link spheres are
    excluded: the pads contact through their sampled surfaces."""
    r = quat_to_mat(state.q)
    rel = (sph - state.x[:, None]) @ r            # body frame [B, K, 3]
    phi, g = _body_phi_grad(spec, rel)
    n_out = _unit(g @ r.transpose(-1, -2))
    pen = radius - phi
    cp = sph - n_out * phi[..., None]
    act = (pen > 0.0).to(pen.dtype) * (1.0 - is_finger)
    return _topk_contacts(cp, -n_out, pen, sph_v, act, torch.zeros_like(pen),
                          k)


def _pad_pose(base, axis, dv):
    """Pad poses ``base [B, 2, 4, 4]`` translated along each finger's
    link-frame ``axis [B, 2, 3]`` by the joint offset ``dv [B, 2]``."""
    shift = (base[..., :3, :3] @ (axis * dv[..., None])[..., None])[..., 0]
    out = base.clone()
    out[..., :3, 3] = base[..., :3, 3] + shift
    return out


def _pad_points(pose, pad_samples):
    """World positions [B, 2, Sp, 3] of the pad samples ``[2, Sp, 3]``."""
    return (pose[:, :, None, :3, :3] @ pad_samples[None, :, :, :, None]
            )[..., 0] + pose[:, :, None, :3, 3]


def _pad_probe_pen(spec: RigidBodySpec, state: BodyState, pad_pose,
                   pad_samples):
    """Largest pad-sample penetration of each pad, [B, 2]: the finger
    motor's stall signal."""
    r = quat_to_mat(state.q)
    sp_w = _pad_points(pad_pose, pad_samples)
    rel = (sp_w - state.x[:, None, None]) @ r[:, None]
    phi, _ = _body_phi_grad(spec, rel)
    return (1e-3 - phi).amax(-1)


def _pad_contacts(spec: RigidBodySpec, state: BodyState, pad_pose, pad_next,
                  pad_samples, dt, k: int) -> Contacts:
    """Finger pads as densely sampled surfaces against the body's SDF, with
    exact material-point velocities from this substep's pad motion."""
    r = quat_to_mat(state.q)
    b = pad_pose.shape[0]
    sp_w = _pad_points(pad_pose, pad_samples).reshape(b, -1, 3)
    nxt = _pad_points(pad_next, pad_samples).reshape(b, -1, 3)
    v_pad = (nxt - sp_w) / dt
    rel = (sp_w - state.x[:, None]) @ r
    phi, g = _body_phi_grad(spec, rel)
    n_out = _unit(g @ r.transpose(-1, -2))
    pen = 1e-3 - phi           # contact once a pad sample grazes 1 mm
    cp = sp_w - n_out * phi[..., None]
    # each pad is its own motor: finger value = pad index + 1
    pad_id = 1.0 + (torch.arange(pen.shape[-1], device=pen.device)
                    >= pad_samples.shape[1]).to(pen.dtype)
    return _topk_contacts(cp, -n_out, pen, v_pad, (pen > 0.0).to(pen.dtype),
                          pad_id.expand_as(pen), k)


def _world_contacts(spec: RigidBodySpec, world: StaticWorld,
                    state: BodyState, k: int) -> Contacts:
    """Body surface samples against every static collider: the minimum
    over objects (first on ties), normal the object's outward gradient."""
    r = quat_to_mat(state.q)
    b = state.x.shape[0]
    pw = state.x[:, None] + spec.surf @ r.transpose(-1, -2)     # [B, S, 3]
    ro = world.inv_poses[:, :3, :3]
    to = world.inv_poses[:, :3, 3]
    po = (ro[:, None, None] @ pw[None, ..., None])[..., 0] \
        + to[:, None, None, :]                                    # [O, B, S, 3]
    phi, g = _analytic_sdf_grad(
        world.kinds, world.halfs, torch.ones_like(world.rounds), po,
        rounds=world.rounds)
    phi = torch.where(world.mask[:, None, None] > 0.5, phi,
                      torch.full_like(phi, torch.inf))
    o_idx = torch.argmin(phi, dim=0)                              # [B, S]
    phi_min = torch.gather(phi, 0, o_idx[None])[0]
    g_obj = torch.gather(g, 0, o_idx[None, ..., None].expand(1, -1, -1, 3))[0]
    n_w = (ro[o_idx].transpose(-1, -2) @ g_obj[..., None])[..., 0]
    if world.grid4 is not None and world.grid4.shape[0]:
        rg = world.grid_inv_poses[:, :3, :3]
        tg = world.grid_inv_poses[:, :3, 3]
        ng = rg.shape[0]
        pg = (rg[:, None, None] @ pw[None, ..., None])[..., 0] \
            + tg[:, None, None, :]
        phi_g, g_g = _grid_phi_grad(world.grid4, world.grid_limits,
                                    pg.reshape(ng, -1, 3))
        phi_g = phi_g.reshape(ng, b, -1)
        g_g = g_g.reshape(ng, b, -1, 3)
        gi = torch.argmin(phi_g, dim=0)
        phi_gm = torch.gather(phi_g, 0, gi[None])[0]
        g_gm = torch.gather(g_g, 0, gi[None, ..., None].expand(1, -1, -1, 3))[0]
        n_g = (rg[gi].transpose(-1, -2) @ g_gm[..., None])[..., 0]
        closer = phi_gm < phi_min
        phi_min = torch.where(closer, phi_gm, phi_min)
        n_w = torch.where(closer[..., None], n_g, n_w)
    n_w = _unit(n_w)
    pen = -phi_min
    return _topk_contacts(pw, n_w, pen, torch.zeros_like(pw),
                          (pen > 0.0).to(pen.dtype), torch.zeros_like(pen), k)


def _crossmat(a):
    """[..., 3] -> [..., 3, 3] with ``crossmat(a) @ b == cross(a, b)``."""
    x, y, z = a.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _mv(m, v):
    """Batched matrix-vector product [B, 3, 3] x [B, 3]."""
    return (m @ v[..., None])[..., 0]


def _solve_contacts(spec: RigidBodySpec, state: BodyState, c: Contacts,
                    pp: PhysParams, iters: int, warm=None):
    """Relaxed projected-Jacobi impulse solve of each rollout's contacts.

    ``warm`` (optional) = (ln0, l10, l20) from the previous substep's
    solve, applied to (v, w) up front.  The finger pads are motors pinned
    at their (engagement-ramped, opposition-gated) stall share; two patch
    brakes solve the pinch's bulk linear and angular stick modes exactly.
    Returns (v, w, (ln, l1, l2), pv, pw)."""
    dev, dt_ = c.p.device, c.p.dtype
    eye = torch.eye(3, dtype=dt_, device=dev)
    r_mat = quat_to_mat(state.q)
    i_inv = r_mat @ spec.inv_inertia @ r_mat.transpose(-1, -2)    # [B, 3, 3]
    rarm = c.p - state.x[:, None]                                 # [B, C, 3]
    act = c.active
    inv_m = spec.inv_mass

    # orthonormal tangent basis per contact
    ref = torch.where(torch.abs(c.n[..., 2:3]) < 0.9,
                      torch.tensor([0.0, 0.0, 1.0], dtype=dt_, device=dev),
                      torch.tensor([1.0, 0.0, 0.0], dtype=dt_, device=dev))
    t1 = _unit(torch.linalg.cross(c.n, ref, dim=-1))
    t2 = torch.linalg.cross(c.n, t1, dim=-1)

    def eff_k(d):
        rxd = torch.linalg.cross(rarm, d, dim=-1)
        return inv_m + (torch.linalg.cross(rxd @ i_inv.transpose(-1, -2),
                                           rarm, dim=-1) * d).sum(-1)

    # direction-aware mass splitting (alignment-weighted contact count)
    align = torch.square(c.n @ c.n.transpose(-1, -2)) * act[:, None, :]
    split = torch.clamp(align.sum(-1), min=1.0)
    k_n = torch.clamp(eff_k(c.n), min=1e-6) * split
    k_1 = torch.clamp(eff_k(t1), min=1e-6) * split
    k_2 = torch.clamp(eff_k(t2), min=1e-6) * split
    omega = 0.9

    # finger motors: each pad's total normal impulse pinned at its stall
    # share, ramped by engagement and gated by the opposite pad
    engage = torch.clamp(c.pen / pp.stall_pen, 0.0, 1.0)
    is_f = c.finger > 0.5
    pad_w = [(torch.abs(c.finger - pv) < 0.25).to(dt_) * act * engage
             for pv in (1.0, 2.0)]
    eng = [torch.clamp(w.sum(-1), max=1.0) for w in pad_w]        # [B]
    pad_tot = [pp.pinch_force * pp.dt * e * eng[1 - i]
               for i, e in enumerate(eng)]

    def pin_pad_totals(ln):
        out = ln
        for w, tot in zip(pad_w, pad_tot):
            m = w > 0.0
            d = torch.where(m, ln + 1e-3 * tot[:, None] * w,
                            torch.zeros_like(ln))
            out = torch.where(m, tot[:, None] * d / torch.clamp(
                d.sum(-1, keepdim=True), min=1e-12), out)
        return out

    # patch-level angular friction: brake the body's spin relative to the
    # hand's rigid motion (least-squares twist of the pad velocities)
    w_pat = pad_w[0] + pad_w[1]
    W_pat = w_pat.sum(-1)
    inv_w = 1.0 / torch.clamp(W_pat, min=1e-9)
    pbar = (w_pat[..., None] * c.p).sum(1) * inv_w[:, None]
    vbar = (w_pat[..., None] * c.v_other).sum(1) * inv_w[:, None]
    r_pat = c.p - pbar[:, None]
    r2 = (r_pat * r_pat).sum(-1)
    A = (w_pat[..., None, None]
         * (r2[..., None, None] * eye
            - r_pat[..., :, None] * r_pat[..., None, :])).sum(1)
    bvec = (w_pat[..., None] * torch.linalg.cross(
        r_pat, c.v_other - vbar[:, None], dim=-1)).sum(1)
    w_hand = torch.linalg.solve(A + 1e-8 * eye, bvec)
    w_hand = torch.where((W_pat > 1e-6)[:, None], w_hand,
                         torch.zeros_like(w_hand))
    r_patch = torch.sqrt((w_pat * r2).sum(-1) * inv_w)            # [B]
    i_world = torch.linalg.inv(i_inv + 1e-12 * eye)

    # patch-level linear friction: the bulk tangential stick mode at the
    # patch centroid, solved exactly; the pinch axis projected out
    a_pinch = _unit((pad_w[0][..., None] * c.n).sum(1))
    rbar = (w_pat[..., None] * rarm).sum(1) * inv_w[:, None]
    S = _crossmat(rbar)
    K_pat = inv_m * eye - S @ i_inv @ S
    K_inv = torch.linalg.inv(K_pat + 1e-8 * eye)

    # the loop works on u = [v; w] [B, 6]: each lane's velocity along n,
    # t1, t2 is one row of jf ([d; rarm x d]), its impulse enters u as
    # mob @ (jf^T dL), with mob = diag(inv_mass I, i_inv)
    b, n_c = c.pen.shape
    d3 = torch.stack([c.n, t1, t2], -2)                           # [B, C, 3, 3]
    rx = torch.linalg.cross(rarm[..., None, :].expand_as(d3), d3, dim=-1)
    jf = torch.cat([d3, rx], -1).reshape(b, n_c * 3, 6)
    proj_o = (d3 @ c.v_other[..., None])[..., 0]                  # [B, C, 3]
    k3 = torch.stack([k_n, k_1, k_2], -1)
    zero3 = torch.zeros_like(i_inv)
    mob = torch.cat([torch.cat([inv_m * eye.expand_as(i_inv), zero3], -1),
                     torch.cat([zero3, i_inv], -1)], -2)          # [B, 6, 6]

    def apply(u, imp):
        return u + (mob @ imp[..., None])[..., 0]

    def impulse(dl):                 # [B, C, 3] -> [B, 6] impulse, torque
        return (dl.reshape(b, 1, n_c * 3) @ jf)[:, 0]

    def norm(a):
        return torch.linalg.norm(a, dim=-1)

    zero = torch.zeros_like(c.pen)
    u = torch.cat([state.v, state.w], -1)
    ln, l1, l2 = pin_pad_totals(zero), zero, zero
    if warm is not None:
        ln = pin_pad_totals(torch.clamp(warm[0], min=0.0) * act)
        cap0 = pp.mu * ln
        l1 = torch.clamp(warm[1], min=-cap0, max=cap0) * act
        l2 = torch.clamp(warm[2], min=-cap0, max=cap0) * act
    lam = torch.stack([ln, l1, l2], -1)                           # [B, C, 3]
    if warm is not None:
        u = apply(u, impulse(lam))

    # the patch brakes act only through finger contacts: with none they
    # are exact no-ops (zero budgets), so the loop skips them
    brakes = bool(is_f.any())
    if brakes:
        proj = eye - a_pinch[..., :, None] * a_pinch[..., None, :]  # P
        q_mat = proj @ K_inv @ proj
        # v_pat = v + w x rbar - vbar = [I, -crossmat(rbar)] u - vbar
        g_lin = q_mat @ torch.cat([eye.expand_as(S), -S], -1)      # [B, 3, 6]
        g_off = _mv(q_mat, vbar)
        isf = is_f.to(dt_)
        t12 = (torch.stack([t1, t2], -2) * isf[..., None, None]
               ).reshape(b, n_c * 2, 3) @ proj                     # [B, 2C, 3]
        h_lin = torch.cat([inv_m * eye.expand_as(S), i_inv @ S], -2)
        h_ang = torch.cat([zero3, i_inv], -2)                     # [B, 6, 3]
        iw_wh = _mv(i_world, w_hand)
        la = torch.zeros_like(state.v)
        ll = torch.zeros_like(state.v)
    for _ in range(iters):
        rel = (jf @ u[..., None]).reshape(b, n_c, 3) - proj_o
        lt = lam - omega * rel / k3
        ln_new = pin_pad_totals(torch.clamp(lt[..., 0], min=0.0) * act)
        cap = (pp.mu * ln_new)[..., None]
        l12 = torch.minimum(torch.maximum(lt[..., 1:], -cap), cap) \
            * act[..., None]
        lam_new = torch.cat([ln_new[..., None], l12], -1)
        u = apply(u, impulse(lam_new - lam))
        lam = lam_new
        if not brakes:
            continue
        ln_f_tot = (ln_new * isf).sum(-1)
        # patch linear brake: the bulk tangential stick mode at the patch
        # centroid, inside the shared Coulomb budget
        f_pt = (l12.reshape(b, 1, n_c * 2) @ t12)[:, 0]
        cap_lin = torch.clamp(pp.mu * ln_f_tot - norm(f_pt), min=0.0)
        ll_new = ll - omega * ((g_lin @ u[..., None])[..., 0] - g_off)
        ll_new = ll_new * torch.clamp(
            cap_lin / torch.clamp(norm(ll_new), min=1e-12), max=1.0)[:, None]
        u = u + (h_lin @ (ll_new - ll)[..., None])[..., 0]
        # patch angular brake, clamped to the patch's torque budget
        cap_ang = pp.mu * ln_f_tot * r_patch
        la_new = la - omega * (_mv(i_world, u[:, 3:]) - iw_wh)
        la_new = la_new * torch.clamp(
            cap_ang / torch.clamp(norm(la_new), min=1e-12), max=1.0)[:, None]
        u = u + (h_ang @ (la_new - la)[..., None])[..., 0]
        ll, la = ll_new, la_new

    # pseudo pass: split-impulse projection out of penetration (moves the
    # pose, never the momentum); finger contacts excluded
    bias = torch.clamp(pp.beta / pp.dt * torch.clamp(c.pen - pp.slop,
                                                     min=0.0),
                       max=pp.v_depen_max) \
        * (1.0 - torch.clamp(c.finger, 0.0, 1.0))
    jn = jf.reshape(b, n_c, 3, 6)[:, :, 0]                         # [B, C, 6]
    up = torch.zeros_like(u)
    pl = zero
    for _ in range(max(iters // 4, 4)):
        vn = (jn @ up[..., None])[..., 0]
        pl_new = torch.clamp(pl + omega * (bias - vn) / k_n, min=0.0) * act
        up = apply(up, ((pl_new - pl)[:, None, :] @ jn)[:, 0])
        pl = pl_new
    return (u[:, :3], u[:, 3:], tuple(lam.unbind(-1)), up[:, :3],
            up[:, 3:])


def _substep(spec: RigidBodySpec, world: StaticWorld, pp: PhysParams,
             state: BodyState, sph, sph_v, is_finger, pad_base,
             pad_base_next, pad_axis, pad_samples, jv, jv_cmd, jv_ref,
             warm_pools, k_robot: int, k_pad: int, k_world: int, iters: int):
    """One substep of every rollout.  The finger joint is dynamic state: it
    moves toward its command at the motor rate while its pad is unopposed
    and stalls once the pad penetrates to the stall depth."""
    rc = _robot_contacts(spec, state, sph, sph_v, is_finger,
                         pp.sphere_radius, k_robot)
    pad_pose = _pad_pose(pad_base, pad_axis, jv - jv_ref)
    pen2 = _pad_probe_pen(spec, state, pad_pose, pad_samples)
    rate = pp.finger_rate * pp.dt
    step = torch.clamp(jv_cmd - jv, min=-rate, max=rate)
    stalled = (pen2 >= pp.stall_pen) & (step < 0.0)
    jv_next = torch.where(stalled, jv, jv + step)
    pad_next = _pad_pose(pad_base_next, pad_axis, jv_next - jv_ref)
    pc = _pad_contacts(spec, state, pad_pose, pad_next, pad_samples, pp.dt,
                       k_pad)
    wc = _world_contacts(spec, world, state, k_world)
    parts = (rc, pc, wc)
    c = Contacts(*[torch.cat(f, dim=1) for f in zip(*parts)])
    kr, kp = rc.active.shape[1], pc.active.shape[1]
    lanes = (slice(0, kr), slice(kr, kr + kp), slice(kr + kp, None))
    # warm impulses gathered by contact identity (pool index)
    warm = tuple(torch.cat([torch.gather(warm_pools[j][i], 1, parts[j].src)
                            for j in range(3)], dim=1) for i in range(3))
    st = state._replace(v=state.v + pp.gravity * pp.dt)
    v, w, lams, pv, pw = _solve_contacts(spec, st, c, pp, iters, warm)
    new_pools = tuple(
        tuple(torch.zeros_like(warm_pools[j][i]).scatter(
            1, parts[j].src, lams[i][:, lanes[j]] * parts[j].active)
            for i in range(3))
        for j in range(3))
    v = v * torch.exp(-pp.damp_lin * pp.dt)
    w = w * torch.exp(-pp.damp_ang * pp.dt)
    # pseudo velocities advance the pose but are not kept in the state
    x = state.x + (v + pv) * pp.dt
    q = _quat_integrate(state.q, w + pw, pp.dt)
    diag = {"robot_impulse": lams[0][:, :kr + kp].sum(-1),
            "robot_contacts": rc.active.sum(-1) + pc.active.sum(-1),
            "world_contacts": wc.active.sum(-1),
            "pad_pen_max": (pc.pen * pc.active).amax(-1),
            "jv": jv_next, "q": q, "w": w}
    return BodyState(x=x, q=q, v=v, w=w), new_pools, jv_next, diag


def _defaults(state0, sph_track, is_finger, pad_track, pad_samples,
              pad_axis, jv_track, jv_ref):
    """Fill the JAX ``rollout`` defaults and add a batch dimension to
    unbatched inputs.  Returns (batched, unbatched?)."""
    single = sph_track.ndim == 3
    if single:
        state0 = BodyState(*(a[None] for a in state0))
        sph_track = sph_track[None]
        pad_track = None if pad_track is None else pad_track[None]
        pad_axis = None if pad_axis is None else pad_axis[None]
        jv_track = None if jv_track is None else jv_track[None]
        jv_ref = None if jv_ref is None else jv_ref[None]
    b, t1, k = sph_track.shape[:3]
    kw = dict(dtype=torch.float32, device=sph_track.device)
    if is_finger is None:
        is_finger = torch.zeros(k, **kw)
    if pad_track is None:
        far = torch.eye(4, **kw)
        far[:3, 3] = 1e3
        pad_track = far.expand(b, t1, 2, 4, 4)
    if pad_samples is None:   # independent default: a caller may pass a
        pad_samples = torch.zeros(2, 1, 3, **kw)   # pad_track alone
    if pad_axis is None:
        pad_axis = torch.zeros(b, 2, 3, **kw)
    if jv_track is None:
        jv_track = torch.zeros(b, t1, 2, **kw)
    if jv_ref is None:
        jv_ref = torch.zeros(b, 2, **kw)
    return (state0, sph_track, is_finger, pad_track, pad_samples, pad_axis,
            jv_track, jv_ref), single


def _unbatch(final, traces, single):
    if not single:
        return final, traces
    return (BodyState(*(a[0] for a in final)),
            {k: v[0] for k, v in traces.items()})


def rollout_plain(spec: RigidBodySpec, world: StaticWorld, pp: PhysParams,
                  state0: BodyState, sph_track: torch.Tensor,
                  is_finger=None, pad_track=None, pad_samples=None,
                  pad_axis=None, jv_track=None, jv_ref=None,
                  k_robot: int = 48, k_pad: int = 32, k_world: int = 48,
                  iters: int = 48):
    """The plain PyTorch rollout: a Python loop of :func:`_substep` over the
    substep track.  Arguments and returns as :func:`rollout`."""
    (state, sph_track, is_finger, pad_track, pad_samples, pad_axis,
     jv_track, jv_ref), single = _defaults(
        state0, sph_track, is_finger, pad_track, pad_samples, pad_axis,
        jv_track, jv_ref)
    b = sph_track.shape[0]
    sizes = (sph_track.shape[2], 2 * pad_samples.shape[1], spec.surf.shape[0])
    pools = tuple(tuple(torch.zeros(b, m, dtype=torch.float32,
                                    device=sph_track.device)
                        for _ in range(3)) for m in sizes)
    jv = jv_track[:, 0]
    traces = {k: [] for k, _ in TRACE_FIELDS}
    for t in range(sph_track.shape[1] - 1):
        sph = sph_track[:, t]
        sph_v = (sph_track[:, t + 1] - sph) / pp.dt
        state, pools, jv, diag = _substep(
            spec, world, pp, state, sph, sph_v, is_finger, pad_track[:, t],
            pad_track[:, t + 1], pad_axis, pad_samples, jv,
            jv_track[:, t + 1], jv_ref, pools, k_robot, k_pad, k_world,
            iters)
        diag["x"], diag["v"] = state.x, state.v
        for k in traces:
            traces[k].append(diag[k])
    traces = {k: torch.stack(v, dim=1) for k, v in traces.items()}
    return _unbatch(state, traces, single)


def rollout(spec: RigidBodySpec, world: StaticWorld, pp: PhysParams,
            state0: BodyState, sph_track: torch.Tensor,
            is_finger=None, pad_track=None, pad_samples=None,
            pad_axis=None, jv_track=None, jv_ref=None,
            k_robot: int = 48, k_pad: int = 32, k_world: int = 48,
            iters: int = 48):
    """Simulate the whole substep track of one rollout or of a batch.

    ``sph_track [B, T+1, K, 3]``: the robot's collision points at each
    substep boundary (the arm is kinematic, so its motion is known up
    front); ``is_finger [K]`` marks finger-link spheres; ``pad_track
    [B, T+1, 2, 4, 4]``: finger-pad frames built at the joint values
    ``jv_ref [B, 2]``; ``pad_samples [2, Sp, 3]``: pad-frame surface
    samples; ``pad_axis [B, 2, 3]``: each finger's prismatic axis in its
    pad frame; ``jv_track [B, T+1, 2]``: commanded finger joints.  The
    state has a leading B too.  Without the leading B (JAX's shapes) the
    call is one rollout and returns unbatched results.

    Returns (final BodyState, traces) with the traces of
    :data:`TRACE_FIELDS` per substep, [B, T, ...].  CPU tensors run
    :func:`rollout_plain`; CUDA tensors launch the ``rigid_rollout``
    kernel (one launch for the whole batch) or raise."""
    if sph_track.device.type == "cpu":
        return rollout_plain(spec, world, pp, state0, sph_track, is_finger,
                             pad_track, pad_samples, pad_axis, jv_track,
                             jv_ref, k_robot, k_pad, k_world, iters)
    from ..ops import kernels

    args, single = _defaults(state0, sph_track, is_finger, pad_track,
                             pad_samples, pad_axis, jv_track, jv_ref)
    final, traces = kernels.rigid_rollout(
        spec, world, pp, *args, k_robot=k_robot, k_pad=k_pad,
        k_world=k_world, iters=iters)
    return _unbatch(final, traces, single)
