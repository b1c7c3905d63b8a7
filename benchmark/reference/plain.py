"""Plain reference of what one plan request computes: the Panda's forward
kinematics, the collision scene of the request's primitives (the grid-free
analytic SDF and the voxel volumes with baked gradient channels), the
CHOMP obstacle terms, the CHOMP step, the goal set's checks and the
verdict of a trajectory.

Written from the planner's published equations (OMG-Planner, RSS 2020;
CHOMP, Ratliff et al. 2009) and the service's documented conventions,
in plain PyTorch.  It imports nothing of the program under test: the
robot's tables come from the raw files under ``benchmark/data/panda``,
the scene from the request body.  Every function takes a :class:`Prec`:
float64 is the reference itself, float32 with its matrix products rounded
to TF32 is the control (the precision one step below the program's
float32 with TF32 off).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass

import numpy as np
import torch

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data", "panda")

KINDS = {"box": 0, "sphere": 1, "cylinder": 2}
N_LINKS = 10
DOF = 9
# dof -> joint row (row 7 is the fixed hand)
DOF_ROWS = [0, 1, 2, 3, 4, 5, 6, 8, 9]
FINGER_LINKS = (8, 9)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest, ties to
    even), as a tensor core reads its operands."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32).to(torch.int64)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    out = bits.to(torch.int32).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


@dataclass(frozen=True)
class Prec:
    """Arithmetic of one side: ``dtype``, and whether matrix products read
    their operands in TF32."""

    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a).to(torch.get_default_device(),
                                          self.dtype)

    def mm(self, a, b):
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return a @ b

    def einsum(self, eq, *ops):
        if self.tf32:
            ops = [tf32_round(o) for o in ops]
        return torch.einsum(eq, *ops)


REF = Prec()
CONTROL = Prec(torch.float32, tf32=True)


# -- the robot ---------------------------------------------------------------

class Panda:
    """The Panda's tables from the raw asset files: rest poses, the DH
    offsets, mesh-centre offsets, limits and 15 body points a link."""

    def __init__(self, points_per_link: int = 15):
        t = dict(np.load(os.path.join(DATA, "panda_kinematics.npz"),
                         allow_pickle=True))
        self.pose_0 = t["pose_0"]
        self.center_offset = t["center_offset"]
        self.lower = t["joint_lower"]
        self.upper = t["joint_upper"]
        flip = np.diag([1.0, -1.0, -1.0, 1.0])
        post = []
        for i, a in enumerate(t["dh_offsets"]):
            c, s = math.cos(float(a)), math.sin(float(a))
            m = np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0],
                          [0, 0, 0, 1.0]])
            post.append(m @ flip if i > 0 else m)
        self.post = np.stack(post)
        pts = np.load(os.path.join(DATA, "panda_collision_points.npz"))[
            "points"]
        stride = max(pts.shape[1] // points_per_link, 1)
        self.points = pts[:, ::stride][:, :points_per_link]
        # affect[l, d]: does dof d move link l
        aff = np.zeros((N_LINKS, DOF))
        for j in range(N_LINKS):
            for d in range(7):
                aff[j, d] = 1.0 if (j >= 7 or d <= j) else 0.0
        aff[8, 7] = aff[9, 8] = 1.0
        self.affect = aff

    def soft_limits(self, padding: float):
        pad = np.zeros(DOF)
        pad[:7] = padding
        return self.lower + pad, self.upper - pad

    def fk(self, q: torch.Tensor, prec: Prec = REF, offset: bool = True):
        """Link poses [N, 10, 4, 4] (mesh centres when ``offset``), joint
        origins and axes [N, 10, 3] of configurations ``q [N, 9]``."""
        q = prec.t(q)
        n = q.shape[0]
        pose_0, post = prec.t(self.pose_0), prec.t(self.post)
        cur = torch.eye(4, dtype=prec.dtype).expand(n, 4, 4)
        links, origins, axes = [], [], []
        for i in range(7):
            pre = prec.mm(cur, pose_0[i])
            origins.append(pre[:, :3, 3])
            axes.append(pre[:, :3, 2])
            c, s = torch.cos(q[:, i]), torch.sin(q[:, i])
            rz = torch.zeros(n, 4, 4, dtype=prec.dtype)
            rz[:, 0, 0], rz[:, 0, 1], rz[:, 1, 0], rz[:, 1, 1] = c, -s, s, c
            rz[:, 2, 2] = rz[:, 3, 3] = 1.0
            cur = prec.mm(prec.mm(pre, rz), post[i])
            links.append(cur)
        hand = prec.mm(links[6], pose_0[7])
        lf = pose_0[8].expand(n, 4, 4).clone()
        lf[:, 1, 3] += q[:, 7]
        rf = pose_0[9].expand(n, 4, 4).clone()
        rf[:, 1, 3] -= q[:, 8]
        links += [hand, prec.mm(hand, lf), prec.mm(hand, rf)]
        origins += [hand[:, :3, 3], links[8][:, :3, 3], links[9][:, :3, 3]]
        axes += [torch.zeros_like(hand[:, :3, 1]), hand[:, :3, 1],
                 -hand[:, :3, 1]]
        poses = torch.stack(links, 1)
        if offset:
            poses = prec.mm(poses, prec.t(self.center_offset))
        return poses, torch.stack(origins, 1), torch.stack(axes, 1)

    def body_points(self, poses: torch.Tensor, prec: Prec = REF):
        """Body points [N, 10, P, 3] of link poses [N, 10, 4, 4]."""
        pts = prec.t(self.points)
        r = poses[..., :3, :3]
        return prec.einsum("nlab,lpb->nlpa", r, pts) + poses[..., None, :3, 3]

    def hand(self, q: torch.Tensor, prec: Prec = REF) -> torch.Tensor:
        """World pose of panda_hand [N, 4, 4] (no mesh offset)."""
        return self.fk(q, prec, offset=False)[0][:, 7]

    def jacobians(self, origins, axes, x, prec: Prec = REF):
        """Linear Jacobians of the body points [N, 10, P, 9, 3]: revolute
        columns axis x (x - origin), the prismatic fingers the axis."""
        rows = torch.as_tensor(DOF_ROWS)
        ax = axes[:, rows]                                    # [N, D, 3]
        og = origins[:, rows]
        rel = x[:, :, :, None, :] - og[:, None, None]
        axb = ax[:, None, None].expand(rel.shape)
        jac = torch.linalg.cross(axb, rel, dim=-1)
        jac[..., 7:, :] = axb[..., 7:, :]
        aff = prec.t(self.affect)
        return jac * aff[None, :, None, :, None]


# -- the collision scene ---------------------------------------------------

@dataclass
class Obj:
    kind: int
    half: np.ndarray     # [3] half extents
    inv_pose: np.ndarray  # [4, 4] world -> object
    eps: float
    clearance: float
    disabled: bool
    dims: np.ndarray     # [3] the object's own voxel dims
    origin: np.ndarray   # [3] its volume's origin


class Scene:
    """The collision scene of a request body, as the service's
    configuration defines it: each primitive's SDF with an inside penalty
    of 5, its edges rounded by its voxel size (analytic), or sampled at the
    centres of a 0.0075 m voxel grid padded by 12 cells and stacked to a
    common shape rounded up to 16 cells (voxel); the CHOMP hinge of
    epsilon 0.2 (0.1 for the target) and the collision clearance 0.01 (0
    for the target)."""

    DELTA = 0.0075
    PAD_CELLS = 12
    PENALTY = 5.0

    def __init__(self, body: dict, analytic: bool, epsilon=0.2,
                 target_epsilon=0.1, clearance=0.01, target_clearance=0.0):
        self.analytic = analytic
        self.objs = []
        for o in body["objects"]:
            kind = KINDS[o.get("kind", "box")]
            ext = np.asarray(o.get("extents", [0.06]), np.float64)
            if kind == 0:
                half = ext / 2.0
            elif kind == 1:
                half = np.array([ext[0]] * 3)
            else:
                half = np.array([ext[0], ext[0], ext[1] / 2.0])
            dims = (np.ceil(2 * half / self.DELTA)
                    + 2 * self.PAD_CELLS).astype(int)
            tgt = bool(o.get("target", False))
            self.objs.append(Obj(
                kind, half,
                np.linalg.inv(np.asarray(o["pose"], np.float64).reshape(4, 4)),
                target_epsilon if tgt else epsilon,
                target_clearance if tgt else clearance,
                o["name"] == "floor", dims, -(dims * self.DELTA) / 2.0))
        shape = np.max([o.dims for o in self.objs], axis=0)
        self.stack = ((shape + 15) // 16) * 16

    # the primitive SDF, penalised inside
    def _sdf(self, o: Obj, p: torch.Tensor, rounded: bool):
        half = torch.as_tensor(o.half, dtype=p.dtype)
        r = min(self.DELTA, 0.45 * float(o.half.min())) if rounded else 0.0
        hb = half - r
        q = torch.abs(p) - hb
        qx, qy, qz = q[..., 0], q[..., 1], q[..., 2]
        if o.kind == 0:
            d = (torch.sqrt((torch.clamp(q, min=0.0) ** 2).sum(-1))
                 + torch.clamp(torch.maximum(qx, torch.maximum(qy, qz)),
                               max=0.0))
        elif o.kind == 1:
            d = torch.sqrt((p * p).sum(-1)) - hb[0]
        else:
            dr = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2) - hb[0]
            d = (torch.sqrt(torch.clamp(dr, min=0.0) ** 2
                            + torch.clamp(qz, min=0.0) ** 2)
                 + torch.clamp(torch.maximum(dr, qz), max=0.0))
        d = d - r
        return torch.where(d < 0, d * self.PENALTY, d)

    def _analytic(self, o: Obj, p: torch.Tensor):
        """(value, object-frame gradient, gradient ambiguous) at p [N, 3]:
        the rounded primitive's SDF and its closed-form gradient."""
        tiny = 1e-12
        amb_tol = 1e-6
        half = torch.as_tensor(o.half, dtype=p.dtype)
        r = min(self.DELTA, 0.45 * float(o.half.min()))
        hb = half - r
        sp = torch.sign(p)
        q = torch.abs(p) - hb
        if o.kind == 0:
            qp = torch.clamp(q, min=0.0)
            l_out = torch.sqrt((qp * qp).sum(-1))
            qs = torch.sort(q, dim=-1, descending=True).values
            d = l_out + torch.clamp(qs[..., 0], max=0.0)
            g_out = sp * qp / torch.clamp(l_out, min=tiny)[..., None]
            is_max = (q == qs[..., :1]).to(p.dtype)
            g_in = sp * is_max / is_max.sum(-1, keepdim=True)
            g = torch.where((l_out > 0)[..., None], g_out, g_in)
            amb = ((l_out <= amb_tol) & (qs[..., 0] - qs[..., 1] < amb_tol)) \
                | (torch.abs(p) < amb_tol).any(-1)
        elif o.kind == 1:
            pn = torch.sqrt((p * p).sum(-1))
            d = pn - hb[0]
            g = p / torch.clamp(pn, min=tiny)[..., None]
            amb = pn < amb_tol
        else:
            rho = torch.sqrt(p[..., 0] ** 2 + p[..., 1] ** 2)
            dr = rho - hb[0]
            qz = q[..., 2]
            a, b = torch.clamp(dr, min=0.0), torch.clamp(qz, min=0.0)
            l_cyl = torch.sqrt(a * a + b * b)
            d = l_cyl + torch.clamp(torch.maximum(dr, qz), max=0.0)
            er = p[..., :2] / torch.clamp(rho, min=tiny)[..., None]
            ls = torch.clamp(l_cyl, min=tiny)
            g_out = torch.cat([(a / ls)[..., None] * er,
                               ((b / ls) * sp[..., 2])[..., None]], -1)
            g_in = torch.where(
                (dr >= qz)[..., None],
                torch.cat([er, torch.zeros_like(dr)[..., None]], -1),
                torch.cat([torch.zeros_like(er), sp[..., 2:3]], -1))
            g = torch.where((l_cyl > 0)[..., None], g_out, g_in)
            amb = ((l_cyl <= amb_tol) & (torch.abs(dr - qz) < amb_tol)) \
                | (rho < amb_tol) | (torch.abs(p[..., 2]) < amb_tol)
        d = d - r
        scale = torch.where(d < 0, self.PENALTY, 1.0).to(p.dtype)
        amb = amb | (torch.abs(d) < amb_tol)
        return d * scale, g * scale[..., None], amb

    def _voxel(self, o: Obj, p: torch.Tensor):
        """(value, object-frame gradient, ambiguous) at p [N, 3]: the
        trilinear read of the padded volume and of its central-difference
        gradient channels, (1, 0) where the 8-cell stencil leaves the
        volume."""
        dims = torch.as_tensor(self.stack, dtype=torch.int64)
        own = torch.as_tensor(o.dims, dtype=torch.int64)
        origin = torch.as_tensor(o.origin, dtype=p.dtype)
        delta = self.DELTA
        mn = origin
        # the stack's shape over the object's own, as the staging stretches
        # each object's box
        mx = torch.as_tensor(o.origin + (self.DELTA * o.dims) * self.stack
                             / o.dims, dtype=p.dtype)
        pg = (p - mn) / (mx - mn) * dims.to(p.dtype)
        g = pg - 0.5
        c0 = torch.trunc(g).to(torch.int64)
        f = g - c0
        inb = ((c0 >= 0) & (c0 + 1 < dims)).all(-1)
        # the read jumps to (1, 0) where the stencil leaves the volume
        # (g = -1 or dims - 1); within a hair of that it may go either way
        amb = ((torch.abs(g + 1) < 1e-3)
               | (torch.abs(g - (dims - 1)) < 1e-3)).any(-1)

        # every voxel the read needs, in one evaluation: the stencil's 8
        # corners, each with its 6 neighbours for the gradient channels
        # (central differences over 2 delta; +1 beyond the object's own
        # cells, which also covers the stack's border)
        corners = torch.tensor([[dx, dy, dz] for dx in (0, 1)
                                for dy in (0, 1) for dz in (0, 1)])
        nbrs = torch.cat([torch.zeros(1, 3, dtype=torch.int64),
                          torch.eye(3, dtype=torch.int64),
                          -torch.eye(3, dtype=torch.int64)])
        idx = c0[:, None, None] + corners[None, :, None] + nbrs[None, None]
        inside = ((idx >= 0) & (idx < own)).all(-1)
        ctr = origin + (idx.to(p.dtype) + 0.5) * delta
        v = self._sdf(o, ctr.reshape(-1, 3), rounded=False).reshape(
            inside.shape)
        v = torch.where(inside, v, torch.ones_like(v))       # [N, 8, 7]
        grad_c = 0.5 * (v[..., 1:4] - v[..., 4:7]) / delta
        chan = torch.cat([v[..., :1], grad_c], -1)           # [N, 8, 4]
        w = torch.where(corners.bool()[None], f[:, None], 1 - f[:, None])
        out = (torch.prod(w, -1)[..., None] * chan).sum(1)
        value = torch.where(inb, out[..., 0], torch.ones_like(out[..., 0]))
        grad = torch.where(inb[..., None], out[..., 1:],
                           torch.zeros_like(out[..., 1:]))
        return value, grad, amb

    def query(self, x: torch.Tensor, prec: Prec = REF, clear_tol=1e-6):
        """(potential [N], world gradient [N, 3], collide count [N],
        gradient-ambiguous [N], collide-ambiguous [N]) of world points
        ``x [N, 3]`` against every enabled object: the CHOMP hinge of each
        object's value, summed."""
        x = prec.t(x)
        pot = torch.zeros(x.shape[0], dtype=prec.dtype)
        grad = torch.zeros_like(x)
        coll = torch.zeros_like(pot)
        amb = torch.zeros(x.shape[0], dtype=torch.bool)
        camb = torch.zeros_like(amb)
        for o in self.objs:
            if o.disabled:
                continue
            inv = prec.t(o.inv_pose)
            r = inv[:3, :3]
            p = prec.einsum("ab,nb->na", r, x) + inv[:3, 3]
            if self.analytic:
                v, g, a = self._analytic(o, p)
            else:
                v, g, a = self._voxel(o, p)
            eps = o.eps
            inside = v <= 0
            band = (v > 0) & (v <= eps)
            pt = torch.where(inside, -v + 0.5 * eps, torch.zeros_like(v))
            pt = torch.where(band, (v - eps) ** 2 / (2 * eps), pt)
            gs = torch.where(inside, -torch.ones_like(v),
                             torch.where(band, (v - eps) / eps,
                                         torch.zeros_like(v)))
            pot = pot + pt
            grad = grad + prec.einsum("ba,nb->na", r, g * gs[..., None])
            coll = coll + (v < o.clearance).to(prec.dtype)
            amb = amb | a | (torch.abs(v - eps) < 1e-6)
            camb = camb | (torch.abs(v - o.clearance) < clear_tol)
        return pot, grad, coll, amb, camb


# -- the CHOMP operators ------------------------------------------------------

DIFF_RULES = np.array([[0.0, 0.0, -1.0, 1.0, 0.0, 0.0, 0.0],
                       [0.0, 0.0, 1.0, -2.0, 1.0, 0.0, 0.0],
                       [0.0, -0.5, 1.0, 0.0, -1.0, 0.5, 0.0]])


class Horizon:
    """The CHOMP operators of T waypoints over a 3 s motion with the goal
    free (goal-set projection): difference matrices, A = D1' D1, its
    inverse and the projection operators P_k, M_k of a k-row tail."""

    def __init__(self, t: int = 30, tail: int = 5):
        dt = 3.0 / t
        mats = []
        for order in (1, 2, 3):
            d = np.zeros((t + 1, t))
            for i in range(t + 1):
                for j in range(-3, 3):
                    if 0 <= i + j < t:
                        d[i, i + j] = DIFF_RULES[order - 1][j + 3]
            d[-1, -1] = 0.0
            mats.append(d / dt ** order)
        self.t, self.dt, self.tail = t, dt, tail
        self.d = np.stack(mats)
        self.A = self.d[0].T @ self.d[0]
        self.Ainv = np.linalg.inv(self.A)
        k = tail
        self.M = self.Ainv[:, -k:] @ np.linalg.inv(self.Ainv[-k:, -k:])
        self.P = self.Ainv - self.M @ self.Ainv[-k:, :]


def derivative(hz: Horizon, data, start, end, order: int, prec: Prec):
    """Endpoint-corrected finite difference of ``data [..., T, 3]`` along
    T (the start and end points fixed)."""
    n = data.shape[-2]
    dmat = prec.t(hz.d[order - 1][: n + 1, :n])
    moved = torch.movedim(data, -2, 0)
    out = prec.mm(dmat, moved.reshape(n, -1)).reshape(
        (n + 1,) + moved.shape[1:])
    out = torch.movedim(out, 0, -2).clone()
    rule = DIFF_RULES[order - 1]
    dt = hz.dt ** order
    out[..., 0, :] += rule[2] * start / dt
    out[..., -2, :] += rule[4] * end / dt
    out[..., -1, :] += rule[3] * end / dt
    return out[..., :-1, :]


def obstacle_terms(robot: Panda, hz: Horizon, x, og, ax, x_start, x_end, pot,
                   grad, collide, k: int, prec: Prec):
    """The CHOMP obstacle cost [T, L] and its configuration-space gradient
    [T, D] (Zucker et al. 2013, eq. 11; the finger links left out of the
    top-k selection), and the collision count, from a trajectory's body
    points ``x [T, L, P, 3]``, joint origins and axes [T, 10, 3], the
    start's and end's points [L, P, 3] and the query's ``pot``,
    ``grad``, ``collide``."""
    jac = robot.jacobians(og, ax, x, prec)
    xs = torch.movedim(x, 0, 2)
    v = torch.movedim(derivative(hz, xs, x_start, x_end, 1, prec), 2, 0)
    a = torch.movedim(derivative(hz, xs, x_start, x_end, 2, prec), 2, 0)
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    cost = pot * vn[..., 0]
    vh = v / (vn + 1e-8)

    def proj(w):
        return w - vh * torch.sum(vh * w, dim=-1, keepdim=True)

    direction = vn * proj(grad) - pot[..., None] * proj(a) / (vn ** 2 + 1e-8)
    n = pot.numel()
    if k and k < n:
        kth = torch.sort(pot.reshape(-1), descending=True).values[k - 1]
        sel = (pot >= kth).to(pot.dtype)
        mask = torch.ones(N_LINKS, dtype=pot.dtype)
        mask[list(FINGER_LINKS)] = 0.0
        sel = sel * mask[None, :, None]
    else:
        sel = torch.ones_like(pot)
    obs_cost = (cost * sel).sum(-1)
    obs_grad = prec.einsum("tlpdc,tlpc->td", jac, direction * sel[..., None])
    return obs_cost, obs_grad, collide.sum()


def chomp_step(hz: Horizon, xi, start, goal, tail, obs_cost, obs_grad,
               collide, weights, lower, upper, prec: Prec, clip=10.0,
               allow=5.0, terminate_smooth=35.0):
    """One CHOMP step (OMG-Planner's cost and projected update): the
    smoothness of ``xi [T, D]`` from ``start``, the weighted total cost and
    gradient, the flags (terminate, failure, execute, limits violated) and
    the goal-set-projected update of step size ``eta`` (arm joints only,
    the fingers held in [0, 0.04]).  Returns (new xi, floats [10 + T]:
    cost, obs, smooth, weighted obs and smooth, the three gradient norms,
    collide, distance to the goal, then the cost by waypoint; flags [4])."""
    w_obs, w_smooth, eta = weights
    d1 = prec.t(hz.d[0])
    ed = torch.zeros(xi.shape[0] + 1, xi.shape[1], dtype=prec.dtype)
    ed[0] = -start / hz.dt
    vel = prec.mm(d1, xi) + ed
    s_loss = 0.5 * torch.linalg.norm(vel, dim=1) ** 2
    s_grad = prec.mm(prec.t(hz.A), xi) + prec.mm(d1.T, ed)
    s_sum, o_sum = s_loss.sum(), obs_cost.sum()
    wo_grad = torch.clamp(w_obs * obs_grad, -clip, clip)
    ws_grad = w_smooth * s_grad
    grad = wo_grad + ws_grad
    cost_traj = w_obs * obs_cost.sum(-1) + w_smooth * s_loss[:-1]
    goal_dist = torch.linalg.norm(xi[-1] - goal)
    over = ((xi < lower - 5e-3).any() & (xi > upper + 5e-3)).any()
    terminate = (collide <= allow) & (goal_dist < 0.01) \
        & (s_sum < terminate_smooth)
    failure = (collide >= allow * 10) | (s_sum >= terminate_smooth * 2.5)
    execute = (collide <= allow) & (s_sum < terminate_smooth)
    floats = torch.cat([torch.stack([
        w_obs * o_sum + w_smooth * s_sum, o_sum, s_sum, w_obs * o_sum,
        w_smooth * s_sum, torch.linalg.norm(grad), torch.linalg.norm(ws_grad),
        torch.linalg.norm(wo_grad), collide.to(prec.dtype), goal_dist]),
        cost_traj])
    flags = torch.stack([terminate & ~over, failure, execute, over])
    k = tail.shape[0]
    update = -eta * prec.mm(prec.t(hz.P), grad) \
        - prec.mm(prec.t(hz.M), xi[-k:] - tail)
    update[:, 7:] = 0.0
    new = xi + update
    new[:, 7:] = torch.clamp(new[:, 7:], 0.0, 0.04)
    return new, floats, flags


def schedule(step: int, dtype=torch.float64):
    """The cost schedule at 1-based step ``step``: obstacle weight 1,
    smoothness weight 0.1 x 1.02^step, step size 0.1."""
    return (torch.tensor(1.0, dtype=dtype),
            torch.tensor(0.1 * 1.02 ** step, dtype=dtype),
            torch.tensor(0.1, dtype=dtype))


def cubic(start, end, n: int):
    """Clamped cubic spline from start to end at n interior waypoints."""
    t = torch.linspace(0.0, 1.0, n + 2, dtype=start.dtype)[1:-1]
    s = 3 * t ** 2 - 2 * t ** 3
    return start[None] + s[:, None] * (end - start)[None]


# -- the grasps ---------------------------------------------------------------

HAND_TO_GRASP = 0.103


def grasp_db(kind: int, extents, n_yaw: int = 8) -> np.ndarray:
    """The target's grasp database in its own frame [48, 4, 4]: hand
    poses approaching the centre from 8 yaws at pitches 0, 45 and 90
    degrees, each in two rolls, the grasp centre 0.103 m ahead of the
    hand."""
    poses = []
    for pitch in (0.0, np.pi / 4, np.pi / 2):
        for k in range(n_yaw):
            yaw = 2 * np.pi * k / n_yaw
            z = -np.array([np.cos(pitch) * np.cos(yaw),
                           np.cos(pitch) * np.sin(yaw), np.sin(pitch)])
            z = z / np.linalg.norm(z)
            up = np.array([0.0, 0.0, 1.0])
            if abs(z @ up) > 0.95:
                up = np.array([1.0, 0.0, 0.0])
            y = np.cross(z, up)
            y /= np.linalg.norm(y)
            x = np.cross(y, z)
            m = np.eye(4)
            m[:3, 0], m[:3, 1], m[:3, 2] = x, y, z
            m[:3, 3] = -HAND_TO_GRASP * z
            poses.append(m)
            m2 = m.copy()
            m2[:3, 0], m2[:3, 1] = -x, -y
            poses.append(m2)
    return np.stack(poses)


def target_grasps_world(body: dict) -> np.ndarray:
    """The target's grasp database in the world frame [48, 4, 4]."""
    for o in body["objects"]:
        if o.get("target"):
            pose = np.asarray(o["pose"], np.float64).reshape(4, 4)
            return pose[None] @ grasp_db(KINDS[o.get("kind", "box")],
                                         o.get("extents"))
    raise ValueError("no target")
