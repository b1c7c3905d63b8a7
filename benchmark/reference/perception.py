"""The comparison of the observed-cloud configuration (``panda_perception``):
``check.py``'s step and result checks with the scene of the request's
cloud, and the goal set held to the request's grasps.  The harness's
docstring gives the interface.

The scene is worked out from the request body and the configuration
file's ``cloud`` block alone:

* the layout: the cloud's lower and upper corners less and plus the
  margin, and ceil(extent / resolution) cells an axis, in float32 as the
  service stores the corner and counts the cells (an empty cloud is two
  points at (3, 3, 3), ``omg/core.py:433-434``);
* the grid: cell i at ``lo + i * resolution``, its distance to the nearest
  point of the cloud, by brute force over every (cell, point) pair,
  chunked;
* the read: the grid padded with +1 to a stack rounded up to 16 cells an
  axis, its central-difference gradient channels (+1 beyond the stack),
  read trilinearly at the point's ``pg - 0.5`` truncated, and (1, 0) where
  the 8-cell stencil leaves the stack, as ``plain.Scene._voxel`` reads a
  volume (here with no object frame: the cloud is in the world's);
* the hinge: the cloud is the target, so epsilon is the configuration's
  ``target_epsilon`` and the collision clearance 0.

The control computes the grid, like every other stage, in float32 with
its products in TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from . import check, plain
from .plain import REF, Prec
from .primitives import CHECKS

TARGET_CLEARANCE = 0.0
FLIP = np.diag([-1.0, -1.0, 1.0, 1.0])
# (cell, point) pairs of one chunk of the brute-force grid
CHUNK_PAIRS = 1 << 24


def grid_layout(points: np.ndarray, resolution: float, margin: float):
    """(lo [3] float64, dims [3] int) of the cloud's grid, worked out in
    float32."""
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    if len(pts) == 0:
        pts = np.full((2, 3), 3.0, np.float32)
    lo = pts.min(0) - np.float32(margin)
    hi = pts.max(0) + np.float32(margin)
    dims = np.ceil((hi - lo) / np.float32(resolution)).astype(np.int64)
    return lo.astype(np.float64), dims


def distance_grid(points, lo, dims, resolution: float,
                  prec: Prec) -> torch.Tensor:
    """[dims] distances from each cell ``lo + i * resolution`` to the
    nearest point, by brute force over every (cell, point) pair (chunks of
    cells): the squared distance's expansion |c|^2 + |p|^2 - 2 c.p in the
    side's arithmetic (in float64 within 1e-7 m of the difference form at
    a workspace's extents)."""
    pts = prec.t(np.asarray(points, np.float64).reshape(-1, 3))
    if len(pts) == 0:
        pts = prec.t(np.full((2, 3), 3.0))
    axes = [lo[a] + torch.arange(int(dims[a]), dtype=torch.float64)
            * resolution for a in range(3)]
    cells = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(
        -1, 3).to(prec.dtype)
    p2 = (pts * pts).sum(1)[None]
    out = []
    for c in torch.split(cells, max(1, CHUNK_PAIRS // len(pts))):
        d2 = (c * c).sum(1)[:, None] + p2 - 2 * prec.mm(c, pts.T)
        out.append(torch.sqrt(torch.clamp(d2.amin(1), min=0.0)))
    return torch.cat(out).reshape(tuple(int(d) for d in dims))


def baked_stack(grid: torch.Tensor, delta: float) -> torch.Tensor:
    """[S, 4]: the grid padded with +1 to a stack rounded up to 16 cells an
    axis, with its central-difference gradient channels (+1 beyond the
    stack)."""
    dims = grid.shape
    stack = tuple(((d + 15) // 16) * 16 for d in dims)
    v = torch.ones(stack, dtype=grid.dtype)
    v[:dims[0], :dims[1], :dims[2]] = grid
    padded = torch.nn.functional.pad(v, (1, 1, 1, 1, 1, 1), value=1.0)
    inner = (slice(1, -1),) * 3

    def cdiff(axis):
        up = [slice(1, -1)] * 3
        down = [slice(1, -1)] * 3
        up[axis], down[axis] = slice(2, None), slice(None, -2)
        return 0.5 * (padded[tuple(up)] - padded[tuple(down)]) / delta

    return torch.stack([padded[inner], cdiff(0), cdiff(1), cdiff(2)], -1)


class CloudScene(plain.Scene):
    """The collision scene of a ``/plan_cloud`` body: one object, the
    cloud's distance grid, queried by ``plain.Scene.query``'s hinge."""

    def __init__(self, body: dict, conf: dict):
        cloud = conf["cloud"]
        self.analytic = False
        self.points = body["points"]
        self.delta = float(cloud["resolution"])
        self.lo, self.dims = grid_layout(self.points, self.delta,
                                         float(cloud["margin"]))
        self.stack = ((self.dims + 15) // 16) * 16
        self.objs = [plain.Obj(
            kind=-1, half=np.zeros(3), inv_pose=np.eye(4),
            eps=float(conf["published"]["target_epsilon"]),
            clearance=TARGET_CLEARANCE, disabled=False, dims=self.dims,
            origin=self.lo)]
        self._baked = {}

    def baked(self, prec: Prec) -> torch.Tensor:
        """The padded stack with its gradient channels, in ``prec``."""
        if prec not in self._baked:
            grid = distance_grid(self.points, self.lo, self.dims, self.delta,
                                 prec)
            self._baked[prec] = baked_stack(grid, self.delta)
        return self._baked[prec]

    def _voxel(self, o, p: torch.Tensor):
        """(value, gradient, ambiguous) at world points p [N, 3], read from
        the grid of the side whose dtype the points have."""
        vol = self.baked(REF if p.dtype == REF.dtype else plain.CONTROL)
        dims = torch.as_tensor(self.stack, dtype=torch.int64)
        mn = torch.as_tensor(self.lo, dtype=p.dtype)
        mx = torch.as_tensor(self.lo + self.delta * self.stack, dtype=p.dtype)
        pg = (p - mn) / (mx - mn) * dims.to(p.dtype)
        g = pg - 0.5
        c0 = torch.trunc(g).to(torch.int64)
        f = g - c0
        inb = ((c0 >= 0) & (c0 + 1 < dims)).all(-1)
        amb = ((torch.abs(g + 1) < 1e-3)
               | (torch.abs(g - (dims - 1)) < 1e-3)).any(-1)
        corners = torch.tensor([[dx, dy, dz] for dx in (0, 1)
                                for dy in (0, 1) for dz in (0, 1)])
        idx = torch.minimum(torch.clamp(c0, min=0), dims - 2)
        idx = idx[:, None] + corners[None]                    # [N, 8, 3]
        chan = vol[idx[..., 0], idx[..., 1], idx[..., 2]]     # [N, 8, 4]
        w = torch.where(corners.bool()[None], f[:, None], 1 - f[:, None])
        out = (torch.prod(w, -1)[..., None] * chan).sum(1)
        value = torch.where(inb, out[..., 0], torch.ones_like(out[..., 0]))
        grad = torch.where(inb[..., None], out[..., 1:],
                           torch.zeros_like(out[..., 1:]))
        return value, grad, amb


def check_goal_set(body, gs, prec: Prec, out: check.Readings,
                   scene: CloudScene, ctrl: Prec | None = None):
    """``check.check_goal_set`` with the request's grasps, and their wrist
    flips, for the grasp database: each valid goal's hand pose against
    them, its standoff's potential and its validity."""
    robot, _ = check._setup()
    grasps, reach, mask, pots = (check._f(gs[0], prec), check._f(gs[1], prec),
                                 check._f(gs[2], prec).bool(),
                                 check._f(gs[3], prec))
    valid = torch.nonzero(mask).flatten()
    if valid.numel() == 0:
        return
    g, r, p = grasps[valid], reach[valid], pots[valid]
    db = np.asarray(body["grasps"], np.float64).reshape(-1, 4, 4)
    # the wrist flip's copies (the planner's augment_flip_grasp, joint 7
    # +/- pi): each grasp turned half a turn about its approach axis
    db = torch.as_tensor(np.concatenate([db, db @ FLIP]), dtype=prec.dtype)
    hands = robot.hand(g, prec)
    pos = torch.linalg.norm(hands[:, None, :3, 3] - db[None, :, :3, 3], dim=-1)
    rel = torch.einsum("mab,nac->nmbc", db[:, :3, :3], hands[:, :3, :3])
    ratio = torch.maximum(pos / 1e-3, check._rot_angle(rel) / 1e-2).min(
        1).values
    out.worst("goal_pose_err", ratio.max())
    pot, coll, camb = check._standoff_potentials(robot, scene, r[:, 0], prec)
    if ctrl is not None:
        p = prec.t(check._standoff_potentials(robot, scene, r[:, 0], ctrl)[0])
    out.worst("goal_pot_gap", check.rel_gap(p, pot, 1e-2))
    bad = coll - camb > 5
    notes = out.setdefault("goal_notes", [])
    if bad.any():
        notes.append(f"standoff collisions {(coll - camb)[bad].tolist()}")
    lo, hi = (prec.t(v[:7]) for v in robot.soft_limits(0.2))
    arm = r[..., :7]
    soft = ((arm[:, 0] < lo - 1e-5) | (arm[:, 0] > hi + 1e-5)).any(-1)
    tail = torch.abs(r[:, -1] - g).max(-1).values > 1e-6
    for what, m in (("standoff outside the soft limits", soft),
                    ("tail", tail)):
        if m.any():
            notes.append(f"{what}: {arm[m].tolist()}")
    out.worst("goal_invalid", int((bad | soft | tail).sum()))


def check_request(rec: dict, conf: dict, cfg, out: check.Readings):
    body, gs = rec["body"], rec["goal_set"]
    scene = CloudScene(body, conf)
    check_goal_set(body, gs, REF, out, scene)
    for i, step in enumerate(rec["steps"]):
        check.check_step(body, step, gs, REF, out, scene, first=(i == 0))
    check.check_result(body, rec["result"], gs, REF, out, scene)


def check_control(rec: dict, conf: dict, cfg) -> check.Readings:
    """``check.check_control`` with the cloud's scene: each stage of the
    plan's steps computed by the reference in float32 with TF32 products
    (the grid in float32), in the program's place, and held to the
    float64 reference."""
    out = check.Readings()
    body, gs = rec["body"], rec["goal_set"]
    scene = CloudScene(body, conf)
    robot, hz = check._setup()
    c = plain.CONTROL
    start = check._f(np.asarray(body["start"], np.float64), c)
    lo, hi = robot.soft_limits(0.2)
    for i, step in enumerate(rec["steps"]):
        xi = check._f(step["xi"], c)
        poses, og, ax = robot.fk(xi, c)
        x = robot.body_points(poses, c)
        pot, grad, coll, _, _ = scene.query(x.reshape(-1, 3), c)
        pot, coll = pot.reshape(x.shape[:3]), coll.reshape(x.shape[:3])
        grad = grad.reshape(x.shape)
        gi = int(step["goal_idx"])
        goal, tail = check._f(gs[0][gi], c), check._f(gs[1][gi], c)
        ends, _, _ = robot.fk(torch.stack([start, goal]), c)
        xe = robot.body_points(ends, c)
        oc, ogr, cc = plain.obstacle_terms(robot, hz, x, og, ax, xe[0], xe[1],
                                           pot, grad, coll, 1000, c)
        w = check._weights(step["weights"], c)
        new, floats, flags = plain.chomp_step(
            hz, xi, start, goal, tail, oc, ogr, cc, w, c.t(lo), c.t(hi), c)
        fake = dict(step, x=x, og=og, ax=ax, pot=pot, grad=grad,
                    collide=coll, obs_cost=oc, obs_grad=ogr, obs_collide=cc,
                    new_xi=new, floats=floats, flags=flags)
        check.check_step(body, fake, gs, REF, out, scene, first=(i == 0))
    check_goal_set(body, gs, REF, out, scene, ctrl=c)
    check.check_result(body, check.control_result(body, rec["result"], gs,
                                                  scene, c),
                       gs, REF, out, scene)
    return out
