"""The comparison that decides ``correct``: each answered plan of the
sample held, layer by layer, to the plain reference (``plain.py``).

What is compared, for each request of the sample (the program's tensors
are its own outputs, taken from the timed path; the reference works out
from the request body everything else):

* the goal set: each valid goal's hand pose against the target's grasp
  database (the configuration's IK acceptance, 10 x ``ik_pos_tol`` and
  10 x ``ik_rot_tol``, is the limit), its standoff's collision potential,
  and its validity (collisions at the standoff, joint limits, the tail
  ending on the goal);
* the plan's first and last steps, each stage from the program's own
  input to that stage: forward kinematics of the step's trajectory, the
  collision query at the step's body points (values, gradients, collision
  flags), the obstacle terms from the query's outputs, the CHOMP step from
  the obstacle terms; and that the first step's trajectory is the cubic
  spline to a valid goal;
* the returned trajectory: its smoothness, collision count and distance
  to the goal against the plan's reported values, and its verdict.

Numbers are the widest gaps over the sample.  A gap that falls on a
point or a flag within a hair of a switch of the reference's own function
(a medial surface, a threshold) is left out and counted apart.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import plain
from .plain import REF, Horizon, Panda, Prec, Scene

ROBOT = None
HZ = None


def _setup():
    global ROBOT, HZ
    if ROBOT is None:
        ROBOT, HZ = Panda(), Horizon(30, 5)
    return ROBOT, HZ


def _f(t, prec: Prec = REF):
    return prec.t(t)


def rel_gap(a, b, floor: float) -> float:
    """max |a - b| over max(max |b|, floor)."""
    if a.numel() == 0:
        return 0.0
    d = torch.abs(a.to(b.dtype) - b)
    return float(d.max()) / max(float(torch.abs(b).max()), floor)


def _rot_angle(r):
    tr = (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1) / 2
    return torch.arccos(torch.clamp(tr, -1.0, 1.0))


class Readings(dict):
    def worst(self, key, value):
        self[key] = max(self.get(key, 0.0), float(value))


def _standoff_potentials(robot, scene, standoff, prec: Prec):
    """(potential sum, collision count, count ambiguous) at each standoff
    configuration [V, 9], the fingers' potentials x 0.1 and their
    collisions left out."""
    poses, _, _ = robot.fk(standoff, prec)
    x = robot.body_points(poses, prec)                            # [V,10,P,3]
    pot, _, coll, _, camb = scene.query(x.reshape(-1, 3), prec)
    pot = pot.reshape(x.shape[:3])
    coll = coll.reshape(x.shape[:3])
    camb = camb.reshape(x.shape[:3])
    pot[:, 8:] *= 0.1
    coll[:, 8:] = 0
    camb[:, 8:] = False
    return pot.sum((1, 2)), coll.sum((1, 2)), camb.sum((1, 2))


def check_goal_set(body, gs, prec: Prec, out: Readings, scene: Scene,
                   ctrl: Prec | None = None):
    """The goal set's readings; with ``ctrl``, the standoffs' potentials
    are the control's instead of the program's."""
    robot, _ = _setup()
    grasps, reach, mask, pots = (_f(gs[0], prec), _f(gs[1], prec),
                                 _f(gs[2], prec).bool(), _f(gs[3], prec))
    valid = torch.nonzero(mask).flatten()
    if valid.numel() == 0:
        return
    g, r, p = grasps[valid], reach[valid], pots[valid]
    db = torch.as_tensor(plain.target_grasps_world(body), dtype=prec.dtype)
    hands = robot.hand(g, prec)                                   # [V, 4, 4]
    pos = torch.linalg.norm(hands[:, None, :3, 3] - db[None, :, :3, 3], dim=-1)
    rel = torch.einsum("mab,nac->nmbc", db[:, :3, :3], hands[:, :3, :3])
    ang = _rot_angle(rel)
    # the configuration's acceptance: 10 x ik_pos_tol, 10 x ik_rot_tol
    ratio = torch.maximum(pos / 1e-3, ang / 1e-2).min(1).values
    out.worst("goal_pose_err", ratio.max())
    # the goal's potential is the standoff's (first tail row), fingers x 0.1
    pot, coll, camb = _standoff_potentials(robot, scene, r[:, 0], prec)
    if ctrl is not None:
        p = prec.t(_standoff_potentials(robot, scene, r[:, 0], ctrl)[0])
    out.worst("goal_pot_gap", rel_gap(p, pot, 1e-2))
    n_lo = coll - camb
    bad = n_lo > 5
    notes = out.setdefault("goal_notes", [])
    if bad.any():
        notes.append(f"standoff collisions {n_lo[bad].tolist()}")
    # the configuration's guarantees: the standoff within the soft limits
    # (the IK's clamp, and the wrist flip's check, which looks at the
    # standoff alone as the reference planner's does), the tail ending on
    # the goal
    lo, hi = (prec.t(v[:7]) for v in robot.soft_limits(0.2))
    arm = r[..., :7]
    soft = ((arm[:, 0] < lo - 1e-5) | (arm[:, 0] > hi + 1e-5)).any(-1)
    tail = torch.abs(r[:, -1] - g).max(-1).values > 1e-6
    for what, m in (("standoff outside the soft limits", soft),
                    ("tail", tail)):
        if m.any():
            notes.append(f"{what}: {arm[m].tolist()}")
    bad = bad | soft | tail
    out.worst("goal_invalid", int(bad.sum()))


def _weights(w, prec: Prec):
    """The reference's schedule at the step whose smoothness weight the
    program used: None when it is no step of the schedule."""
    obs_w, smooth_w, eta = (float(v) for v in w)
    s = round(math.log(smooth_w / 0.1) / math.log(1.02))
    ref = plain.schedule(s, prec.dtype)
    if (abs(float(ref[1]) - smooth_w) > 1e-5 * smooth_w
            or abs(obs_w - 1.0) > 1e-6 or abs(eta - 0.1) > 1e-7):
        return None
    return ref


def check_step(body, step, gs, prec: Prec, out: Readings, scene: Scene,
               first: bool):
    robot, hz = _setup()
    xi = _f(step["xi"], prec)
    gi = int(step["goal_idx"])
    goal, tail = _f(gs[0][gi], prec), _f(gs[1][gi], prec)
    start = _f(np.asarray(body["start"], np.float64), prec)
    # forward kinematics of the step's trajectory; the first step's is the
    # reference's own start, the cubic spline from the start to the valid
    # goal whose spline lies nearest the program's
    xi_fk = xi
    if first:
        valid = torch.nonzero(_f(gs[2]).bool()).flatten()
        splines = torch.stack([plain.cubic(start, _f(gs[0][v], prec), 30)
                               for v in valid])
        xi_fk = splines[torch.abs(splines - xi[None]).amax((1, 2)).argmin()]
    poses, og, ax = robot.fk(xi_fk, prec)
    x = robot.body_points(poses, prec)
    xp, ogp, axp = _f(step["x"], prec), _f(step["og"], prec), \
        _f(step["ax"], prec)
    out.worst("fk_gap_m", max(float(torch.abs(xp - x).max()),
                              float(torch.abs(ogp - og).max()),
                              float(torch.abs(axp - ax).max())))
    # the collision query at the program's body points
    pot, grad, coll, amb, camb = scene.query(xp.reshape(-1, 3), prec)
    potp = _f(step["pot"], prec).reshape(-1)
    gradp = _f(step["grad"], prec).reshape(-1, 3)
    collp = _f(step["collide"], prec).reshape(-1)
    keep = ~amb
    out.worst("sdf_pot_gap", rel_gap(potp[keep], pot[keep], 1e-2))
    out.worst("sdf_grad_gap", rel_gap(gradp[keep], grad[keep], 1e-2))
    out.worst("collide_excess", max(
        0, int((collp != coll).sum()) - int(camb.sum())))
    out.setdefault("points_left_out", 0)
    out["points_left_out"] += int(amb.sum())
    # the obstacle terms from the query's outputs
    ends, _, _ = robot.fk(torch.stack([start, goal]), prec)
    xe = robot.body_points(ends, prec)
    oc, ogr, cc = plain.obstacle_terms(
        robot, hz, xp, ogp, axp, xe[0], xe[1], potp.reshape(xp.shape[:3]),
        gradp.reshape(xp.shape), collp.reshape(xp.shape[:3]), 1000, prec)
    ocp, ogrp = _f(step["obs_cost"], prec), _f(step["obs_grad"], prec)
    out.worst("obstacle_gap", max(rel_gap(ocp, oc, 1e-3),
                                  rel_gap(ogrp, ogr, 1e-3),
                                  abs(float(step["obs_collide"]) - float(cc))))
    # the CHOMP step from the obstacle terms
    w = _weights(step["weights"], prec)
    if w is None:
        out.worst("step_gap", 1.0)
        return
    lo, hi = robot.soft_limits(0.2)
    new, floats, flags = plain.chomp_step(
        hz, xi, start, goal, tail, ocp, ogrp,
        torch.as_tensor(float(step["obs_collide"]), dtype=prec.dtype), w,
        prec.t(lo), prec.t(hi), prec)
    newp, fp = _f(step["new_xi"], prec), _f(step["floats"], prec)
    upd = float(torch.abs(new - xi).max())
    gap = float(torch.abs(newp - new).max()) / max(upd, 1e-6)
    scale = torch.clamp(torch.abs(floats), min=1e-3)
    gap = max(gap, float((torch.abs(fp - floats) / scale).max()))
    out.worst("step_gap", gap)
    flagp = step["flags"].to(flags.device).bool()
    s_sum, dist = float(floats[2]), float(floats[9])
    near = (abs(s_sum - 35.0) < 1e-5 * 35 or abs(s_sum - 87.5) < 1e-5 * 87.5
            or abs(dist - 0.01) < 1e-6 or _near_limits(xi, lo, hi))
    if not near:
        out.worst("flag_flips", out.get("flag_flips", 0)
                  + int((flagp != flags).sum()))


def _near_limits(xi, lo, hi, tol=1e-6):
    lo, hi = torch.as_tensor(lo, dtype=xi.dtype), torch.as_tensor(
        hi, dtype=xi.dtype)
    return bool(((torch.abs(xi - (lo - 5e-3)) < tol)
                 | (torch.abs(xi - (hi + 5e-3)) < tol)).any())


def _smoothness(hz, traj, start, prec: Prec):
    d1 = prec.t(hz.d[0])
    ed = torch.zeros(traj.shape[0] + 1, traj.shape[1], dtype=prec.dtype)
    ed[0] = -start / hz.dt
    return (0.5 * torch.linalg.norm(prec.mm(d1, traj) + ed, dim=1) ** 2
            ).sum()


def control_result(body, res, gs, scene: Scene, ctrl: Prec) -> dict:
    """``res`` with the plan's reported final values worked out by the
    control at its trajectory (the distance to the goal the plan reports
    against stays the program's: no product enters it)."""
    robot, hz = _setup()
    traj = ctrl.t(np.asarray(res["traj"], np.float64))
    start = ctrl.t(np.asarray(body["start"], np.float64))
    poses, _, _ = robot.fk(traj, ctrl)
    x = robot.body_points(poses, ctrl)
    _, _, coll, _, _ = scene.query(x.reshape(-1, 3), ctrl)
    return dict(res, smooth=float(_smoothness(hz, traj, start, ctrl)),
                collide=float(coll.sum()))


def check_result(body, res, gs, prec: Prec, out: Readings, scene: Scene):
    """The returned trajectory and verdict against the plan's reported
    final values (``res``: traj, flag, smooth, collide, reach)."""
    robot, hz = _setup()
    traj = _f(np.asarray(res["traj"], np.float64), prec)
    start = _f(np.asarray(body["start"], np.float64), prec)
    smooth = _smoothness(hz, traj, start, prec)
    poses, _, _ = robot.fk(traj, prec)
    x = robot.body_points(poses, prec)
    _, _, coll, _, camb = scene.query(x.reshape(-1, 3), prec)
    n_coll, n_amb = float(coll.sum()), int(camb.sum())
    valid = torch.nonzero(_f(gs[2]).bool()).flatten()
    dists = torch.linalg.norm(_f(gs[0], prec)[valid] - traj[-1][None], dim=-1)
    reach_p = float(res["reach"])
    reach_gap = float(torch.abs(dists - reach_p).min()) if len(valid) else 0.0
    out.worst("final_gap", max(
        abs(float(res["smooth"]) - float(smooth)) / float(smooth),
        reach_gap / max(reach_p, 1e-3)))
    out.worst("collide_excess", max(
        0, abs(int(round(float(res["collide"]))) - int(n_coll)) - n_amb))
    lo, hi = robot.soft_limits(0.2)
    dmin = float(dists.min()) if len(valid) else math.inf
    over = bool(((traj < prec.t(lo) - 5e-3).any()
                 & (traj > prec.t(hi) + 5e-3)).any())
    verdict = (n_coll <= 5) and dmin < 0.01 and float(smooth) < 35.0 \
        and not over
    near = ((n_coll - n_amb <= 5) != (n_coll + n_amb <= 5)
            or abs(dmin - 0.01) < 1e-6
            or abs(float(smooth) - 35.0) < 1e-5 * 35
            or _near_limits(traj, lo, hi))
    if bool(res["flag"]) != verdict and not near:
        out["flag_flips"] = out.get("flag_flips", 0) + 1


def check_request(rec: dict, analytic: bool, prec: Prec = REF,
                  out: Readings | None = None) -> Readings:
    """Every reading of one captured request (see the module's text)."""
    out = Readings() if out is None else out
    body, gs = rec["body"], rec["goal_set"]
    scene = Scene(body, analytic)
    check_goal_set(body, gs, prec, out, scene)
    for i, step in enumerate(rec["steps"]):
        check_step(body, step, gs, prec, out, scene, first=(i == 0))
    check_result(body, rec["result"], gs, prec, out, scene)
    return out


def check_control(rec: dict, analytic: bool) -> Readings:
    """The control's readings on one request: each stage of the plan's
    steps computed by the reference in float32 with TF32 products, in the
    program's place, from the same inputs, and held to the float64
    reference."""
    out = Readings()
    body, gs = rec["body"], rec["goal_set"]
    scene = Scene(body, analytic)
    robot, hz = _setup()
    c = plain.CONTROL
    for i, step in enumerate(rec["steps"]):
        # each stage from the control's own previous stage, as
        # check_step takes the program's
        xi = _f(step["xi"], c)
        poses, og, ax = robot.fk(xi, c)
        x = robot.body_points(poses, c)
        pot, grad, coll, _, _ = scene.query(x.reshape(-1, 3), c)
        pot, coll = pot.reshape(x.shape[:3]), coll.reshape(x.shape[:3])
        grad = grad.reshape(x.shape)
        gi = int(step["goal_idx"])
        goal, tail = _f(gs[0][gi], c), _f(gs[1][gi], c)
        start = _f(np.asarray(body["start"], np.float64), c)
        ends, _, _ = robot.fk(torch.stack([start, goal]), c)
        xe = robot.body_points(ends, c)
        oc, ogr, cc = plain.obstacle_terms(robot, hz, x, og, ax, xe[0], xe[1],
                                           pot, grad, coll, 1000, c)
        w = _weights(step["weights"], c)
        lo, hi = robot.soft_limits(0.2)
        new, floats, flags = plain.chomp_step(
            hz, xi, start, goal, tail, oc, ogr, cc, w, c.t(lo), c.t(hi), c)
        fake = dict(step, x=x, og=og, ax=ax, pot=pot, grad=grad,
                    collide=coll, obs_cost=oc, obs_grad=ogr, obs_collide=cc,
                    new_xi=new, floats=floats, flags=flags)
        check_step(body, fake, gs, REF, out, scene, first=(i == 0))
    check_goal_set(body, gs, REF, out, scene, ctrl=c)
    check_result(body, control_result(body, rec["result"], gs, scene, c),
                 gs, REF, out, scene)
    return out
