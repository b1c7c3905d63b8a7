"""Open-loop plan execution in the rigid-body stepper (counterpart of
``omg_planner_tpu/physics/executor.py``).

Mirrors the reference's PyBullet execution harness:

* ``bullet_execute_plan`` (``bullet/panda_scene.py:535-544``): step the
  position-controlled arm through every plan waypoint;
* ``PandaYCBEnv.retract`` (``:424-448``): close the fingers, then lift the
  end effector +0.03 m x 10 by IK;
* ``PandaYCBEnv._reward`` (``:486-504``): reward 1 iff the target ends
  within 0.2 m of the hand and above the table.

As in the JAX package, only the target is dynamic, the arm replays the
plan kinematically, and the finger joints are position motors with a stall
(dynamic state inside the rollout).  At the default widths a pick rollout
is settle + (T - 1) x ``sub_plan`` + 1 + ``sub_close`` + ``lift_stages`` x
``sub_lift`` + 1 substeps: 416 boundaries, 415 substeps, for a 30-waypoint
plan.

Device: everything runs on the scene's device (``scene.device``: ``cuda``
unless the scene was built for the CPU).  On the card the rollout is one
launch of the ``rigid_rollout`` kernel; on the CPU it is the plain PyTorch
loop.  The JAX package's host-CPU placement (``ensure_cpu_backend``,
``_phys_ctx``, ``OMG_PHYS_DEVICE``) has no counterpart here.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..models import api as model_api
from ..ops.ik import ik_single
from ..ops.sdf import _analytic_sdf_grad
from ..utils.pose import mat_to_quat
from . import rigid


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _body_spec_for(target, density: float, cfg=None,
                   device=None) -> rigid.RigidBodySpec:
    """Dynamic-body spec of a scene object: the closed-form SDF for an
    analytic primitive, the baked 4-channel grid with voxel-integrated mass
    properties for a data-backed object."""
    ana = getattr(target.sdf, "analytic", None)
    if ana is not None:
        return rigid.body_spec_from_primitive(
            int(ana[0]), np.asarray(ana[1]), density=density, device=device)
    if target.points is None:
        raise rigid.NoMassModelError(
            "data-backed target needs surface points for "
            "world contact candidates")
    penal = float(getattr(cfg, "penalize_constant", 5.0) or 5.0)
    return rigid.body_spec_from_grid(
        target.sdf, np.asarray(target.points), density=density,
        inside_penalty=penal, device=device)


@functools.lru_cache(maxsize=4)
def _phys_model(device: torch.device, n_points: int = 48):
    """The Panda with 48 collision points a link for contact generation
    (the planner's 15 leave gaps a pinched object can drift into), cached
    per device."""
    from ..models import panda

    return panda.load_panda(collision_point_num=n_points, device=device)


class PhysExecReport(NamedTuple):
    reward: int                 # the harness's binary lift reward
    lifted_m: float             # target height gain over the rollout
    hand_dist_m: float          # final |target - hand|
    moved_in_playback_m: float  # target displacement before the grasp
    grasp_impulse: float        # mean robot-contact normal impulse (lift)
    finger_stop_m: float        # realized finger joint at rollout end
    lift_height_m: float        # commanded retract (clearance-capped)

    def to_dict(self) -> dict:
        return {k: (int(v) if k == "reward" else float(v))
                for k, v in self._asdict().items()}


def _static_world(env, pad_to: int = 0, cfg=None,
                  device=None) -> rigid.StaticWorld:
    """Kinematic scene colliders: analytic primitives directly, data-backed
    obstacles as baked grid colliders.  ``pad_to`` pads the primitive
    count with inactive dummies so every scene of a suite has one shape."""
    kinds, halfs, rounds, invs, mask = [], [], [], [], []
    g4s, glims, ginvs = [], [], []
    penal = float(getattr(cfg, "penalize_constant", 5.0) or 5.0)
    for i, o in enumerate(env.objects):
        if i == env.target_idx:
            continue
        ana = getattr(o.sdf, "analytic", None)
        if ana is None:                    # mesh obstacle: baked grid
            _, grid4, lim = rigid.bake_grid_sdf(o.sdf, penal)
            g4s.append(grid4)
            glims.append(lim)
            ginvs.append(np.linalg.inv(o.pose_mat).astype(np.float32))
            continue
        kind, half, _ = ana
        kinds.append(int(kind))
        halfs.append(np.asarray(half, np.float32))
        rounds.append(float(o.sdf.delta))
        invs.append(np.linalg.inv(o.pose_mat).astype(np.float32))
        mask.append(1.0)
    while len(kinds) < max(pad_to, 1):     # >= 1 keeps shapes valid
        kinds.append(0)
        halfs.append(np.ones(3, np.float32))
        rounds.append(0.0)
        invs.append(np.eye(4, dtype=np.float32))
        mask.append(0.0)
    grid4 = grid_limits = grid_inv = None
    if g4s:
        n = max(len(g) for g in g4s)       # pad flat volumes to one shape
        g4s = [np.pad(g, ((0, n - len(g)), (0, 0))) for g in g4s]
        grid4 = _f32(np.stack(g4s), device)
        grid_limits = _f32(np.stack(glims), device)
        grid_inv = _f32(np.stack(ginvs), device)
    return rigid.StaticWorld(
        kinds=torch.as_tensor(kinds, dtype=torch.int32, device=device),
        halfs=_f32(np.stack(halfs), device), rounds=_f32(rounds, device),
        inv_poses=_f32(np.stack(invs), device), mask=_f32(mask, device),
        grid4=grid4, grid_limits=grid_limits, grid_inv_poses=grid_inv)


def _pad_axes(model, q9: np.ndarray, eps: float = 5e-3) -> np.ndarray:
    """Each finger's prismatic axis in its own link frame, by a finite
    difference of the pad origin along the finger joint."""
    qs = np.stack([np.asarray(q9, np.float64)] * 3)
    qs[1, -2] += eps
    qs[2, -1] += eps
    poses = model_api.fk_batch(model, _f32(qs, model.device)).cpu().numpy()
    axes = np.zeros((2, 3), np.float32)
    for f in range(2):
        p0 = poses[0, -2 + f]
        p1 = poses[1 + f, -2 + f]
        a = p0[:3, :3].T @ (p1[:3, 3] - p0[:3, 3]) / eps
        axes[f] = a / max(np.linalg.norm(a), 1e-9)
    return axes


def _clearance_phi(world: rigid.StaticWorld, pts: torch.Tensor):
    """World-SDF values of the lift sweep points ``pts [H, S, 3]`` ->
    ``phi [O (+ Og), H, S]`` (inactive colliders +inf)."""
    o = world.kinds.shape[0]
    h = pts.shape[0]
    po = torch.einsum("oab,hsb->ohsa", world.inv_poses[:, :3, :3], pts) \
        + world.inv_poses[:, None, None, :3, 3]
    phi, _ = _analytic_sdf_grad(
        world.kinds, world.halfs, torch.ones_like(world.rounds),
        po.reshape(o, -1, 3), rounds=world.rounds)
    phi = phi.reshape(o, h, -1)
    phi = torch.where(world.mask[:, None, None] > 0.5, phi,
                      torch.full_like(phi, torch.inf))
    if world.grid4 is not None and world.grid4.shape[0]:
        ng = world.grid4.shape[0]
        pg = torch.einsum("oab,hsb->ohsa", world.grid_inv_poses[:, :3, :3],
                          pts) + world.grid_inv_poses[:, None, None, :3, 3]
        phi_g, _ = rigid._grid_phi_grad(world.grid4, world.grid_limits,
                                        pg.reshape(ng, -1, 3))
        # out of a grid reads 1.0 (clear): no blocker
        phi = torch.cat([phi, phi_g.reshape(ng, h, -1)], dim=0)
    return phi


def _lift_clearance(world: rigid.StaticWorld, surf_w: np.ndarray,
                    lift_height: float, margin: float = 0.012,
                    n_heights: int = 31) -> float:
    """Largest +z travel (<= ``lift_height``, >= 0.08 m) for which the
    object's surface samples stay ``margin`` clear of every static
    collider they approach while rising (shelf scenes cap the retract)."""
    hs = np.linspace(0.0, lift_height, n_heights)
    pts = surf_w[None] + np.array([0.0, 0.0, 1.0]) * hs[:, None, None]
    phi = _clearance_phi(world, _f32(pts, world.kinds.device)).cpu().numpy()
    approaching = phi < phi[:, :1] - 1e-4
    blocked_h = ((phi < margin) & approaching).any(axis=(0, 2))  # [H]
    idx = np.nonzero(blocked_h)[0]
    h_ok = lift_height if len(idx) == 0 else float(hs[idx[0]]) - margin
    return float(np.clip(h_ok, 0.08, lift_height))


def _lift_configs(scene, q_end: np.ndarray, lift_height: float,
                  stages: int) -> np.ndarray:
    """IK waypoints of the +z retract (``retract``'s 10 x 0.03 m IK
    steps), by the damped-least-squares IK with 12 iterations a stage."""
    model = scene.model
    dev = scene.device
    cfg = scene.cfg.replace(ik_max_iters=12)
    lo7, hi7 = model.joint_lower[:7], model.joint_upper[:7]
    hand0 = model_api.tip_pose(model, _f32(q_end, dev))
    q = np.asarray(q_end, np.float64).copy()
    out = []
    for i in range(1, stages + 1):
        target_pose = hand0.clone()
        target_pose[2, 3] += lift_height * i / stages
        res = ik_single(model, target_pose, _f32(q[:7], dev), cfg, lo7, hi7)
        q = np.concatenate([res.q.cpu().numpy(), q[7:]])
        out.append(q.copy())
    return np.stack(out)


def _playback_segs(traj: np.ndarray, sub_plan: int,
                   settle: int) -> list[np.ndarray]:
    """Settle + waypoint-interpolated playback segments (one interpolation
    convention for the pick and place tracks)."""
    segs = [np.repeat(traj[0][None], settle, 0)]
    for a, b in zip(traj[:-1], traj[1:]):
        t = np.linspace(0.0, 1.0, sub_plan, endpoint=False)[:, None]
        segs.append(a[None] + (b - a)[None] * t)
    return segs


def _config_track(traj: np.ndarray, lift_qs: np.ndarray, jv_ref: np.ndarray,
                  sub_plan: int, sub_close: int, sub_lift: int,
                  settle: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Substep-resolution tracks: settle / playback / close / lift.

    Returns ``(configs [T, D], jv_cmd [T, 2], playback_end)``: ``configs``
    with the finger joints frozen at ``jv_ref`` (the realized finger value
    is dynamic state in the rollout), ``jv_cmd`` the position-control
    command: the plan's fingers, clipped to [0, 0.04], through playback,
    then 0 from the close on."""
    segs = _playback_segs(traj, sub_plan, settle)
    segs.append(traj[-1][None])
    playback_end = sum(len(s) for s in segs)
    segs.append(np.repeat(traj[-1][None], sub_close, 0))  # arm holds
    for prev, ql in zip([traj[-1]] + list(lift_qs[:-1]), lift_qs):
        t = np.linspace(0.0, 1.0, sub_lift, endpoint=False)[:, None]
        segs.append(prev[None] + (ql - prev)[None] * t)
    segs.append(lift_qs[-1][None])
    configs = np.concatenate(segs).astype(np.float32)
    jv_cmd = np.clip(configs[:, -2:], 0.0, 0.04).astype(np.float32)
    jv_cmd[playback_end:] = 0.0
    configs[:, -2:] = np.asarray(jv_ref, np.float32)[None]
    return configs, jv_cmd, playback_end


def _pad_geometry(model, m: int = 4):
    """Finger-pad contact surfaces: an axis-aligned box per finger link
    around its collision points, sampled with an ``m x m`` grid per face.
    Returns (center [2, 3], samples [2, Sp, 3] relative to the centre)."""
    pts = model.collision_points.cpu().numpy()[-2:]     # [2, P, 3]
    mins, maxs = pts.min(1), pts.max(1)
    center = (mins + maxs) / 2.0
    half = (maxs - mins) / 2.0 + 1e-3
    samples = np.stack(
        [rigid.box_face_grid(half[f], m).astype(np.float32)
         for f in range(2)])
    return _f32(center, model.device), _f32(samples, model.device)


def _rollout_inputs(model, spec, world, pp, configs, state0, pad_center,
                    pad_samples, pad_axis, jv_cmd, jv_ref) -> dict:
    """The keyword arguments of :func:`rigid.rollout` for one rollout:
    batched FK of the configuration track (fingers frozen at ``jv_ref``)
    gives the sphere and pad-frame tracks."""
    poses = model_api.fk_batch(model, configs)           # [T, L, 4, 4]
    x = model_api.point_positions(model, poses)          # [T, L, P, 3]
    fing = torch.as_tensor(np.repeat(model_api.finger_link_mask(model),
                                     x.shape[2]), device=configs.device)
    pad = poses[:, -2:]
    shift = torch.einsum("tfab,fb->tfa", pad[..., :3, :3], pad_center)
    pad = pad.clone()
    pad[..., :3, 3] = pad[..., :3, 3] + shift
    return dict(spec=spec, world=world, pp=pp, state0=state0,
                sph_track=x.reshape(x.shape[0], -1, 3), is_finger=fing,
                pad_track=pad, pad_samples=pad_samples, pad_axis=pad_axis,
                jv_track=jv_cmd, jv_ref=jv_ref)


class PickSetup(NamedTuple):
    """Everything :func:`execute_plan` builds before its rollout."""

    model: object
    inputs: dict            # keyword arguments of rigid.rollout
    configs: np.ndarray     # [T+1, 9] configuration track
    playback_end: int
    lift_height_m: float
    x0: np.ndarray          # [3] initial COM


def pick_setup(scene, traj: np.ndarray, params=None, lift_height: float = 0.3,
               density: float = 300.0, sub_plan: int = 6, sub_close: int = 90,
               sub_lift: int = 12, lift_stages: int = 10, settle: int = 30,
               pad_statics: int = 0) -> PickSetup:
    """The body, world, tracks and initial state of :func:`execute_plan`'s
    rollout (its arguments as there)."""
    dev = scene.device
    env = scene.env
    model = _phys_model(dev)
    target = env.target
    spec = _body_spec_for(target, density, scene.cfg, dev)
    world = _static_world(env, pad_to=pad_statics, cfg=scene.cfg, device=dev)
    pp = params if params is not None else rigid.default_params(device=dev)

    traj = np.asarray(traj, np.float64)
    jv_ref = np.clip(traj[0, -2:], 0.0, 0.04).astype(np.float32)
    r0 = np.asarray(target.pose_mat[:3, :3], np.float32)
    com = spec.com.cpu().numpy()
    # state is the COM pose (spec.com = COM in the object's own frame)
    x0 = (np.asarray(target.pose_mat[:3, 3]) + r0 @ com).astype(np.float32)
    surf_w = x0 + spec.surf.cpu().numpy() @ r0.T
    lift_h = _lift_clearance(world, surf_w, lift_height)
    lift_qs = _lift_configs(scene, traj[-1], lift_h, lift_stages)
    configs, jv_cmd, playback_end = _config_track(
        traj, lift_qs, jv_ref, sub_plan, sub_close, sub_lift, settle)
    state0 = rigid.BodyState(
        x=_f32(x0, dev), q=mat_to_quat(_f32(target.pose_mat[:3, :3], dev)),
        v=torch.zeros(3, device=dev), w=torch.zeros(3, device=dev))
    pad_center, pad_samples = _pad_geometry(model)
    pad_axis = _pad_axes(model, traj[-1])
    inputs = _rollout_inputs(
        model, spec, world, pp, _f32(configs, dev), state0, pad_center,
        pad_samples, _f32(pad_axis, dev), _f32(jv_cmd, dev),
        _f32(jv_ref, dev))
    return PickSetup(model, inputs, configs, playback_end, lift_h, x0)


def pick_report(setup: PickSetup, final, trace) -> PhysExecReport:
    """The lift reward and its scorecard from a pick rollout's result."""
    xs = trace["x"].cpu().numpy()
    imps = trace["robot_impulse"].cpu().numpy()
    hand_end = model_api.tip_pose(setup.model, _f32(
        setup.configs[-1], setup.model.device)).cpu().numpy()[:3, 3]
    obj_end = final.x.cpu().numpy()
    x0 = setup.x0
    lifted = float(obj_end[2] - float(x0[2]))
    hand_dist = float(np.linalg.norm(obj_end - hand_end))
    moved = float(np.linalg.norm(xs[setup.playback_end - 1] - x0))
    # the reference's reward: near the hand AND above the table
    # (panda_scene.py:486-504), "above" = meaningfully higher than the
    # resting start
    reward = int((hand_dist < 0.2) and (lifted > 0.05))
    return PhysExecReport(
        reward=reward, lifted_m=lifted, hand_dist_m=hand_dist,
        moved_in_playback_m=moved,
        grasp_impulse=float(imps[setup.playback_end:].mean()),
        finger_stop_m=float(trace["jv"].cpu().numpy()[-1].mean()),
        lift_height_m=float(setup.lift_height_m))


def execute_plan(scene, traj: np.ndarray, params=None,
                 lift_height: float = 0.3, density: float = 300.0,
                 sub_plan: int = 6, sub_close: int = 90, sub_lift: int = 12,
                 lift_stages: int = 10, settle: int = 30,
                 pad_statics: int = 0, iters: int = 96,
                 return_trace: bool = False):
    """Execute ``traj`` on ``scene`` (a PlanningScene) in the stepper, on
    the scene's device, and score the reference's lift reward.

    ``iters=96``: the pinch patch has ~50 aligned contacts, and the
    alignment-split Jacobi solve needs about that many iterations for the
    grip-friction modes (the JAX package's measurement)."""
    setup = pick_setup(scene, traj, params, lift_height, density, sub_plan,
                       sub_close, sub_lift, lift_stages, settle, pad_statics)
    final, trace = rigid.rollout(**setup.inputs, iters=iters)
    report = pick_report(setup, final, trace)
    if return_trace:
        out = {k: v.cpu().numpy() for k, v in trace.items()}
        out.update(playback_end=setup.playback_end, configs=setup.configs)
        return report, out
    return report


class PlaceExecReport(NamedTuple):
    """Scorecard of :func:`execute_place`."""

    reward: int             # placed within tolerance and settled
    place_err_xy_m: float   # final horizontal distance to the commanded pose
    place_err_z_m: float    # final vertical offset (signed, + = above)
    settle_speed: float     # |v| at the end (0 = at rest)
    carried: int            # 1 = the object survived the transport in-grip
    drop_h_m: float         # release-to-rest height (how far it fell)

    def to_dict(self) -> dict:
        ints = ("reward", "carried")
        return {k: (int(v) if k in ints else float(v))
                for k, v in self._asdict().items()}


def _hold_width_pens(spec, state, pad, pad_axis, pad_samples, jv_ref, grid):
    """Smallest pad-sample penetration for each candidate joint value in
    ``grid [G]`` (both fingers at the same value), [G]."""
    g = grid.shape[0]
    state_g = rigid.BodyState(*(a[None].expand(g, -1) for a in state))
    dv = grid[:, None].expand(g, 2) - jv_ref[None]
    pose = rigid._pad_pose(pad[None].expand(g, -1, -1, -1),
                           pad_axis[None].expand(g, -1, -1), dv)
    return rigid._pad_probe_pen(spec, state_g, pose, pad_samples).amin(-1)


def _finger_hold_width(model, spec: rigid.RigidBodySpec, q9: np.ndarray,
                       held_pose: np.ndarray, stall_pen: float,
                       n_grid: int = 81) -> float:
    """Finger joint value at which the pads pinch the held object to the
    motor's stall depth (0 when no width reaches it: the fingers then
    close on air and the object falls)."""
    dev = model.device
    pad_center, pad_samples = _pad_geometry(model)
    pad_axis = _f32(_pad_axes(model, q9), dev)
    poses = model_api.fk_batch(model, _f32(q9[None], dev))[0]
    pad = poses[-2:].clone()
    pad[:, :3, 3] = pad[:, :3, 3] + torch.einsum(
        "fab,fb->fa", pad[:, :3, :3], pad_center)
    x_com = held_pose[:3, 3] + held_pose[:3, :3] @ spec.com.cpu().numpy()
    state = rigid.BodyState(
        x=_f32(x_com, dev), q=mat_to_quat(_f32(held_pose[:3, :3], dev)),
        v=torch.zeros(3, device=dev), w=torch.zeros(3, device=dev))
    jv_ref = _f32(np.clip(q9[-2:], 0.0, 0.04), dev)
    grid = torch.linspace(0.0, 0.04, n_grid, device=dev)
    pens = _hold_width_pens(spec, state, pad, pad_axis, pad_samples, jv_ref,
                            grid).cpu().numpy()
    ok = np.nonzero(pens >= stall_pen)[0]
    return float(grid[ok.max()]) if len(ok) else 0.0


class PlaceSetup(NamedTuple):
    """Everything :func:`execute_place` builds before its rollout."""

    model: object
    inputs: dict            # keyword arguments of rigid.rollout
    configs: np.ndarray     # [T+1, 9] configuration track
    playback_end: int
    release_end: int
    com: np.ndarray         # [3] COM in the object's own frame


def place_setup(scene, traj: np.ndarray, rel_hand_pose: np.ndarray,
                params=None, density: float = 300.0, sub_plan: int = 24,
                settle: int = 30, open_steps: int = 90,
                retract_height: float = 0.1, retract_stages: int = 4,
                sub_lift: int = 12, pad_statics: int = 0) -> PlaceSetup:
    """The body, world, tracks and initial state of :func:`execute_place`'s
    rollout (its arguments as there)."""
    dev = scene.device
    env = scene.env
    model = _phys_model(dev)
    target = env.target
    spec = _body_spec_for(target, density, scene.cfg, dev)
    world = _static_world(env, pad_to=pad_statics, cfg=scene.cfg, device=dev)
    pp = params if params is not None else rigid.default_params(device=dev)

    traj = np.asarray(traj, np.float64)
    jv_ref = np.clip(traj[0, -2:], 0.0, 0.04).astype(np.float32)
    hand0 = model_api.tip_pose(model, _f32(traj[0], dev)).cpu().numpy()
    held0 = hand0 @ np.asarray(rel_hand_pose)
    jv0 = _finger_hold_width(model, spec, traj[0], held0, float(pp.stall_pen))

    retract_qs = _lift_configs(scene, traj[-1], retract_height,
                               retract_stages)
    # settle (grip forms) / place playback / hold / open / retract
    segs = _playback_segs(traj, sub_plan, settle)
    segs.append(np.repeat(traj[-1][None], settle, 0))
    playback_end = sum(len(s) for s in segs)
    segs.append(np.repeat(traj[-1][None], open_steps, 0))
    release_end = playback_end + open_steps
    for prev, ql in zip([traj[-1]] + list(retract_qs[:-1]), retract_qs):
        t = np.linspace(0.0, 1.0, sub_lift, endpoint=False)[:, None]
        segs.append(prev[None] + (ql - prev)[None] * t)
    segs.append(np.repeat(retract_qs[-1][None], settle, 0))
    configs = np.concatenate(segs).astype(np.float32)
    jv_cmd = np.zeros((len(configs), 2), np.float32)
    jv_cmd[playback_end:] = 0.04            # open from the release phase on
    configs[:, -2:] = jv_ref[None]
    jv_cmd[0] = jv0                          # rollout's initial joint value

    com = spec.com.cpu().numpy()
    state0 = rigid.BodyState(
        x=_f32(held0[:3, 3] + held0[:3, :3] @ com, dev),
        q=mat_to_quat(_f32(held0[:3, :3], dev)),
        v=torch.zeros(3, device=dev), w=torch.zeros(3, device=dev))
    pad_center, pad_samples = _pad_geometry(model)
    pad_axis = _pad_axes(model, traj[0])
    inputs = _rollout_inputs(
        model, spec, world, pp, _f32(configs, dev), state0, pad_center,
        pad_samples, _f32(pad_axis, dev), _f32(jv_cmd, dev),
        _f32(jv_ref, dev))
    return PlaceSetup(model, inputs, configs, playback_end, release_end, com)


def execute_place(scene, traj: np.ndarray, place_pose: np.ndarray,
                  rel_hand_pose: np.ndarray, params=None,
                  density: float = 300.0, sub_plan: int = 24,
                  settle: int = 30, open_steps: int = 90,
                  retract_height: float = 0.1, retract_stages: int = 4,
                  sub_lift: int = 12, pad_statics: int = 0, iters: int = 96,
                  tol_xy: float = 0.05, tol_z: float = 0.05,
                  return_trace: bool = False):
    """Execute a placement plan and score it: the object starts in the
    grip (held pose = hand(traj[0]) @ ``rel_hand_pose``), rides the
    playback under gravity, is released and must come to rest within
    tolerance of ``place_pose`` (reference ``real_world/trial.py:68-185``).

    Reward = horizontal error < ``tol_xy`` and vertical error < ``tol_z``
    and settled (final speed < 5 cm/s); ``carried`` = still at its
    attach-relative pose (within 5 cm) when the playback ends."""
    setup = place_setup(scene, traj, rel_hand_pose, params, density,
                        sub_plan, settle, open_steps, retract_height,
                        retract_stages, sub_lift, pad_statics)
    model, com = setup.model, setup.com
    configs = setup.configs
    playback_end, release_end = setup.playback_end, setup.release_end
    dev = scene.device
    final, trace = rigid.rollout(**setup.inputs, iters=iters)

    xs = trace["x"].cpu().numpy()
    x_end = final.x.cpu().numpy()
    pp_mat = np.asarray(place_pose)
    place_p = pp_mat[:3, 3] + pp_mat[:3, :3] @ com   # commanded COM
    held_rel = (model_api.tip_pose(model, _f32(
        configs[playback_end - 1], dev)).cpu().numpy()
        @ np.asarray(rel_hand_pose))
    hand_rel = held_rel[:3, 3] + held_rel[:3, :3] @ com
    carried = int(np.linalg.norm(xs[playback_end - 1] - hand_rel) < 0.05)
    err = x_end - place_p
    err_xy = float(np.linalg.norm(err[:2]))
    err_z = float(err[2])
    speed = float(np.linalg.norm(final.v.cpu().numpy()))
    drop = float(xs[release_end - 1][2] - x_end[2])
    reward = int(err_xy < tol_xy and abs(err_z) < tol_z and speed < 0.05)
    report = PlaceExecReport(
        reward=reward, place_err_xy_m=err_xy, place_err_z_m=err_z,
        settle_speed=speed, carried=carried, drop_h_m=drop)
    if return_trace:
        out = {k: v.cpu().numpy() for k, v in trace.items()}
        out.update(playback_end=playback_end, release_end=release_end,
                   configs=configs)
        return report, out
    return report
