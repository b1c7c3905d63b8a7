"""Execution validation: grade a planned trajectory the way the physics
harness would, without a physics engine (counterpart of
``omg_planner_tpu/planner/validate.py``, where the four checks are
argued in full).

1. Swept collision: the plan resampled so no joint moves more than
   ``max_joint_step`` between samples, every sample tested against the
   exact per-object query with zero clearance (an analytic scene is graded
   against its SHARP field, without the planner's edge rounding).
2. Grasp geometry: at the final configuration some target surface point
   lies in the closing volume between the finger pads.
3. Antipodal friction cone: contact candidates on both pad sides whose
   outward normals lie within the friction cone of the pad travel axis.
4. Lift clearance: the straight +z lift of the hand by 20 cm, tracked by
   IK, swept against the scene with the target attached.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models import api as model_api
from ..ops.ik import ik_single
from ..ops.sdf import AnalyticScene, _analytic_sdf_grad, sdf_potentials


class ExecutionReport(NamedTuple):
    swept_collision_points: int   # exact-query hits along the fine sweep
    grasp_ok: bool                # fingers straddle the target
    antipodal_ok: bool            # pad contacts admit a friction-cone pinch
    lift_collision_points: int    # hits along the +z retract sweep
    valid: bool                   # all checks pass

    def to_dict(self) -> dict:
        return {
            "swept_collision_points": int(self.swept_collision_points),
            "grasp_ok": bool(self.grasp_ok),
            "antipodal_ok": bool(self.antipodal_ok),
            "lift_collision_points": int(self.lift_collision_points),
            "valid": bool(self.valid),
        }


def _resample(traj: np.ndarray, max_step: float) -> np.ndarray:
    """Piecewise-linear resample so no joint moves more than ``max_step``
    rad between consecutive samples."""
    out = [traj[0]]
    for a, b in zip(traj[:-1], traj[1:]):
        d = float(np.abs(b - a).max())
        n = max(int(np.ceil(d / max_step)), 1)
        for i in range(1, n + 1):
            out.append(a + (b - a) * (i / n))
    return np.asarray(out)


def _exact_hits(model, scene_sdf, params, q_samples: torch.Tensor,
                skip_fingers: bool) -> int:
    """Total exact-query collision count over configurations [N, D]."""
    _, x = model_api.fk_points(model, q_samples)  # [N, L, P, 3]
    _, _, collide = sdf_potentials(
        scene_sdf, params.inv_poses, x.reshape(-1, 3), params.epsilons,
        params.padding_scales, torch.zeros_like(params.clearances),
        params.disables)
    collide = collide.reshape(x.shape[:3])
    if skip_fingers:
        keep = torch.as_tensor(1.0 - model_api.finger_link_mask(model),
                               device=collide.device)
        collide = collide * keep[None, :, None]
    return int(collide.sum())


def _grasp_geometry(hand_pose, target_pts_w, finger_opening) -> bool:
    """Fingers straddle the target: some target surface point sits inside
    the closing volume between the pads, in the HAND frame (+z approach,
    +/-y pad travel; grasp centre ~0.103 m along +z)."""
    r, t = hand_pose[:3, :3], hand_pose[:3, 3]
    local = (target_pts_w - t) @ r
    between_pads = torch.abs(local[:, 1]) < finger_opening
    in_stroke = ((torch.abs(local[:, 0]) < 0.05)
                 & (torch.abs(local[:, 2] - 0.103) < 0.05))
    return bool((between_pads & in_stroke).any())


def _target_surface_normals_obj(target, pts_obj: np.ndarray,
                                device="cpu") -> np.ndarray:
    """Outward unit surface normals (object frame) at surface points:
    closed-form for analytic primitives, central differences of the host
    grid lookup for data-backed volumes."""
    sdf = target.sdf
    if sdf.analytic is not None:
        kind, half, penal = sdf.analytic

        def t(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        _, g = _analytic_sdf_grad(
            t([kind], torch.int32), t(np.asarray(half, np.float32)[None]),
            t([penal]), t(np.asarray(pts_obj, np.float32)[None]))
        n = g[0].cpu().numpy()
    else:
        eps = float(sdf.delta)
        n = np.stack(
            [(sdf.get_distance(pts_obj + d) - sdf.get_distance(pts_obj - d))
             for d in (np.array([eps, 0, 0]), np.array([0, eps, 0]),
                       np.array([0, 0, eps]))], axis=-1) / (2 * eps)
    return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)


def _grasp_antipodal(hand_pose, pts_w, normals_w, finger_opening,
                     mu: float = 0.8) -> bool:
    """Force-closure precondition of the parallel pinch: among the points
    inside the closing volume there must be contact candidates on BOTH pad
    sides whose outward normals lie within the friction cone of the pad
    travel axis (hand-frame +/-y)."""
    r, t = np.asarray(hand_pose[:3, :3]), np.asarray(hand_pose[:3, 3])
    local = (np.asarray(pts_w) - t) @ r
    n_local = np.asarray(normals_w) @ r
    near = (np.abs(local[:, 1]) < finger_opening) \
        & (np.abs(local[:, 0]) < 0.05) & (np.abs(local[:, 2] - 0.103) < 0.05)
    if not near.any():
        return False
    cos_cone = 1.0 / np.sqrt(1.0 + mu * mu)   # cos(atan(mu))
    ny = n_local[near, 1]
    return bool((ny > cos_cone).any() and (ny < -cos_cone).any())


def validate_execution(scene, traj: np.ndarray,
                       max_joint_step: float = 0.02,
                       lift_height: float = 0.2,
                       lift_samples: int = 20) -> ExecutionReport:
    """Grade ``traj`` on ``scene`` (a PlanningScene), on its device; see the
    module doc."""
    model = scene.model
    env = scene.env
    dev = scene.device
    params = env.cost_params()
    scene_sdf = env.scene_sdf()
    if isinstance(scene_sdf, AnalyticScene):
        scene_sdf = scene_sdf._replace(
            rounds=torch.zeros_like(scene_sdf.rounds))

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    traj = np.asarray(traj)
    swept = _exact_hits(model, scene_sdf, params,
                        f32(_resample(traj, max_joint_step)),
                        skip_fingers=True)

    target = env.target
    q_end = f32(traj[-1])
    hand_t = model_api.tip_pose(model, q_end)
    hand = hand_t.cpu().numpy()
    grasp_ok = True
    antipodal_ok = True
    if target.points is not None:
        pts_obj = np.asarray(target.points)
        pts_w = (pts_obj @ target.pose_mat[:3, :3].T
                 + target.pose_mat[:3, 3])
        opening = float(np.asarray(traj[-1][-2:]).sum()) or 0.08
        grasp_ok = _grasp_geometry(hand_t, f32(pts_w),
                                   torch.tensor(opening, device=dev))
        if grasp_ok:
            normals_w = _target_surface_normals_obj(
                target, pts_obj, dev) @ target.pose_mat[:3, :3].T
            antipodal_ok = _grasp_antipodal(hand, pts_w, normals_w, opening)

    # lift sweep: track the hand up by lift_height with the target's own
    # collision disabled (it rides the hand)
    disables = params.disables.clone()
    disables[params.target_idx] = 1.0
    params_lift = params._replace(disables=disables)
    cfg = scene.cfg.replace(ik_max_iters=12)
    lo7, hi7 = model.joint_lower[:7], model.joint_upper[:7]
    q = q_end
    qs = []
    for i in range(1, lift_samples + 1):
        target_pose = hand_t.clone()
        target_pose[2, 3] += lift_height * i / lift_samples
        res = ik_single(model, target_pose, q[:7], cfg, lo7, hi7)
        q = torch.cat([res.q, q[7:]])
        qs.append(q)
    lift_hits = _exact_hits(model, scene_sdf, params_lift, torch.stack(qs),
                            skip_fingers=True)

    valid = (swept == 0) and grasp_ok and antipodal_ok and (lift_hits == 0)
    return ExecutionReport(swept, grasp_ok, antipodal_ok, lift_hits, valid)
