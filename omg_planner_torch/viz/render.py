"""Host-side debug visualization (matplotlib, no GL); counterpart of
``omg_planner_tpu/viz/render.py``.

The reference ships a ~4.8k-line EGL/CUDA offscreen renderer
(``ycb_render/``) whose planner-facing role is debug frames and videos
(``PlanningScene.fast_debug_vis``, ``omg/core.py:487-678``).  Drawing is
host-side, so this module provides capability parity — trajectory
playback, collision-point/gradient overlays, goal-set ghosts, video
export — with matplotlib 3-D, not a GL pipeline.  The geometry behind a
frame (FK, the collision probe) runs on the model's device and is copied
to the host for each frame.  matplotlib and cv2 are imported only when a
frame is drawn or a video written.
"""

from __future__ import annotations

import numpy as np
import torch


def _require_mpl():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def render_frame(
    model,
    objects,
    q: np.ndarray,
    collision_pts: np.ndarray | None = None,
    potentials: np.ndarray | None = None,
    grads: np.ndarray | None = None,
    goal_configs: np.ndarray | None = None,
    size=(640, 480),
    elev: float = 25.0,
    azim: float = -150.0,
) -> np.ndarray:
    """Render one configuration; returns an RGB uint8 image.

    Modes mirror ``fast_debug_vis``: plain robot+scene; collision points
    colored by potential with gradient quivers; goal-set ghost skeletons.
    The skeletons of ``q`` and the ghosts come from one batched FK call on
    the model's device.
    """
    from ..models import panda

    qs = np.asarray(q, np.float32)[None]
    if goal_configs is not None:
        qs = np.concatenate([np.asarray(goal_configs, np.float32)
                             .reshape(-1, qs.shape[1]), qs])
    poses_all = panda.forward_kinematics_batch(
        model, torch.as_tensor(qs, device=model.device),
        apply_offset=False).cpu().numpy()

    plt = _require_mpl()
    fig = plt.figure(figsize=(size[0] / 100, size[1] / 100), dpi=100)
    ax = fig.add_subplot(111, projection="3d")

    def skeleton(poses, color, alpha=1.0, lw=2.0):
        pts = np.concatenate([np.zeros((1, 3)), poses[:8, :3, 3]])
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], "-o", color=color,
                alpha=alpha, lw=lw, ms=3)
        for f in (8, 9):
            seg = np.stack([poses[7, :3, 3], poses[f, :3, 3]])
            ax.plot(seg[:, 0], seg[:, 1], seg[:, 2], "-", color=color,
                    alpha=alpha, lw=lw)

    for poses in poses_all[:-1]:
        skeleton(poses, "tab:green", alpha=0.25, lw=1.0)
    skeleton(poses_all[-1], "tab:blue")

    for o in objects:
        pts = o.points if o.points is not None else \
            np.random.default_rng(0).normal(scale=0.03, size=(100, 3))
        w = pts @ o.pose_mat[:3, :3].T + o.pose_mat[:3, 3]
        color = "tab:red" if getattr(o, "target", False) else "0.5"
        ax.scatter(w[:, 0], w[:, 1], w[:, 2], s=2, c=color, alpha=0.5)

    if collision_pts is not None:
        cp = collision_pts.reshape(-1, 3)
        if potentials is not None:
            c = potentials.reshape(-1)
            ax.scatter(cp[:, 0], cp[:, 1], cp[:, 2], s=6, c=c, cmap="plasma")
        else:
            ax.scatter(cp[:, 0], cp[:, 1], cp[:, 2], s=6, c="tab:orange")
        if grads is not None:
            g = grads.reshape(-1, 3)
            ax.quiver(cp[:, 0], cp[:, 1], cp[:, 2],
                      -g[:, 0], -g[:, 1], -g[:, 2],
                      length=0.05, normalize=True, color="c", alpha=0.6)

    ax.set_xlim(-0.2, 1.0)
    ax.set_ylim(-0.6, 0.6)
    ax.set_zlim(0.0, 1.2)
    ax.view_init(elev=elev, azim=azim)
    ax.set_axis_off()
    fig.tight_layout(pad=0)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img


def render_trajectory(model, objects, traj: np.ndarray, every: int = 1,
                      **kw) -> list[np.ndarray]:
    """Frames for a trajectory playback (``fast_debug_vis`` simple mode)."""
    return [render_frame(model, objects, traj[i], **kw)
            for i in range(0, len(traj), every)]


def collision_probe(scene, q):
    """The collision overlay of configuration ``q [9]`` on ``scene`` (a
    PlanningScene), on the scene's device: ``(x [L, P, 3] collision points,
    pot [L * P] potentials, grad [L * P, 3] world-frame gradients)``."""
    from ..models import api as model_api
    from ..ops.sdf import sdf_potentials

    params = scene.env.cost_params()
    qq = torch.as_tensor(np.asarray(q, np.float32), device=scene.device)
    poses = model_api.fk_one(scene.model, qq)
    x = model_api.point_positions(scene.model, poses)
    pot, grad, _ = sdf_potentials(
        scene.env.scene_sdf(), params.inv_poses, x.reshape(-1, 3),
        params.epsilons, params.padding_scales, params.clearances,
        params.disables)
    return x, pot, grad


def render_trajectory_collision(model, scene, traj: np.ndarray,
                                every: int = 2, **kw) -> list[np.ndarray]:
    """Frames with per-configuration collision-point overlays (potentials
    + gradient quivers) — ``fast_debug_vis`` collision mode
    (reference ``omg/core.py:561-630``).  ``scene`` is a PlanningScene."""
    frames = []
    for i in range(0, len(traj), every):
        x, pot, grad = (a.cpu().numpy()
                        for a in collision_probe(scene, traj[i]))
        frames.append(render_frame(
            model, scene.env.objects, traj[i],
            collision_pts=x.reshape(-1, 3), potentials=pot, grads=grad,
            **kw))
    return frames


def _quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    w, x, y, z = [float(v) for v in q]
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def render_execution(model, objects, target_idx: int, configs: np.ndarray,
                     xs: np.ndarray, quats: np.ndarray,
                     com: np.ndarray | None = None,
                     every: int = 20, **kw) -> list[np.ndarray]:
    """Frames of a physics-execution replay: the robot's substep config
    with the dynamic target at its simulated pose (the role of the
    reference's recorded PyBullet executions, ``panda_scene.py`` with
    ``egl``/video on).  ``xs [T, 3]`` / ``quats [T, 4]`` are the rollout
    trace's COM poses; ``com`` is the body's COM offset in its own frame
    (``RigidBodySpec.com``) so the rendered cloud sits at the true
    object pose.  Restores the target's pose afterwards."""
    t = objects[target_idx]
    old_pose = t.pose_mat.copy()
    com = np.zeros(3) if com is None else np.asarray(com)
    frames = []
    try:
        for i in range(0, len(xs), every):
            r = _quat_to_mat_np(quats[i])
            pose = np.eye(4)
            pose[:3, :3] = r
            pose[:3, 3] = np.asarray(xs[i]) - r @ com
            t.update_pose(pose)
            frames.append(render_frame(model, objects, configs[i], **kw))
    finally:
        t.update_pose(old_pose)
    return frames


def write_video(frames, path: str, fps: int = 10):
    """MJPG video via cv2 if present, else an .npz frame dump
    (reference ``make_video_writer``, ``omg/config.py:190-196``)."""
    try:
        import cv2
        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"MJPG"), fps,
                             (w, h))
        for f in frames:
            vw.write(f[..., ::-1])
        vw.release()
    except Exception:
        np.savez_compressed(path + ".npz", frames=np.stack(frames))


def render_grasps(model, obj, grasp_poses_obj: np.ndarray, max_grasps=30,
                  size=(640, 480)) -> np.ndarray:
    """Grasp-database viewer (reference ``real_world/vis_grasp.py``): draw
    gripper wireframes over the object's points."""
    plt = _require_mpl()
    fig = plt.figure(figsize=(size[0] / 100, size[1] / 100), dpi=100)
    ax = fig.add_subplot(111, projection="3d")
    # gripper wireframe anchor points (reference omg/util.py:308-320)
    anchors = np.array([
        [0, 0, 0], [0, 0, 0.058], [0, -0.043, 0.058], [0, 0.043, 0.058],
        [0, -0.043, 0.098], [0, 0.043, 0.098]])
    lines = [(0, 1), (1, 2), (1, 3), (2, 4), (3, 5)]
    if obj is not None and obj.points is not None:
        ax.scatter(obj.points[:, 0], obj.points[:, 1], obj.points[:, 2],
                   s=2, c="0.4")
    for pose in grasp_poses_obj[:max_grasps]:
        w = anchors @ pose[:3, :3].T + pose[:3, 3]
        for a, b in lines:
            ax.plot(*np.stack([w[a], w[b]]).T, "-", color="tab:green",
                    lw=1, alpha=0.7)
    ax.set_box_aspect([1, 1, 1])
    lim = 0.2
    ax.set_xlim(-lim, lim); ax.set_ylim(-lim, lim); ax.set_zlim(-lim, lim)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img
