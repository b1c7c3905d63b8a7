"""Task-level planning API: pick, place, move-to-configuration
(counterpart of ``omg_planner_tpu/planner/tasks.py``; reference
``real_world/trial.py:23-185``).

* :func:`plan_to_target` — grasp an object (goal-set OMG plan).
* :func:`plan_to_conf` — fixed-endpoint CHOMP between two configurations
  with a collision-disable list, as explicit config overrides.
* :func:`place_target` — attach the object to the hand, swap the hand and
  finger collision points for the object's surface points, plan to a
  z-upsampled placement goal, detach (``omg/core.py:192-234``).

The staged caches of a :class:`PlanningScene` key on ``env.version``: the
attach and the detach each bump it, so nothing staged for the attached
model outlives the placement.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import api as model_api
from .scene import PlanningScene


def attached_collision_points(model, rel_hand_pose: np.ndarray,
                              obj_points: np.ndarray) -> torch.Tensor:
    """New [10, P, 3] collision point set with the grasped object's points
    on the hand and finger links (reference
    ``Robot.resample_attached_object_collision_points``,
    ``omg/core.py:192-234``): ``rel_hand_pose`` is the object's pose in
    the ``panda_hand`` frame, ``obj_points`` [>=500, 3] its surface."""
    pts = model.collision_points.cpu().numpy()
    p = pts.shape[1]
    off = model.center_offset.cpu().numpy()
    hand_pose = np.linalg.inv(off[-3]) @ rel_hand_pose
    lf_pose = np.linalg.inv(off[-2]) @ hand_pose
    rf_pose = np.linalg.inv(off[-1]) @ hand_pose

    hand_keep = max(p // 4, 1)
    obj = np.asarray(obj_points)

    def take(seg, n):
        stride = max(len(seg) // n, 1)
        return seg[::stride][:n]

    def xform(mat, q):
        return q @ mat[:3, :3].T + mat[:3, 3]

    new = pts.copy()
    hand_obj = xform(hand_pose, take(obj[:200], p - hand_keep)[:, :3])
    new[-3] = np.concatenate([pts[-3][:hand_keep], hand_obj], axis=0)[:p]
    new[-2] = xform(lf_pose, take(obj[200:350], p)[:, :3])[:p]
    new[-1] = xform(rf_pose, take(obj[350:500], p)[:, :3])[:p]
    return torch.as_tensor(new.astype(np.float32), device=model.device)


def plan_to_target(scene: PlanningScene, start_conf: np.ndarray,
                   target_name: str, fast: bool = False):
    """Plan a grasp of ``target_name`` from ``start_conf``
    (reference ``trial.py:23-35``)."""
    scene.env.set_target(target_name)
    scene.start = np.asarray(start_conf)
    return scene.step(fast=fast)


def plan_to_conf(scene: PlanningScene, start_conf: np.ndarray,
                 end_conf: np.ndarray, disable_list=(), fast: bool = False):
    """Fixed-endpoint CHOMP between two configurations
    (reference ``trial.py:37-66``)."""
    sub = PlanningScene(
        scene.cfg.replace(goal_set_proj=False, use_standoff=False,
                          disable_collision_set=tuple(disable_list)),
        scene.env)
    sub.model = scene.model
    sub.start = np.asarray(start_conf)
    sub.end = np.asarray(end_conf)
    return sub.step(fast=fast)


def place_target(scene: PlanningScene, grasp_conf: np.ndarray,
                 place_pose: np.ndarray, target_name: str | None = None,
                 apply_standoff: bool = False, fast: bool = False):
    """Plan a placement with the target attached to the hand
    (reference ``trial.py:68-185``).

    ``grasp_conf``: configuration at which the object is held;
    ``place_pose``: the object's desired world pose [4, 4] after placing.
    Returns (result, achieved object pose) and leaves the scene detached
    with the target at its achieved pose.  The held object's own collision
    is disabled (its points ride the hand instead) and the standoff tail
    is off unless ``apply_standoff`` (``trial.py:83``).  When no placement
    IK exists the result is None and the scene is rolled back: pose,
    attachment, cfg and hand points (``trial.py:123-131``)."""
    if target_name is not None:
        scene.env.set_target(target_name)
    t = scene.env.target
    base_cfg = scene.cfg
    scene.cfg = base_cfg.replace(
        disable_collision_set=tuple(base_cfg.disable_collision_set)
        + (t.name,),
        use_standoff=apply_standoff)

    # attach: record the pose relative to the hand at the grasp
    scene.attach_target(np.asarray(grasp_conf))
    base_points = scene.model.collision_points
    if t.points is not None:
        scene.model = scene.model._replace(
            collision_points=attached_collision_points(
                scene.model, t.rel_hand_pose, t.points))

    # move the attached target to the placement pose; the goal set is the
    # inverse relative hand pose, z-upsampled (planner.py:496-498)
    old_pose = t.pose_mat.copy()
    t.update_pose(np.asarray(place_pose))
    scene.env._scene_sdf = None
    scene.start = np.asarray(grasp_conf)

    try:
        result = scene.step(fast=fast)
    finally:
        scene.model = scene.model._replace(collision_points=base_points)
        scene.cfg = base_cfg

    if result is None:
        # no placement IK: roll the object back (the reference's only
        # failure path; it does not gate on the verdict, since the start
        # holds the object in contact with its support)
        t.update_pose(old_pose)
        scene.detach_target()
        return result, old_pose

    hand = model_api.tip_pose(
        scene.model, torch.as_tensor(np.asarray(result.traj[-1], np.float32),
                                     device=scene.device))
    achieved = hand.cpu().numpy() @ t.rel_hand_pose
    scene.detach_target()
    t.update_pose(achieved)
    scene.env._scene_sdf = None
    return result, achieved
