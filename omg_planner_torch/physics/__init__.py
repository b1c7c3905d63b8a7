"""Rigid-body execution physics (counterpart of
``omg_planner_tpu/physics``).

The reference validates plans by executing them in PyBullet and scoring a
lift reward (``bullet/panda_scene.py:424-504``).  This package has the
same role: one dynamic rigid body (the grasp target), SDF contacts against
the analytic scene and the kinematically replayed robot, and a projected
impulse solver.  On the card a whole rollout is one launch of the
hand-written ``rigid_rollout`` kernel; on the CPU it is the plain PyTorch
loop (``rigid.rollout_plain``).

Modules:
  * :mod:`.rigid` — body and world types, contacts, the solver, the
    rollout.
  * :mod:`.executor` — plan playback, gripper close and IK lift retract
    (``bullet_execute_plan`` / ``PandaYCBEnv.retract``), placements.
  * :mod:`.dynamics`, :mod:`.panda_ctrl` — the arm's own dynamics and the
    reference's ``Panda`` robot surface.
"""

from .rigid import (BodyState, NoMassModelError, PhysParams, RigidBodySpec,
                    StaticWorld, body_spec_from_grid,
                    body_spec_from_primitive, rollout)
from .executor import (PhysExecReport, PlaceExecReport, execute_plan,
                       execute_place)

__all__ = [
    "BodyState", "NoMassModelError", "PhysParams", "RigidBodySpec",
    "StaticWorld", "body_spec_from_grid", "body_spec_from_primitive",
    "rollout", "PhysExecReport", "PlaceExecReport", "execute_plan",
    "execute_place",
]
