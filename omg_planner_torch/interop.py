"""Carry the JAX package's containers into the port's.

The JAX containers arrive with numpy leaves (for example
``jax.tree.map(np.asarray, x)`` on the caller's side); fields are matched
by name, so any object with the right attributes converts.  Nothing here
imports JAX.  The tests use this to give both packages the same inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.panda import PandaModel
from .ops.chomp import CostParams, GoalSet
from .ops.sdf import (AnalyticScene, BakedSceneSDF, SceneSDF, WorldField,
                      WorldPotential)
from .parallel.batch import PipelineInput
from .physics.rigid import BodyState, PhysParams, RigidBodySpec, StaticWorld
from .planner.plan import PlanProblem


def to_tensor(a, device) -> torch.Tensor | None:
    """numpy (or scalar, or tensor) -> tensor on ``device``; floats become
    float32, integer and bool arrays keep their type; None stays None."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.array(a)  # a writable copy
    if a.dtype.kind == "f":
        a = a.astype(np.float32)
    return torch.as_tensor(a, device=device)


def convert(x, cls, device):
    """``cls`` built from the same-named fields of ``x``."""
    return cls(**{f: to_tensor(getattr(x, f), device) for f in cls._fields})


def panda_model(x, device) -> PandaModel:
    return convert(x, PandaModel, device)


def cost_params(x, device) -> CostParams:
    return convert(x, CostParams, device)


def goal_set(x, device) -> GoalSet:
    return convert(x, GoalSet, device)


def world_potential(x, device) -> WorldPotential:
    return convert(x, WorldPotential, device)


def world_field(x, device) -> WorldField:
    return convert(x, WorldField, device)


def scene(x, device):
    """AnalyticScene, BakedSceneSDF or SceneSDF, told apart by fields."""
    for cls in (AnalyticScene, BakedSceneSDF, SceneSDF):
        if all(hasattr(x, f) for f in cls._fields):
            return convert(x, cls, device)
    raise TypeError(f"not a scene container: {type(x).__name__}")


def plan_problem(x, device) -> PlanProblem:
    """PlanProblem with every nested container converted, the fused world
    field included when present."""
    wf = getattr(x, "world_field", None)
    return PlanProblem(
        start=to_tensor(x.start, device), end=to_tensor(x.end, device),
        traj_init=to_tensor(x.traj_init, device),
        goal_set=goal_set(x.goal_set, device), scene=scene(x.scene, device),
        cost_params=cost_params(x.cost_params, device),
        joint_lower=to_tensor(x.joint_lower, device),
        joint_upper=to_tensor(x.joint_upper, device),
        world_potential=world_potential(x.world_potential, device),
        world_field=None if wf is None else world_field(wf, device))


def phys_params(x, device) -> PhysParams:
    return convert(x, PhysParams, device)


def rigid_body_spec(x, device) -> RigidBodySpec:
    return convert(x, RigidBodySpec, device)


def static_world(x, device) -> StaticWorld:
    """StaticWorld, the optional grid colliders (None) included."""
    return StaticWorld(**{f: to_tensor(getattr(x, f, None), device)
                          for f in StaticWorld._fields})


def body_state(x, device) -> BodyState:
    return convert(x, BodyState, device)


def pipeline_input(x, seed: int, device) -> PipelineInput:
    """The port's ``PipelineInput`` from the pieces of JAX's (``problem``,
    ``grasps_world``, ``grasp_valid``, ``obj_pos``).  JAX's ``key`` is not
    carried: the goal set's Gumbel draws come from the port's own
    generator, made from ``seed``."""
    return PipelineInput(
        problem=plan_problem(x.problem, device),
        grasps_world=to_tensor(x.grasps_world, device),
        grasp_valid=to_tensor(x.grasp_valid, device), seed=int(seed),
        obj_pos=to_tensor(getattr(x, "obj_pos", None), device))
