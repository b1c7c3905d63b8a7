"""Object padding of staged problems (counterpart of the padding helpers
of ``omg_planner_tpu/parallel/batch.py``).

Every scene of a suite pads to one object count with disabled dummy
objects, so the runner and the cascade plan every scene at one set of
shapes.  The batched and sharded plans of the JAX module are not ported.
"""

from __future__ import annotations

import torch

from ..ops.sdf import AnalyticScene, BakedSceneSDF
from ..planner.plan import PlanProblem


def _num_objects(scene) -> int:
    if isinstance(scene, AnalyticScene):
        return scene.kinds.shape[0]
    return (scene.data4 if isinstance(scene, BakedSceneSDF)
            else scene.data).shape[0]


def pad_scene(scene, num_objects: int):
    """Pad a scene's object dimension with disabled dummy objects (grid
    backends fill +1 volumes; analytic scenes add far tiny primitives)."""
    extra = num_objects - _num_objects(scene)
    if extra == 0:
        return scene
    if isinstance(scene, AnalyticScene):
        def cat(a, value, shape=(extra,)):
            return torch.cat([a, torch.full(shape, value, dtype=a.dtype,
                                            device=a.device)])

        return AnalyticScene(kinds=cat(scene.kinds, 1),
                             halfs=cat(scene.halfs, 1e-3, (extra, 3)),
                             penals=cat(scene.penals, 1.0),
                             rounds=cat(scene.rounds, 0.0))
    baked = isinstance(scene, BakedSceneSDF)
    vol = scene.data4 if baked else scene.data
    if baked:
        fill = torch.zeros((extra,) + vol.shape[1:], dtype=vol.dtype,
                           device=vol.device)
        fill[..., 0] = 1.0
    else:
        fill = torch.ones((extra,) + vol.shape[1:], dtype=vol.dtype,
                          device=vol.device)
    data = torch.cat([vol, fill])
    lim = torch.cat([scene.limits, scene.limits[-1:].repeat(extra, 1)])
    return (scene._replace(data4=data, limits=lim) if baked
            else scene._replace(data=data, limits=lim))


def _pad_cost_params(cp, extra: int):
    """Disabled dummy entries for every per-object parameter array."""
    def pad1(a, v):
        return torch.cat([a, torch.full((extra,), v, dtype=a.dtype,
                                        device=a.device)])

    eye = torch.eye(4, dtype=cp.inv_poses.dtype, device=cp.inv_poses.device)
    return cp._replace(
        inv_poses=torch.cat([cp.inv_poses, eye[None].repeat(extra, 1, 1)]),
        epsilons=pad1(cp.epsilons, 0.2),
        padding_scales=pad1(cp.padding_scales, 1.0),
        clearances=pad1(cp.clearances, 0.0),
        disables=pad1(cp.disables, 1.0))


def pad_objects(problem: PlanProblem, num_objects: int) -> PlanProblem:
    """Pad a problem's object dimension with disabled dummy objects."""
    extra = num_objects - _num_objects(problem.scene)
    if extra == 0:
        return problem
    return problem._replace(
        scene=pad_scene(problem.scene, num_objects),
        cost_params=_pad_cost_params(problem.cost_params, extra))
