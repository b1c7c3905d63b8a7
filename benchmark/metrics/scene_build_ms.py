"""Scene construction per fresh request: the service's ``_build_scene``
(primitives, grasp databases) and the collision scene's staging on the
device (``Env.stage_scene``: the analytic arrays, or the voxel volumes
with their gradient channels), spans closed on a device synchronise."""


def read(run):
    n = len(run.requests)
    if not n:
        return None
    return (run.span_sum("scene_build") + run.span_sum("scene_stage")) \
        * 1e3 / n
