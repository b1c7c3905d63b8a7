"""The observed cloud's scene build a request: the program's
``scene_build.cloud`` spans (the body's arrays, the grid's layout, the
upload, ``min_dist_grid``, the field's read back to the host, the
``PointEnv``) over its ``request`` spans; None where the program records
no such span."""

import program_spans


def read(run):
    return program_spans.ms_per(run, "scene_build.cloud", "request")
