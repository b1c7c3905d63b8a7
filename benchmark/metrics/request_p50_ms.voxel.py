"""``request_p50_ms`` of the traced run, in the cells where the median
swings too much from run to run to stand end to end (with the voxel
volumes staged a request): the same reading, moving the tail, which
holds every request's scene and goal-set build too."""

import harness

read = harness.reader("request_p50_ms")
