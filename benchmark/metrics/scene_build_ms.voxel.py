"""``scene_build_ms`` in the cells that report no median end to end:
the same reading, moving the tail, which holds every request's scene
build too."""

import harness

read = harness.reader("scene_build_ms")
