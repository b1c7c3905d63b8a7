"""``goal_set_build_ms`` in the cells that report no median end to end:
the same reading, moving the tail, which holds every request's goal-set
build too."""

import harness

read = harness.reader("goal_set_build_ms")
