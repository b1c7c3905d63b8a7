"""Set-up: process start to the window (imports, the kernels' load or
build, the scene set, the warm-up requests), host clock."""


def read(run):
    return run.setup_s
