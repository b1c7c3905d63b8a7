"""omg_planner_torch: the goal-set CHOMP planner of ``omg_planner_tpu``
ported to PyTorch and hand-written CUDA kernels for NVIDIA Hopper.

The package keeps the JAX package's module layout and names, so each
counterpart sits at the same relative path.  It imports neither ``jax``
nor ``omg_planner_tpu``.

Entry points (``planner.scene.Env``/``PointEnv``/``PlanningScene`` and
``python -m omg_planner_torch``) run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU they raise instead of falling back.
"""

import torch

from .config import OMGConfig, HorizonParams  # noqa: F401

__version__ = "0.1.0"

# Full float32 everywhere: the counterpart of the JAX package forcing
# "highest" matmul precision.  TF32 keeps ~3 decimal digits, which breaks
# the ~1e-3 IK tolerances through the 7-link FK chain.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default) and
    no GPU is present — nothing falls back to the CPU silently."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "omg_planner_torch runs on cuda by default and no GPU is "
            "available; pass device='cpu' to run on the CPU")
    return dev
