"""The benchmark's own tests: the harness's modules are top-level modules
of ``benchmark/`` (as ``run.py`` runs them), the program is the repo's."""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
sys.path.insert(0, os.path.dirname(HERE))


@pytest.fixture
def card():
    """Skips a test that needs a CUDA card where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
