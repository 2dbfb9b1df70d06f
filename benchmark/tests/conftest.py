"""The benchmark's own tests: the harness, the reference and the bounds on
the CPU at small sizes; tests marked `cuda` run only on the card
(`python -m pytest benchmark/tests -m cuda` there) and skip elsewhere."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    """The card's device, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the benchmark's card tests)")
    return torch.device("cuda")
