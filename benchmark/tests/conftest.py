"""The benchmark's tests: on the CPU at small shapes through the port's
plain versions, and (marked `cuda`) on the card.

    python -m pytest benchmark/tests -q            # here
    python -m pytest benchmark/tests -q -m cuda    # on the card
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]

# Small shapes for CPU runs of a cell: per level envs, a 64x40 frame and
# two warm-up agent steps.
SMALL = {"envs_per_level": 4, "width": 64, "height": 40, "warmup_steps": 2}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips elsewhere); run with -m cuda")


@pytest.fixture
def card():
    """Skip unless torch sees a CUDA card (decided inside the test)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
