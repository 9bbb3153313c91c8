"""The benchmark's own tests: on the CPU at HPCG's smallest grid, 16³.

Run from the repository's root: ``python -m pytest portbench/tests -q``.
Tests marked ``cuda`` need a card and skip without one (decided inside a
fixture, never at import).
"""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

GRID = 16


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def small(config: dict) -> dict:
    """A configuration at the 16³ grid, everything else as stated."""
    return dict(config, nx=GRID, ny=GRID, nz=GRID)


def quick(traffic: dict) -> dict:
    """A traffic mix whose warm-up, if it has one, lasts 0.1 s."""
    if "warm_seconds" in traffic:
        return dict(traffic, warm_seconds=0.1)
    return traffic
