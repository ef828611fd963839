"""Tests of the benchmark itself.  Run from the repository root:

    python -m pytest perfbench/tests -q -p no:cacheprovider

Tests marked ``card`` need a CUDA card and skip without one (decided inside the ``cuda_card`` fixture, never at
import); on the card: ``python -m pytest perfbench/tests -q -m card -p no:cacheprovider``.
"""
from __future__ import annotations

import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def tiny():
    """(config, traffic) overrides that cut a ResDiff cell to a size the CPU runs in seconds (the widths are the
    tests', not the cells')."""
    return ({"image_size": 32, "inner_channel": 8, "norm_groups": 4, "num_steps": 2},
            {"batch": 2, "pool": 4, "check_requests": 2})
