"""The benchmark's own tests: ``python -m pytest navbench/tests -q`` from
the repository's root. Tests marked ``cuda`` need the card and skip
without one; each decides so in its fixture, never at import."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    import torch

    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")
    # The CPU runs are small: a few threads each, so that parallel test
    # workers do not starve one another's timed windows.
    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the benchmark's full-size runs)")
    return torch.device("cuda", 0)
