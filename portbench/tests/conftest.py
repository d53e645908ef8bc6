"""The benchmark's own tests: ``python -m pytest -q portbench/tests -p no:cacheprovider``
on the CPU; the tests marked ``chip`` need a CUDA card and skip without one
(``python -m pytest -q portbench/tests -m chip`` on an H100)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips on the CPU)")


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
