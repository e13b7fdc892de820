"""Tests of the port's benchmark harness, run from the repository root:

    python -m pytest benchmark/tests -q

They import neither JAX nor the JAX package. The `cuda` tests run the
benchmark's entry on a card (`-m cuda`) and skip without one."""

import pathlib
import sys

import pytest

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); skipped without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the port on the card")
    return torch.device("cuda")
