"""The benchmark's own tests: ``python -m pytest benchmark/tests -q`` from the
root of the repository (on the card: ``python -m pytest -m cuda
benchmark/tests -q``).  They import the port and never JAX."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (PyTorch/CUDA port); the test skips itself without one",
    )
