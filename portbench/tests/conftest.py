"""portbench's own tests: CPU tests of the harness, and tests marked
``card`` that need an NVIDIA card and skip without one.

    python -m pytest portbench/tests -q
"""
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")
