"""The benchmark's CPU tests (``python -m pytest perfbench/tests -q`` from
the checkout's root).  Tests that need the card carry the ``card`` marker
and skip, inside the test, where there is none; on the card:
``python -m pytest perfbench/tests -q -m card``."""

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips without one")
