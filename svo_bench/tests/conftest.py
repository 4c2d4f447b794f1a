"""Settings of the benchmark's own tests (``python -m pytest
svo_bench/tests``): the card marker, and the small cells' data."""

import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (skips here with a reason)")
