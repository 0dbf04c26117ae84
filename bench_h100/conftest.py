"""pytest settings of the benchmark's own tests (``python -m pytest
bench_h100``). Tests marked ``chip`` need an NVIDIA card and skip
elsewhere; each decides that inside itself."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def pytest_configure(config):
    config.addinivalue_line(
        'markers', 'chip: needs an NVIDIA GPU (run on the card: python -m '
        'pytest bench_h100 -m chip)')
