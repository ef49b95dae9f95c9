"""The benchmark's own tests: the harness at tiny sizes on the CPU (the
port's plain kernels), and, marked `cuda`, on the card.

    python -m pytest benchmark/tests -q            # here
    python -m pytest benchmark/tests -q -m cuda    # on the card
"""

import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
for p in (str(ROOT), str(HERE.parent), str(HERE)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")
