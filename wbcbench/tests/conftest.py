"""The benchmark's own CPU tests (run them from the repository's root:
``python -m pytest wbcbench/tests -q -p no:cacheprovider``).  Tests marked
``gpu`` need a CUDA device and skip without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; the test skips without one")
