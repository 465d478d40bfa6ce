"""The harness's own tests: `python -m pytest benchmark/tests -q` from the
repo root.  They run on the CPU; a test that needs a card is marked `gpu`
and skips without one."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [p for p in (BENCH, ROOT) if p not in sys.path]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on hosts without one")
