"""The benchmark's own tests: ``python3 -m pytest benchmark/tests`` from
the root of the checkout. Tests marked ``cuda`` need an NVIDIA card and
skip inside the test without one."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA; skips without one")
