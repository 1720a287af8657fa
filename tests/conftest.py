"""Make the shared test helpers (``_hypothesis_compat``) importable from
every test directory, including ``tests/kernels``."""
import os
import sys

sys.path.insert(0, os.path.dirname(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "h100: needs an NVIDIA H100 (compute capability 9.0); "
        "skips without one")
