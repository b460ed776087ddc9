"""pytest settings of the benchmark's own tests (`pytest portbench/tests`).

Registers the `gpu` marker of the tests that need a CUDA card (they skip
without one, deciding inside the test), and puts `portbench/` and the
checkout's root on the import path."""
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (skips without one); run on the "
        "card with `python3 -m pytest -m gpu portbench/tests`")
