"""Repository-wide pytest hooks for runs under pytest-xdist (`-n`).

1. Build the JAX package's native library once, before the workers
   start.  Every worker's session fixture `native_lib`
   (`tests/conftest.py`) runs `make -s` in `av1dec_tpu/native`.  On a
   tree without `build/`, the workers' makes all write the same objects
   and library in place at once, and a worker can link or load a
   half-written file (an `undefined symbol` error at load).  Built here
   first, in the controller only, the library is up to date when the
   workers start, and their makes write nothing.
2. Spread and start first the tests that take minutes each.  With
   `--dist loadfile` each file runs on one worker, and xdist starts the
   files with the most tests first.  `tests/test_sharded.py` has 4
   tests, two of which take about 690 s each on an 8-core machine
   (sharded JAX decodes); as one work unit started last, the file runs
   past the suite's time limit.  Its tests are therefore work units of
   their own, at the head of the queue: the workers order the files
   with those first (the other files by their number of tests, as xdist
   would), and the controller keeps that order.
3. Give each worker's torch one intra-op thread.  Each torch process
   otherwise starts a thread a core, so n workers run n x cores threads
   on the cores, and every parallel torch op waits for its slowest
   thread: the four MC and B7 test files took 135-147 s of summed test
   time in 4 workers, 86 s with one thread a worker.

A run without `-n` (or with `-n 0`) is left as it is.
"""
import os
import subprocess

import pytest

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "av1dec_tpu", "native")
# files whose tests each take minutes: one work unit per test, first
_SLOW_FILES = ("tests/test_sharded.py",)


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        # an xdist worker: the controller has built the library
        import torch
        torch.set_num_threads(1)
        return
    if not getattr(config.option, "numprocesses", None):
        return  # one process: the fixture builds it
    config.option.loadscopereorder = False  # keep the workers' order
    # a failed build is left to the fixture, which reports it in the
    # tests that need the library
    subprocess.run(["make", "-s", f"-j{os.cpu_count() or 1}"], cwd=_NATIVE,
                   check=False)


def pytest_collection_modifyitems(config, items):
    if not hasattr(config, "workerinput"):
        return
    files = {}
    for item in items:
        files.setdefault(item.nodeid.split("::")[0], []).append(item)
    order = sorted(files, key=lambda f: (f not in _SLOW_FILES,
                                         -len(files[f])))
    items[:] = [item for f in order for item in files[f]]


@pytest.hookimpl(optionalhook=True)
def pytest_xdist_make_scheduler(config, log):
    if config.getvalue("dist") != "loadfile":
        return None
    from xdist.scheduler import LoadFileScheduling

    class Scheduling(LoadFileScheduling):
        def _split_scope(self, nodeid):
            scope = super()._split_scope(nodeid)
            return nodeid if scope in _SLOW_FILES else scope

    return Scheduling(config, log)
