"""A pytest plugin that keeps the parallel test run within its time limit
and the host's memory, and clear of an order dependency among the JAX
package's tests.

The run spreads tests over several worker processes.  A few tests of the
JAX package (listed in HEAVY) run interpret-mode Pallas kernels for
minutes, at many GB of RSS each.  Two of them side by side, with the
other workers' own few GB, exhausted a 64 GB host, and the kernel's OOM
killer then ended the largest worker mid-test.  So:

- a HEAVY test runs only while it holds an exclusive `flock` on this
  file: at most one of them runs at a time across the workers, while the
  other tests run on;
- after the last case of a HEAVY test, `jax.clear_caches()` drops the
  traced and compiled programs it left (about 6 GB; its other cases reuse
  them, and recompiling costs 190 s a case), and after every test
  `malloc_trim(0)` returns the freed heap to the system;
- the HEAVY tests come first in the collection, so that their serial
  lane, the run's critical path, starts at once; the card's tests
  (marked `gpu`, skipped without a card) come next, so that the first
  worker's first batch of tests, which waits behind that lane, holds
  no test that runs here.

The cases in SLOW_ON_CPU are marked `slow`, so a run with `-m 'not slow'`
leaves them out; `PYTHONPATH=tests python -m pytest -p memory_guard -n 0
-m slow tests/test_pallas.py` runs them.  ROADMAP.md gives the lane's
times and memory peaks.

Each worker runs its tests in collection order.  `tests/test_parallel.py`
leaves NTT domains whose tables were made inside `shard_map` in the JAX
package's domain cache, and a later NTT test in the same process then
fails on the leaked tracer; so that module comes last.

The port's test modules load this plugin with
`pytest_plugins = ["memory_guard"]`; since every worker collects every
module, it then applies to every test of the whole run.
"""

import ctypes
import ctypes.util
import fcntl
import sys

import pytest

HEAVY = {
    "test_block_madd_scan2_bitexact",
    "test_msm_pallas_bucket_path",
    "test_block_madd_scan_bitexact",
}
# Left to a run with `-m slow`: with it the lane held the run at its time
# limit.  It checks the JAX package's Fp2 bucket kernel, in interpret
# mode, against the JAX package's own composition; [BN128] runs the same
# kernel code, and the port's version of it is held against the JAX
# package by test_torch_curve.py::test_bucket_scan2_plain_vs_jax,
# test_torch_msm.py::test_msm_g2_vs_jax and, on the card,
# test_torch_gpu.py::test_bucket_scan2_kernel_vs_plain.
SLOW_ON_CPU = {"test_block_madd_scan2_bitexact[BLS12_381]"}
LAST_MODULE = "test_parallel.py"

try:
    _malloc_trim = ctypes.CDLL(ctypes.util.find_library("c")).malloc_trim
except (OSError, AttributeError, TypeError):   # no glibc
    _malloc_trim = None


def is_heavy(item):
    return getattr(item, "originalname", None) in HEAVY


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: left out of tier-1; run with -m slow")


@pytest.hookimpl(tryfirst=True)             # before `-m` deselects
def pytest_collection_modifyitems(items):
    for item in items:
        if item.name in SLOW_ON_CPU:
            item.add_marker(pytest.mark.slow)
    items.sort(key=lambda item: 0 if is_heavy(item) else
               1 if item.get_closest_marker("gpu") else
               3 if item.path.name == LAST_MODULE else 2)       # stable


def trim_heap():
    if _malloc_trim is not None:
        _malloc_trim(0)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    if not is_heavy(item):
        yield
        trim_heap()
        return
    with open(__file__) as fh:          # closing the file drops the lock
        fcntl.flock(fh, fcntl.LOCK_EX)
        yield
        if getattr(nextitem, "originalname", None) != item.originalname:
            sys.modules["jax"].clear_caches()   # the cases share programs
        trim_heap()
