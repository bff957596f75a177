"""A pytest plugin that keeps the parallel test run within the host's memory
and clear of an order dependency among the JAX package's tests.

The run spreads tests over several worker processes.  A few tests of the
JAX package run interpret-mode Pallas kernels that peak at 11-34 GB of
RSS each (listed in HEAVY).  Two of them side by side, with the other
workers' own few GB, exhaust a 64 GB host, and the kernel's OOM killer
then ends the largest worker mid-test.  So:

- a HEAVY test runs only while it holds an exclusive `flock` on this
  file: at most one of them runs at a time across the workers, while the
  other tests run on;
- after the last case of a HEAVY test, `jax.clear_caches()` drops the
  traced and compiled programs it left (about 6 GB; its other cases reuse
  them, and recompiling costs 190 s a case), and after every test
  `malloc_trim(0)` returns the freed heap to the system;
- the HEAVY tests come first in the collection, so that their serial
  lane, most of the run's wall time, starts at once.

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
    "test_block_madd_scan2_bitexact",  # 30-34 GB (BLS12_381), 13 GB (BN128)
    "test_msm_pallas_bucket_path",     # 19 GB
    "test_block_madd_scan_bitexact",   # 11 GB
}
LAST_MODULE = "test_parallel.py"

try:
    _malloc_trim = ctypes.CDLL(ctypes.util.find_library("c")).malloc_trim
except (OSError, AttributeError, TypeError):   # no glibc
    _malloc_trim = None


def is_heavy(item):
    return getattr(item, "originalname", None) in HEAVY


def pytest_collection_modifyitems(items):
    items.sort(key=lambda item: 0 if is_heavy(item) else
               2 if item.path.name == LAST_MODULE else 1)       # stable


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
