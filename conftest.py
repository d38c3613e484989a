"""Keep each test process below the kernel's limit on memory maps.

XLA:CPU maps the code and data of every program it compiles into the
process, a few maps per program, and keeps them while JAX's in-memory
caches hold the executable.  The suite compiles thousands of programs
(shape buckets x capacities x metrics), so one pytest process -- a serial
run, or an xdist worker that draws a run of build-heavy tests -- reaches
the kernel's ``vm.max_map_count`` (65,530 by default) and dies inside XLA
with a segmentation fault or an abort in compile, serialize or
deserialize, failing whichever test it was running.

After each test this hook counts the process's maps and, past half the
limit, drops JAX's in-memory caches so those executables are freed.  No
result changes: a program is compiled again, or read back from the
persistent cache, on its next call.  A process that has not loaded jax,
or a platform without ``/proc``, is left alone; nothing here imports jax.
"""

import gc
import sys

import pytest


def _max_map_count() -> int:
    try:
        with open("/proc/sys/vm/max_map_count") as f:
            return int(f.read())
    except (OSError, ValueError):
        return 0


_LIMIT = _max_map_count()


def _maps_in_use() -> int:
    with open("/proc/self/maps") as f:
        return sum(1 for _ in f)


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    jax = sys.modules.get("jax")
    if jax is None or not _LIMIT:
        return
    if _maps_in_use() > _LIMIT // 2:
        jax.clear_caches()
        gc.collect()
