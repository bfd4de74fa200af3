"""Results that the tests of one module need in every pytest-xdist worker
that draws one of them, computed once per test run.

`shared` takes named tasks. Outside xdist it runs them. Under xdist each
result lives in a pickle in the run's shared temporary directory, guarded
by a file lock: a worker first takes every task that no other worker
holds, one after another, and only then waits for the tasks others hold.
So workers that draw the module's tests at the same time split its work
(one the reference encodes, another the port's encodes) instead of all
but one waiting idle behind the first, and none repeats a task.
"""

from __future__ import annotations

import ctypes
import gc
import os
import pickle
import sys

import pytest


def release() -> None:
    """Give back what finished reference work holds: JAX's compiled
    functions (the persistent compile cache reloads them when needed),
    Python's garbage and the C heap's free pages. A pytest-xdist worker
    lives through the whole run, and without this it keeps every earlier
    module's executables."""
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
    gc.collect()
    try:
        ctypes.CDLL("libc.so.6").malloc_trim(0)
    except (OSError, AttributeError):      # not glibc
        pass


@pytest.fixture(scope="module", autouse=True)
def release_after_module():
    """Imported by each of the port's test modules: `release` before the
    module's tests start and once they are done. A worker may come to the
    module holding gigabytes of JAX executables from the JAX package's
    tests, which do not release (about 9.8 GB after
    tests/test_rc_bounds.py's two-pass test, 0.6 GB once released)."""
    release()
    yield
    release()


def shared(tmp_path_factory, tasks: dict) -> dict:
    """{name: fn} -> {name: fn()}, each fn run once per test run. The
    names must be unique across the test suite; the results picklable."""
    if os.environ.get("PYTEST_XDIST_WORKER") is None:
        out = {name: fn() for name, fn in tasks.items()}
        release()
        return out
    from filelock import FileLock, Timeout
    root = tmp_path_factory.getbasetemp().parent
    out = {}

    def run(name, lock):
        path = root / f"{name}.pkl"
        with lock:
            if not path.is_file():
                tmp = path.with_suffix(".tmp")
                tmp.write_bytes(pickle.dumps(tasks[name]()))
                tmp.rename(path)
                release()
            out[name] = pickle.loads(path.read_bytes())

    locks = {name: FileLock(str(root / f"{name}.pkl.lock"))
             for name in tasks}
    waiting = []
    for name, lock in locks.items():
        try:
            lock.acquire(timeout=0)
        except Timeout:
            waiting.append(name)
            continue
        try:
            run(name, lock)
        finally:
            lock.release()
    for name in waiting:
        run(name, locks[name])
    return out
