"""A module fixture that hands a test worker's host memory back at the end
of each of the port's test modules.

An xdist worker keeps what its tests built until it exits: the graphs JAX
compiled (for the reference's side of the port's tests, and for whatever
reference tests ran in the worker before) and the heap glibc freed but
kept.  The port's modules (`tests/test_torch_*.py`) come last in the
collection, so the workers that run them go idle first and then wait,
with all of that, for the slowest reference files.  Measured in one
process after `test_schur.py` + `test_torch_structured.py` and after
`test_pallas.py`: the worker held 3.1 and 3.9 GB; `jax.clear_caches()`
with `malloc_trim` took it to 0.53-0.55 GB, while `malloc_trim` alone
left 3.05 GB and `jax.clear_caches()` alone 3.1 GB.  A later module
compiles again what it needs.

Import it into a test module (`from tests._host_memory import
release_host_memory`); it is autouse, so nothing else is needed.
"""

import ctypes
import ctypes.util
import gc

import jax
import pytest


def _malloc_trim():
    name = ctypes.util.find_library("c")
    trim = getattr(ctypes.CDLL(name), "malloc_trim", None) if name else None
    if trim is not None:        # glibc only
        trim(0)


@pytest.fixture(scope="module", autouse=True)
def release_host_memory():
    yield
    jax.clear_caches()
    gc.collect()
    _malloc_trim()
