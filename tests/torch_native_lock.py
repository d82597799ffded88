"""Load both packages' native IO libraries before a test compares them.

The JAX package builds ``native/librtdm_io.so`` at its first use with
``make clean all`` and no lock across processes
(``rtdm_tpu/data/native_io.py``). Under ``pytest -n`` several workers
reach a first use together in a checkout without the library: one
worker's ``clean`` deletes the library another is about to load, that
worker's ``_load`` fails once, marks the attempt done (``_tried``) and
takes PIL for the rest of its life, so every JAX-side decode of a later
test in it differs from the port's native one (a run of the whole suite
under ``pytest -n 6`` failed all 16 native cases of
``test_torch_native_odder.py`` so: JAX's ``load_scaled`` tiles one row
short, the PIL rounding).

``tests/torch_native_race.py`` reproduces it on a copy of a checkout:
six processes that load together lose the JAX library in some trials,
never the port's.

``load_both`` retries JAX's load under a lock that the workers of one
run share (a file beside their base temporary directories), with
``_tried`` reset for each try, and then requires both libraries to be
available, naming the cause if one is not.
"""

import contextlib
import fcntl
import time

import pytest

from rtdm_tpu.data import native_io as jax_io

from rtdm_tpu_torch.data import native_io

TRIES = 6
WAIT_S = 2.0


def load_both(lock_dir) -> None:
    """Load the JAX package's and the port's native IO libraries, or
    raise ``AssertionError`` with the reason."""
    with contextlib.ExitStack() as stack:
        lock = stack.enter_context(open(lock_dir / "rtdm_native_io.lock",
                                        "w"))
        mp = stack.enter_context(pytest.MonkeyPatch.context())
        fcntl.flock(lock, fcntl.LOCK_EX)
        stack.callback(fcntl.flock, lock, fcntl.LOCK_UN)
        for _ in range(TRIES):
            if jax_io._lib is not None:
                break
            mp.setattr(jax_io, "_tried", False)
            if jax_io._load() is not None:
                break
            time.sleep(WAIT_S)
    assert jax_io.available(), (
        f"the JAX package's native/librtdm_io.so did not load in {TRIES} "
        "tries (a concurrent `make clean all` in native/ removes it while "
        "another process loads it); JAX would decode with PIL")
    assert native_io.available(), (
        "the port's native IO library did not build or load (its log is "
        "beside it under build/native/); the port would decode with PIL")
