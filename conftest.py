"""Pytest settings shared by ``tests/`` and ``portbench/``: a time limit on
each test.

Each phase of a test (setup, call, teardown) runs under an interval timer
of ``TIME_LIMIT_S`` seconds.  When it fires, the test fails with a message
naming it and its limit.  Python runs a signal handler only between
bytecodes, so the timer cannot stop a long native call (an XLA compile, a
stuck collective); ``BACKSTOP_S`` after the limit, ``faulthandler`` then
writes every thread's traceback to the process's stderr and ends the
process, which pytest-xdist reports as a crashed worker and replaces.

Tests marked ``slow`` run without a limit: ``pytest.ini`` keeps them out
of the default run, and each is one interpret-mode compile that takes as
long as XLA-CPU takes, with no measured bound.
"""
import faulthandler
import os
import signal
import sys
from contextlib import contextmanager

import pytest

TIME_LIMIT_S = 300
BACKSTOP_S = 60

# Marked slow here rather than in its file: the padded encode through the
# interpreted Pallas mapping, 96 items at block_n 64 and 32 (five grid
# steps), ran over 750 s of XLA-CPU compile without ending.  Its ``[ref]``
# twin checks the same padding in seconds.
SLOW = (
    "tests/test_kernels.py::test_encode_device_padded_equals_unpadded[pallas]",
)

_STDERR_FD = pytest.StashKey[int]()


def pytest_configure(config):
    # Capture is suspended here, so fd 2 is the process's own stderr: the
    # backstop's traceback goes there rather than into a capture file.
    config.stash[_STDERR_FD] = os.dup(sys.stderr.fileno())


def pytest_unconfigure(config):
    os.close(config.stash[_STDERR_FD])


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)


@contextmanager
def _bounded(item, phase):
    # pytest-xdist runs tests in each worker's main thread, where a signal
    # handler may be set.
    if item.get_closest_marker("slow"):
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} ({phase}) ran past its time limit of "
                    f"{TIME_LIMIT_S} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, TIME_LIMIT_S)
    faulthandler.dump_traceback_later(TIME_LIMIT_S + BACKSTOP_S, exit=True,
                                      file=item.config.stash[_STDERR_FD])
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    with _bounded(item, "setup"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    with _bounded(item, "call"):
        return (yield)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_teardown(item, nextitem):
    with _bounded(item, "teardown"):
        return (yield)
