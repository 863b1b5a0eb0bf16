"""Runtime companion: thread-ownership assertions for the event-loop stack.

The static pass proves what *can't* happen by construction; this module
catches what the static pass can't see (dynamic dispatch, monkeypatching,
future refactors) by asserting at runtime that loop-owned code runs on the
loop thread and worker-offloaded code does not.

Zero-cost when disabled: hot paths guard with

    if san.ENABLED:
        san.assert_loop_thread(self)

so production pays one module-attribute load per call site. The test suite
enables it globally (``REPRO_SANITIZE=1`` in ``tests/conftest.py``), so
every event-loop test doubles as an ownership check.

The owner object just needs a ``_loop_thread`` attribute holding the
:class:`threading.Thread` that runs its selector loop (``EventLoopServer``
sets it first thing in ``_loop``). Before the loop thread exists the
assertions are no-ops — construction-time calls are legitimately on the
starting thread.
"""
from __future__ import annotations

import os
import threading

ENABLED = bool(int(os.environ.get("REPRO_SANITIZE", "0") or "0"))


class ThreadOwnershipError(AssertionError):
    """Code ran on a thread that must not execute it."""


def enable() -> None:
    global ENABLED
    ENABLED = True


def disable() -> None:
    global ENABLED
    ENABLED = False


def assert_loop_thread(owner) -> None:
    """Current thread must BE ``owner``'s event-loop thread."""
    loop = getattr(owner, "_loop_thread", None)
    if loop is None:
        return
    cur = threading.current_thread()
    if cur is not loop:
        raise ThreadOwnershipError(
            f"{type(owner).__name__}: loop-owned code ran on {cur.name!r} "
            f"(loop thread is {loop.name!r}); use _post() to cross into "
            f"the loop"
        )


def assert_worker_thread(owner) -> None:
    """Current thread must NOT be ``owner``'s event-loop thread."""
    loop = getattr(owner, "_loop_thread", None)
    if loop is None:
        return
    cur = threading.current_thread()
    if cur is loop:
        raise ThreadOwnershipError(
            f"{type(owner).__name__}: blocking/heavy code ran on the "
            f"event-loop thread {cur.name!r}; use _offload() to move it "
            f"to the worker pool"
        )
