"""Self-tracing: the program's own spans, on the workload's clock and the profiler's.

A span records when either holds:

* self-tracing is on (``REPRO_SELF_TRACE=1`` or ``SelfTracer.set_enabled(True)``);
* a ``torch.profiler`` is recording (torch's own flag,
  ``torch.autograd.profiler._is_profiler_enabled``: true in a schedule's
  active steps, false in its wait and warm-up steps).

Instrumented regions -- the model's prefill and decode steps, the Mamba
mixer and its scan staging, the MoE layer, the serving waves, the
monitor's per-stage ingest, RPC dispatch -- record a :class:`Span`: name,
thread, its id and the id of the enclosing span on the same thread (its
parent), start and duration, and ``args``.  While a profiler records,
each span also opens ``torch.profiler.record_function(name)``, so the
program's ranges sit in the profiler's trace beside the kernels, on the
device trace's clock.

Device time: a span opened with ``timed_on=<tensor>`` that lies on CUDA,
and every span opened under it, records a CUDA event pair on that
device's current stream; the pair becomes ``device_ms`` when the spans
are read.  Counts are ``args`` held as device tensors, read at the same
time, so nothing waits on the device while the spans are recorded.

Reading: :meth:`SelfTracer.snapshot` returns the resolved spans and keeps
them; :meth:`SelfTracer.drain` returns them as ``(name, tid, t0_us, dur_us,
args)`` and clears the buffer (the monitor appends those to the live
Chrome-trace export as complete events in a process group of their own).
The buffer holds the newest :data:`MAX_SPANS` spans and counts the ones
it dropped.

Timebase: ``time.perf_counter_ns() // 1000``, deliberately the same
clock as ``repro_torch.trace.tracer.now_us`` (not imported to avoid a
package cycle -- ``trace`` imports the monitor which imports telemetry).

Off (neither condition), :meth:`SelfTracer.span` tests two flags and
returns one shared no-op context: no allocation, no lock, no profiler
call.  Inside :meth:`SelfTracer.paused` a thread's spans are off whatever
the conditions: a CUDA graph's capture keeps no span's events or device
counts.  The module imports no torch: the monitor's shard workers load
none.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["SelfTracer", "Span", "get_self_tracer", "SELF_TRACE_PID", "MAX_SPANS"]

# Chrome-trace pid for the analyzer's own process group.  Workload pids
# are small rank numbers; 1 << 20 can never collide with them.
SELF_TRACE_PID = 1 << 20
MAX_SPANS = 1 << 16  # the buffer's bound


def _now_us() -> int:
    return time.perf_counter_ns() // 1000


class _TorchNotLoaded:
    """Stands for ``torch.autograd.profiler`` until torch is loaded: no
    profiler can record before that.  The first read after torch is
    loaded binds the real module, so later reads are a plain attribute."""

    @property
    def _is_profiler_enabled(self) -> bool:
        global _profiler
        mod = sys.modules.get("torch.autograd.profiler")
        if mod is None:
            return False
        _profiler = mod
        return mod._is_profiler_enabled


_profiler: Any = _TorchNotLoaded()


class Span:
    """One recorded span.  ``parent`` is 0 at the top of a thread;
    ``device_ms`` is None where the span was host-timed only."""

    __slots__ = ("name", "tid", "id", "parent", "t0_us", "dur_us", "device_ms", "args",
                 "_events")

    def __init__(self, name: str, tid: int, id: int, parent: int, t0_us: int, dur_us: int,
                 args: Optional[dict], events=None) -> None:
        self.name, self.tid, self.id, self.parent = name, tid, id, parent
        self.t0_us, self.dur_us = t0_us, dur_us
        self.args = args
        self.device_ms: Optional[float] = None
        self._events = events

    def _resolve(self) -> None:
        """Device tensors in ``args`` to numbers, the event pair to ms."""
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self.device_ms = start.elapsed_time(end)
            self._events = None
        torch = sys.modules.get("torch")
        if self.args and torch is not None:
            for k, v in self.args.items():
                if isinstance(v, torch.Tensor):
                    self.args[k] = v.item()

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, t0_us={self.t0_us}, "
                f"dur_us={self.dur_us}, device_ms={self.device_ms}, args={self.args})")


class _NullSpan:
    """The shared context of a span site while nothing records: falsy,
    so a site computes its counts only under ``if span:``."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, et, ev, tb) -> bool:
        return False

    def __bool__(self) -> bool:
        return False

    def set(self, **args) -> None:
        pass


_NULL = _NullSpan()


class _OpenSpan:
    """A recording span, live between ``__enter__`` and ``__exit__``."""

    __slots__ = ("_tracer", "name", "args", "_timed_on", "device", "_stack", "_range",
                 "_events", "id", "parent", "t0_us")

    def __init__(self, tracer: "SelfTracer", name: str, timed_on) -> None:
        self._tracer, self.name, self._timed_on = tracer, name, timed_on
        self.args: Optional[dict] = None

    def __bool__(self) -> bool:
        return True

    def set(self, **args) -> None:
        """Attach args (numbers, or device tensors read when the spans are read)."""
        if self.args is None:
            self.args = {}
        self.args.update(args)

    def __enter__(self) -> "_OpenSpan":
        tracer = self._tracer
        self._stack = stack = tracer._stack()
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else 0
        self.id = next(tracer._ids)
        on = self._timed_on
        self.device = on.device if on is not None and on.is_cuda else \
            (up.device if up is not None else None)
        self._range = None
        if _profiler._is_profiler_enabled:
            self._range = _profiler.record_function(self.name)
            self._range.__enter__()
        self._events = None
        if self.device is not None:
            import torch

            stream = torch.cuda.current_stream(self.device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(stream)
        stack.append(self)
        self.t0_us = _now_us()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        end_us = _now_us()
        if self._events is not None:
            import torch

            self._events[1].record(torch.cuda.current_stream(self.device))
        self._stack.pop()
        if self._range is not None:
            self._range.__exit__(et, ev, tb)
        self._tracer._append(self.name, self.id, self.parent, self.t0_us,
                             end_us - self.t0_us, self.args, self._events)
        return False


class SelfTracer:
    """Thread-safe span recorder (see the module)."""

    def __init__(self, enabled: Optional[bool] = None) -> None:
        if enabled is None:
            enabled = os.environ.get("REPRO_SELF_TRACE", "0") == "1"
        self._lock = threading.Lock()
        self._enabled = bool(enabled)  # one bool: read without the lock
        self._spans: collections.deque = collections.deque(maxlen=MAX_SPANS)
        self._dropped = 0
        self._tids: Dict[int, int] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()

    def set_enabled(self, value: bool) -> None:
        self._enabled = bool(value)

    @property
    def enabled(self) -> bool:
        """Self-tracing switched on (the Chrome-trace export drains the spans)."""
        return self._enabled

    @property
    def recording(self) -> bool:
        """Whether a span opened now records: self-tracing on or a profiler
        recording, and the thread not :meth:`paused`."""
        return (self._enabled or _profiler._is_profiler_enabled) and not self._paused()

    def _paused(self) -> bool:
        return getattr(self._local, "paused", False)

    @contextlib.contextmanager
    def paused(self):
        """No span records on this thread inside, even while a profiler
        records: the region is a CUDA graph's capture, and a span would
        hold its events and counts in the graph's memory."""
        was = self._paused()
        self._local.paused = True
        try:
            yield
        finally:
            self._local.paused = was

    @property
    def dropped(self) -> int:
        """Spans the bounded buffer let go, oldest first."""
        with self._lock:
            return self._dropped

    def _stack(self) -> List[_OpenSpan]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _tid(self) -> int:
        ident = threading.get_ident()
        tid = self._tids.get(ident)
        if tid is None:
            tid = len(self._tids) + 1
            self._tids[ident] = tid
        return tid

    def _append(self, name: str, id: int, parent: int, t0_us: int, dur_us: int,
                args: Optional[dict], events=None) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(Span(name, self._tid(), id, parent, t0_us, dur_us, args,
                                    events))

    def span(self, name: str, timed_on=None):
        """A context that records the enclosed region as a span while the
        recorder is on, else the shared no-op context (falsy).  ``timed_on``:
        a tensor; where it lies on CUDA the span and every span opened
        under it are also timed on the device (see the module).  Args go
        on through the span's ``set(**args)``."""
        if not (self._enabled or _profiler._is_profiler_enabled) or self._paused():
            return _NULL
        return _OpenSpan(self, name, timed_on)

    def record(self, name: str, t0_us: int, dur_us: int,
               args: Optional[dict] = None) -> None:
        """Record a span with explicit timestamps (for callers that timed
        the region themselves), under the thread's open span."""
        if not (self._enabled or _profiler._is_profiler_enabled) or self._paused():
            return
        stack = self._stack()
        self._append(name, next(self._ids), stack[-1].id if stack else 0, t0_us, dur_us, args)

    def snapshot(self) -> List[Span]:
        """The recorded spans, resolved (device ms, counts read); the
        buffer keeps them."""
        with self._lock:
            spans = list(self._spans)
            for s in spans:
                s._resolve()
        return spans

    def drain(self) -> List[Tuple[str, int, int, int, Optional[dict]]]:
        """All recorded spans as ``(name, tid, t0_us, dur_us, args)``, the
        buffer cleared; a device-timed span carries ``device_ms`` in its args."""
        with self._lock:
            spans = list(self._spans)
            self._spans.clear()
            for s in spans:
                s._resolve()
        out = []
        for s in spans:
            args = s.args
            if s.device_ms is not None:
                args = {**(args or {}), "device_ms": s.device_ms}
            out.append((s.name, s.tid, s.t0_us, s.dur_us, args))
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._spans)


_tracer = SelfTracer()


def get_self_tracer() -> SelfTracer:
    """The process-wide self-tracer singleton."""
    return _tracer
