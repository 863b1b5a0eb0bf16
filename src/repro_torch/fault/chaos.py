"""Deterministic fault injection for the shard federation.

Chaos testing is only a *test* if the chaos replays: every fault this
module injects is a pure function of a caller-provided seed, never of
wallclock or :mod:`random` state (the repro_torch.lint determinism rules applied
to the harness itself).  Three instruments:

* :class:`ChaosStream` — a splitmix64 integer stream; all "randomness"
  (which frame to drop, which shard to kill) derives from it, so a failing
  chaos run reproduces from its seed alone.
* :class:`FlakyProxy` — a TCP proxy that understands the RPC framing
  (``repro_torch.net.framing``: 20-byte ``!4sHHIQ`` headers), counts *whole
  request frames*, and at seed-chosen frame ordinals drops the connection,
  delays delivery, or truncates a frame mid-payload (the torn-write case).
  Sitting between a stub and a live worker, it exercises every recovery
  path without killing anything.
* process/file helpers — :func:`kill_process` (SIGKILL, the crash case:
  no atexit, no flush, no goodbye) and :func:`tear_tail` (chop bytes off a
  WAL/JSONL file, the torn-append case).

The proxy runs one thread per direction per connection — it is a test
instrument, not a transport; its value is that faults happen at *exact,
replayable* frame boundaries instead of whenever a scheduler felt like it.
"""
from __future__ import annotations

import os
import signal
import socket
import struct
import threading
import time
from typing import List, Optional, Tuple

from ..net.framing import HEADER, MAGIC

__all__ = ["ChaosStream", "FlakyProxy", "kill_process", "tear_tail"]


class ChaosStream:
    """splitmix64: a tiny, well-mixed, dependency-free deterministic stream.

    Same seed → same decisions, on any platform, forever.  (``random`` is
    banned here on principle: a chaos harness whose faults move between
    runs cannot reproduce the failure it found.)
    """

    _MASK = (1 << 64) - 1

    def __init__(self, seed: int):
        self._state = seed & self._MASK

    def next_u64(self) -> int:
        self._state = (self._state + 0x9E3779B97F4A7C15) & self._MASK
        z = self._state
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & self._MASK
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & self._MASK
        return z ^ (z >> 31)

    def below(self, n: int) -> int:
        """Uniform-ish int in [0, n) — ample for picking fault sites."""
        return self.next_u64() % max(int(n), 1)

    def pick(self, seq):
        return seq[self.below(len(seq))]


def kill_process(proc) -> None:
    """SIGKILL a worker (multiprocessing.Process or pid): the true crash —
    no signal handler, no atexit, no buffer flush.  Joins the corpse so
    the supervisor's ``is_alive`` poll sees it immediately."""
    pid = getattr(proc, "pid", proc)
    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        return  # already gone
    join = getattr(proc, "join", None)
    if join is not None:
        join(timeout=10)


def tear_tail(path: str, nbytes: int) -> int:
    """Chop ``nbytes`` off the end of a file (a torn append) and return the
    new size.  Models the on-disk state a crash mid-write leaves behind;
    WAL/JSONL recovery must truncate back to the last intact record."""
    size = os.path.getsize(path)
    keep = max(size - int(nbytes), 0)
    with open(path, "rb+") as f:
        f.truncate(keep)
    return keep


class FlakyProxy:
    """Frame-counting TCP proxy injecting faults at chosen frame ordinals.

    Forwards bytes between a listening socket and ``upstream``.  The
    client→server direction is parsed into RPC frames (20-byte header +
    payload) and counted across all connections; when the count reaches an
    ordinal in ``drop_at``/``delay_at``/``truncate_at`` the proxy
    respectively kills the connection before that frame, sleeps
    ``delay_s`` before forwarding it, or forwards only half the frame's
    bytes and then kills the connection (a torn write on the wire).

    Fault ordinals come from a :class:`ChaosStream` in tests, making the
    entire failure schedule a function of the seed.
    """

    def __init__(
        self,
        upstream: Tuple[str, int],
        drop_at: Tuple[int, ...] = (),
        delay_at: Tuple[int, ...] = (),
        truncate_at: Tuple[int, ...] = (),
        delay_s: float = 0.05,
        host: str = "127.0.0.1",
    ):
        self.upstream = upstream
        self.drop_at = frozenset(int(x) for x in drop_at)
        self.delay_at = frozenset(int(x) for x in delay_at)
        self.truncate_at = frozenset(int(x) for x in truncate_at)
        self.delay_s = float(delay_s)
        self.frames = 0  # client→server frames seen (all connections)
        self.faults = 0  # faults actually injected
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        self._conns: List[socket.socket] = []
        self._stopping = False
        self._lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._lsock.bind((host, 0))
        self._lsock.listen(16)
        self.endpoint: Tuple[str, int] = self._lsock.getsockname()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="flaky-proxy-accept", daemon=True
        )
        self._accept_thread.start()

    # ------------------------------------------------------------- plumbing
    def _accept_loop(self) -> None:
        while not self._stopping:
            try:
                c, _addr = self._lsock.accept()
            except OSError:
                return  # listener closed by stop()
            try:
                u = socket.create_connection(self.upstream, timeout=10)
            except OSError:
                c.close()
                continue
            c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            u.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            with self._lock:
                self._conns += [c, u]
            for target, args in (
                (self._pump_frames, (c, u)),  # client→server: fault site
                (self._pump_raw, (u, c)),  # server→client: plain relay
            ):
                t = threading.Thread(target=target, args=args, daemon=True)
                t.start()
                self._threads.append(t)

    @staticmethod
    def _close_pair(a: socket.socket, b: socket.socket) -> None:
        for s in (a, b):
            try:
                s.close()
            except OSError:
                pass

    def _pump_raw(self, src: socket.socket, dst: socket.socket) -> None:
        try:
            while True:
                data = src.recv(1 << 16)
                if not data:
                    break
                dst.sendall(data)
        except OSError:
            pass
        finally:
            self._close_pair(src, dst)

    def _recv_exact(self, src: socket.socket, n: int) -> Optional[bytes]:
        buf = bytearray()
        while len(buf) < n:
            chunk = src.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return bytes(buf)

    def _pump_frames(self, src: socket.socket, dst: socket.socket) -> None:
        """client→server relay, whole frame at a time, faults applied."""
        try:
            while True:
                header = self._recv_exact(src, HEADER.size)
                if header is None:
                    break
                magic, _mid, _kind, _rid, plen = HEADER.unpack(header)
                if magic != MAGIC:
                    # Not framing (shouldn't happen): relay and go raw.
                    dst.sendall(header)
                    self._pump_raw(src, dst)
                    return
                payload = self._recv_exact(src, plen) if plen else b""
                if payload is None:
                    break
                with self._lock:
                    n = self.frames
                    self.frames += 1
                frame = header + payload
                if n in self.drop_at:
                    with self._lock:
                        self.faults += 1
                    break  # connection dies *before* this frame arrives
                if n in self.truncate_at:
                    with self._lock:
                        self.faults += 1
                    dst.sendall(frame[: max(len(frame) // 2, 1)])
                    break  # torn mid-frame, then the connection dies
                if n in self.delay_at:
                    with self._lock:
                        self.faults += 1
                    time.sleep(self.delay_s)
                dst.sendall(frame)
        except OSError:
            pass
        finally:
            self._close_pair(src, dst)

    def stop(self) -> None:
        self._stopping = True
        try:
            self._lsock.close()
        except OSError:
            pass
        with self._lock:
            conns, self._conns = self._conns, []
        for s in conns:
            try:
                s.close()
            except OSError:
                pass
        self._accept_thread.join(timeout=10)
        for t in self._threads:
            t.join(timeout=10)

    def __enter__(self) -> "FlakyProxy":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
