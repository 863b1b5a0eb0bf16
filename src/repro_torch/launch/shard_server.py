"""Shard-host launcher: PS / provenance shards in worker processes.

This is what moves the federations out of the front-end process (paper
§III-B2: on Summit the parameter servers and provenance DB shards run as
separate processes on separate nodes).  Each worker hosts one generic RPC
shard server (``repro_torch.net``) whose PS/provenance state is created lazily by
the federation front-end's ``configure`` call — workers need no topology
knowledge at spawn time, only a port.

Three ways to get endpoints:

  * :class:`ShardServerPool` — N worker *processes* on this host (the
    GIL-escaping path; ``multiprocessing`` spawn context so workers never
    inherit the parent's torch/CUDA/threads state), used by benchmarks and tests.
  * :class:`LocalShardHost` — N servers on threads *in this process*: the
    full wire path without process-spawn cost.  Useful for fast equivalence
    tests; useless for shard scaling (still one GIL).
  * the CLI — ``python -m repro_torch.launch.shard_server --shards 4`` on each
    host; it spawns the worker processes, prints the comma-separated
    ``host:port,...`` endpoint list, then serves until killed.  Point
    ``--shard-endpoints`` of ``repro_torch.launch.train`` (or any federation's
    ``endpoints=``) at the union of the printed endpoints.

Endpoint strings are ``host:port``; :func:`parse_endpoints` converts the
comma-separated flag form, and ``spawn:N`` asks the driver to spawn a local
pool instead (dev/single-host convenience).
"""
from __future__ import annotations

import argparse
import multiprocessing
import sys
import threading
import time
from typing import List, Optional, Sequence, Tuple

from repro_torch.net.server import RPCServer
from repro_torch.net.shards import build_shard_table
from repro_torch.telemetry import registry as telemetry

Endpoint = Tuple[str, int]


def parse_endpoints(spec: str) -> List[Endpoint]:
    """``"host:port,host:port,..."`` → [(host, port), ...]."""
    out: List[Endpoint] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad endpoint {part!r} (want host:port)")
        out.append((host, int(port)))
    if not out:
        raise ValueError(f"no endpoints in {spec!r}")
    return out


def format_endpoints(endpoints: Sequence[Endpoint]) -> str:
    return ",".join(f"{h}:{p}" for h, p in endpoints)


def _worker_main(kind: str, host: str, port: int, conn) -> None:
    """Worker-process body: build one shard server, report its endpoint,
    serve until killed.  Kept import-light (numpy only — no torch) so spawned
    workers start fast and never trip accelerator probing."""
    server = RPCServer(build_shard_table(kind), host=host, port=port)
    server.start()
    conn.send(server.endpoint)
    conn.close()
    server.serve_forever()


class ShardServerPool:
    """N shard-host worker processes on this machine; context-manageable.

    With ``supervise=True`` a daemon thread watches the workers and
    respawns any that die on the *same* recorded endpoint (the listener
    sets SO_REUSEADDR, so the port rebinds immediately).  The respawned
    worker comes up blank — it is the federation front-end's recovery
    reconfigure (``repro_torch.fault``) that replays its WAL / JSONL back to the
    pre-crash state; the supervisor only guarantees there is a live process
    at the address the stubs keep dialing.
    """

    def __init__(
        self,
        num_shards: int,
        kind: str = "both",
        host: str = "127.0.0.1",
        start_method: str = "spawn",
        spawn_timeout: float = 60.0,
        port_base: int = 0,
        supervise: bool = False,
        supervise_poll: float = 0.2,
    ):
        self._ctx = multiprocessing.get_context(start_method)
        self._kind = kind
        self._host = host
        self._spawn_timeout = spawn_timeout
        self._supervise_poll = supervise_poll
        self.procs: List[multiprocessing.Process] = []
        self.endpoints: List[Endpoint] = []
        self.restarts = 0  # supervisor respawn count (observability/tests)
        self._stopping = False
        self._lock = threading.Lock()
        self._supervisor: Optional[threading.Thread] = None
        self._m_restarts = (
            telemetry.get_registry().counter(
                "repro_fault_restarts_total",
                "Shard worker processes respawned by the pool supervisor.",
            )
            if telemetry.ENABLED
            else None
        )
        try:
            for i in range(num_shards):
                port = 0 if port_base == 0 else port_base + i
                p, ep = self._spawn_worker(port)
                self.procs.append(p)
                self.endpoints.append(ep)
        except BaseException:
            # A worker dying (or hanging) before its handshake must not
            # leak the already-spawned siblings.
            self.stop()
            raise
        if supervise:
            self._supervisor = threading.Thread(
                target=self._supervise_loop, name="shard-supervisor", daemon=True
            )
            self._supervisor.start()

    def _spawn_worker(self, port: int):
        """Spawn one worker and wait for its endpoint handshake.

        Every failure path cleans up after itself: both pipe ends are
        closed and a started-but-failed process is terminated and joined —
        nothing (fd or process) outlives the exception."""
        parent, child = self._ctx.Pipe()
        p: Optional[multiprocessing.Process] = None
        try:
            p = self._ctx.Process(
                target=_worker_main,
                args=(self._kind, self._host, port, child),
                daemon=True,
            )
            p.start()
            child.close()
            child = None
            if not parent.poll(self._spawn_timeout):
                raise RuntimeError(
                    f"shard worker did not report an endpoint within "
                    f"{self._spawn_timeout}s"
                )
            try:
                endpoint = parent.recv()
            except EOFError:
                raise RuntimeError(
                    f"shard worker died during startup (exitcode {p.exitcode})"
                ) from None
            return p, endpoint
        except BaseException:
            if p is not None and p.is_alive():
                p.terminate()
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
            raise
        finally:
            if child is not None:
                child.close()
            parent.close()

    # ------------------------------------------------------------ supervisor
    def _stop_requested(self) -> bool:
        with self._lock:
            return self._stopping

    def _supervise_loop(self) -> None:
        while not self._stop_requested():
            time.sleep(self._supervise_poll)
            with self._lock:
                procs = list(self.procs)
            for i, p in enumerate(procs):
                if self._stop_requested():
                    return
                if p.is_alive():
                    continue
                host, port = self.endpoints[i]
                try:
                    newp, _ep = self._spawn_worker(port)
                except BaseException:
                    continue  # port still settling / spawn failed: next poll
                with self._lock:
                    if self._stopping:
                        # stop() won the race: the pool no longer owns slots.
                        newp.terminate()
                        newp.join(timeout=10)
                        return
                    self.procs[i] = newp
                    self.restarts += 1
                if self._m_restarts is not None:
                    self._m_restarts.inc()

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
        sup = self._supervisor
        if sup is not None:
            # Bounded by one poll + one spawn handshake.
            sup.join(timeout=self._spawn_timeout + 5)
            self._supervisor = None
        with self._lock:
            procs, self.procs = self.procs, []
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                # SIGTERM ignored or worker wedged: escalate so nothing
                # outlives the pool.
                p.kill()
                p.join(timeout=10)
        for p in procs:
            if not p.is_alive():
                p.close()  # release the Process sentinel fd (-X dev clean)

    def __enter__(self) -> "ShardServerPool":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


class LocalShardHost:
    """N shard servers on threads in this process (tests/debug only)."""

    def __init__(
        self,
        num_shards: int,
        kind: str = "both",
        host: str = "127.0.0.1",
    ):
        self.servers = [
            RPCServer(build_shard_table(kind), host=host).start()
            for _ in range(num_shards)
        ]
        self.endpoints: List[Endpoint] = [s.endpoint for s in self.servers]

    def stop(self) -> None:
        for s in self.servers:
            s.stop()

    def __enter__(self) -> "LocalShardHost":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()


def resolve_endpoints(
    spec: Optional[str], kind: str = "both", supervise: bool = False
) -> Tuple[Optional[List[Endpoint]], Optional[ShardServerPool]]:
    """Resolve a ``--shard-endpoints`` flag value.

    ``"host:port,..."`` → (endpoints, None); ``"spawn:N"`` → a fresh local
    :class:`ShardServerPool` the caller must ``stop()`` (supervised when
    ``supervise``); ``None`` → (None, None).
    """
    if spec is None:
        return None, None
    if spec.startswith("spawn:"):
        pool = ShardServerPool(
            int(spec.split(":", 1)[1]), kind=kind, supervise=supervise
        )
        return pool.endpoints, pool
    return parse_endpoints(spec), None


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shards", type=int, default=1, help="shard servers to host")
    ap.add_argument("--kind", choices=("ps", "prov", "both"), default="both")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument(
        "--port-base", type=int, default=0,
        help="first port (consecutive ports for the rest); 0 = OS-assigned",
    )
    ap.add_argument(
        "--supervise", action="store_true",
        help="respawn dead workers on their recorded endpoints",
    )
    args = ap.parse_args(argv)
    pool = ShardServerPool(
        args.shards, kind=args.kind, host=args.host, port_base=args.port_base,
        supervise=args.supervise,
    )
    print(format_endpoints(pool.endpoints), flush=True)
    try:
        if args.supervise:
            while True:  # workers may be respawned; sleep instead of join
                time.sleep(60)
        else:
            for p in pool.procs:  # serve until killed
                p.join()
    except KeyboardInterrupt:
        pass
    finally:
        pool.stop()


if __name__ == "__main__":
    main(sys.argv[1:])
