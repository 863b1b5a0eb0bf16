"""The port's ``repro_torch.net`` against the JAX package's (twin of
tests/test_net.py, of the socket tests of tests/test_federation.py and
tests/test_provdb_federation.py, and of tests/test_concurrency.py).

Framing fuzz, RPC semantics, failure modes, loud degradation and the
event-loop server under load run on the port's copies; the PS and
provenance federations over sockets bit-match their local twins; the
thread-ownership sanitizer guards the port's server.  The wire format is
shared: the same message encodes to the same bytes in both framing
modules, and either package's client talks to the other's shard server.
"""
import concurrent.futures
import json
import socket
import sys
import threading
import time

import numpy as np
import pytest

from repro_torch.core import stats as S
from repro_torch.core.ad import ADFrameResult, OnNodeAD
from repro_torch.core.callstack import CallStackBuilder
from repro_torch.core.events import ENTRY, EXIT, Frame, empty_comm_events, make_func_events
from repro_torch.core.provenance import FederatedProvenanceDB, shard_paths
from repro_torch.core.ps import AnomalyFeed, FederatedPS
from repro_torch.core.sim import WorkloadGenerator, nwchem_like
from repro_torch.core.stats import StatsTable
from repro_torch.net import (
    CallTimeout,
    ConnectionLost,
    FrameDecoder,
    FramingError,
    MethodTable,
    RemoteError,
    RPCClient,
    RPCServer,
    TruncatedStream,
    encode_frame,
)
from repro_torch.net.framing import (
    METHOD_RESOLVE,
    REQUEST,
    HEADER,
    MAGIC,
    iter_frames,
    pack_payload,
)
from repro_torch.lint import runtime as san
from repro_torch.net.shards import PSShardService, build_shard_table


# ----------------------------------------------------------------- framing
def _random_frame(rng, max_arrays=3):
    env = {
        "s": "x" * int(rng.integers(0, 50)),
        "i": int(rng.integers(-(2**40), 2**40)),
        "nest": {"a": [1, 2, {"b": None}]},
    }
    arrays = []
    for _ in range(int(rng.integers(0, max_arrays + 1))):
        dt = rng.choice(["<f8", "<i8", "<f4", "|i1"])
        shape = tuple(int(d) for d in rng.integers(0, 5, size=int(rng.integers(1, 3))))
        arrays.append((rng.random(shape) * 100).astype(np.dtype(dt)))
    return (
        int(rng.integers(0, 2**16)),
        int(rng.integers(0, 3)),
        int(rng.integers(0, 2**32)),
        env,
        arrays,
    )


def _assert_frames_equal(got, want):
    assert len(got) == len(want)
    for g, (mid, kind, rid, env, arrays) in zip(got, want):
        assert (g.method_id, g.kind, g.request_id) == (mid, kind, rid)
        assert g.env == env
        assert len(g.arrays) == len(arrays)
        for a, b in zip(g.arrays, arrays):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


def test_framing_roundtrip_fuzz_split_and_coalesced():
    """Any chunking of the byte stream — 1-byte dribble, random splits, or
    one giant coalesced read — yields the identical frame sequence."""
    rng = np.random.default_rng(0)
    frames = [_random_frame(rng) for _ in range(20)]
    blob = b"".join(encode_frame(*f[:4], f[4]) for f in frames)

    # coalesced: everything in one feed
    _assert_frames_equal(FrameDecoder().feed(blob), frames)

    for trial in range(5):
        cuts = np.sort(rng.integers(0, len(blob), size=int(rng.integers(1, 40))))
        chunks, prev = [], 0
        for c in list(cuts) + [len(blob)]:
            chunks.append(blob[prev:c])
            prev = int(c)
        _assert_frames_equal(list(iter_frames(chunks)), frames)

    # pathological: one byte at a time
    dec = FrameDecoder()
    got = []
    for i in range(len(blob)):
        got.extend(dec.feed(blob[i : i + 1]))
    dec.close()
    _assert_frames_equal(got, frames)


def test_framing_zero_length_payload():
    blob = encode_frame(7, REQUEST, 42, {})
    assert len(blob) == HEADER.size
    (frame,) = FrameDecoder().feed(blob)
    assert frame.env == {} and frame.arrays == ()
    assert frame.method_id == 7 and frame.request_id == 42


def test_framing_zero_length_array():
    (frame,) = FrameDecoder().feed(
        encode_frame(1, REQUEST, 1, {"k": 1}, [np.zeros((0, 7))])
    )
    assert frame.arrays[0].shape == (0, 7)


def test_framing_max_size_payload_boundary():
    env = {"pad": "y" * 100}
    payload_len = len(pack_payload(env))
    # exactly at the cap: decodes; one byte over: rejected before buffering
    (frame,) = FrameDecoder(max_payload=payload_len).feed(
        encode_frame(1, REQUEST, 1, env)
    )
    assert frame.env == env
    with pytest.raises(FramingError):
        FrameDecoder(max_payload=payload_len - 1).feed(encode_frame(1, REQUEST, 1, env))


def test_framing_corrupt_array_spec_is_framing_error():
    """A syntactically-valid envelope with a garbage array spec must raise
    FramingError (anything else escapes the reader threads' stream-error
    handling and wedges the client silently)."""
    import json

    from repro_torch.net.framing import ENVLEN

    for spec in (
        {"dtype": "bogus", "shape": [2]},
        {"dtype": "<f8", "shape": [-1]},
        {"dtype": "<f8"},
        "not-a-dict",
    ):
        envelope = json.dumps({"env": {}, "arrays": [spec]}).encode()
        payload = ENVLEN.pack(len(envelope)) + envelope + b"\0" * 64
        blob = HEADER.pack(MAGIC, 1, REQUEST, 1, len(payload)) + payload
        with pytest.raises(FramingError):
            FrameDecoder().feed(blob)
    # non-object envelope / env
    for env_json in (b"[1,2]", b'{"env": 3}'):
        payload = ENVLEN.pack(len(env_json)) + env_json
        blob = HEADER.pack(MAGIC, 1, REQUEST, 1, len(payload)) + payload
        with pytest.raises(FramingError):
            FrameDecoder().feed(blob)


def test_framing_bad_magic_raises():
    blob = encode_frame(1, REQUEST, 1, {"a": 1})
    with pytest.raises(FramingError):
        FrameDecoder().feed(b"XXXX" + blob[len(MAGIC):])


def test_framing_truncated_stream_raises_cleanly():
    rng = np.random.default_rng(3)
    frames = [_random_frame(rng) for _ in range(3)]
    blob = b"".join(encode_frame(*f[:4], f[4]) for f in frames)
    for cut in (len(blob) - 1, len(blob) - HEADER.size // 2, 3):
        dec = FrameDecoder()
        dec.feed(blob[:cut])
        with pytest.raises(TruncatedStream):
            dec.close()
    # a clean EOF on a frame boundary is not an error
    dec = FrameDecoder()
    dec.feed(blob)
    dec.close()


# ------------------------------------------------------------- rpc semantics
def _echo_table():
    table = MethodTable()
    table.register("echo", lambda env, arrays: (env, arrays))
    table.register("boom", lambda env, arrays: (_ for _ in ()).throw(ValueError("nope")))
    # heavy: a sleeping handler must occupy a worker thread, not the loop
    table.register(
        "slow", lambda env, arrays: (time.sleep(float(env["s"])), ({}, ()))[1],
        heavy=True,
    )
    return table


def test_rpc_call_roundtrip_and_pipelining():
    server = RPCServer(_echo_table()).start()
    try:
        client = RPCClient(server.endpoint, timeout=10)
        env, arrays = client.call("echo", {"k": [1, "two"]}, [np.arange(6.0).reshape(2, 3)])
        assert env == {"k": [1, "two"]}
        assert np.array_equal(arrays[0], np.arange(6.0).reshape(2, 3))
        # pipelined: all requests in flight before any result is awaited
        futs = [client.call_async("echo", {"i": i}) for i in range(20)]
        outs = [client.wait(f)[0]["i"] for f in futs]
        assert outs == list(range(20))
        client.close()
    finally:
        server.stop()


def test_rpc_remote_error_and_unknown_method():
    server = RPCServer(_echo_table()).start()
    try:
        client = RPCClient(server.endpoint, timeout=10)
        with pytest.raises(RemoteError) as ei:
            client.call("boom")
        assert ei.value.remote_type == "ValueError" and "nope" in str(ei.value)
        # a failed call must not poison the connection
        assert client.call("echo", {"ok": 1})[0] == {"ok": 1}
        with pytest.raises(RemoteError):
            client.call("no.such.method")
        client.close()
    finally:
        server.stop()


def test_rpc_per_call_timeout():
    server = RPCServer(_echo_table()).start()
    try:
        client = RPCClient(server.endpoint, timeout=10)
        with pytest.raises(CallTimeout):
            client.call("slow", {"s": 2.0}, timeout=0.05)
        client.close()
    finally:
        server.stop()


def test_rpc_server_kill_then_reconnect():
    """Kill → typed ConnectionLost; restart on the same port → the same
    client transparently reconnects on its next call."""
    server = RPCServer(_echo_table()).start()
    port = server.endpoint[1]
    client = RPCClient(server.endpoint, timeout=5, connect_retries=3, retry_delay=0.05)
    assert client.call("echo", {"a": 1})[0] == {"a": 1}
    server.stop()
    with pytest.raises(ConnectionLost):
        client.call("echo", {"a": 2})
    server2 = RPCServer(_echo_table(), port=port).start()
    try:
        assert client.call("echo", {"a": 3})[0] == {"a": 3}
    finally:
        client.close()
        server2.stop()


def test_rpc_inflight_calls_fail_loudly_on_kill():
    server = RPCServer(_echo_table()).start()
    client = RPCClient(server.endpoint, timeout=5, connect_retries=1, retry_delay=0.01)
    fut = client.call_async("slow", {"s": 30.0})
    time.sleep(0.1)  # let the request reach the handler
    server.stop()
    with pytest.raises(ConnectionLost):
        client.wait(fut, timeout=5)
    client.close()


# -------------------------------------------------- federation degradation
def test_federated_ps_degrades_loudly_when_workers_die():
    """A socket federation whose shard workers die must surface a typed
    transport error from the data path — never silently drop updates."""
    tables = [MethodTable(), MethodTable()]
    for t in tables:
        PSShardService().register(t)
    servers = [RPCServer(t).start() for t in tables]
    fed = FederatedPS(
        8, transport="socket", endpoints=[s.endpoint for s in servers]
    )
    d = StatsTable(8).update_batch(np.arange(8), np.ones(8))
    fed.update_and_fetch(0, 0, d)
    assert fed.snapshot().table[0, 0] == 1.0
    for s in servers:
        s.stop()
    for shard in fed.shards:  # don't sit through the full reconnect backoff
        shard._client.connect_retries = 2
        shard._client.retry_delay = 0.02
    with pytest.raises(ConnectionLost):
        for step in range(3):  # first push may ride the half-dead socket
            fed.update_and_fetch(0, 1 + step, d)
    fed.close()


# ------------------------------------------------- event-loop server load
def test_evloop_many_concurrent_connections():
    """≥64 concurrent connections, each with pipelined in-flight requests,
    served correctly by the single loop thread."""
    server = RPCServer(_echo_table()).start()
    clients = []
    try:
        clients = [
            RPCClient(server.endpoint, timeout=30, connect_retries=3)
            for _ in range(64)
        ]
        futs = [
            (i, j, c.call_async("echo", {"i": i, "j": j}))
            for i, c in enumerate(clients)
            for j in range(10)
        ]
        for i, j, fut in futs:
            env, _ = clients[i].wait(fut)
            assert env == {"i": i, "j": j}
    finally:
        for c in clients:
            c.close()
        server.stop()


def _handshake(sock):
    """Resolve the method table on a raw socket; returns {name: id}."""
    sock.sendall(encode_frame(METHOD_RESOLVE, REQUEST, 0, {}))
    dec = FrameDecoder()
    while True:
        frames = dec.feed(sock.recv(1 << 20))
        if frames:
            return {str(k): int(v) for k, v in frames[0].env["methods"].items()}


def test_evloop_one_byte_partial_writes():
    """Requests dribbled one byte at a time (worst-case interleaved partial
    writes) must decode and answer exactly like coalesced ones."""
    server = RPCServer(_echo_table()).start()
    try:
        with socket.create_connection(server.endpoint, timeout=10) as sock:
            methods = _handshake(sock)
            blob = b"".join(
                encode_frame(methods["echo"], REQUEST, 100 + i, {"i": i})
                for i in range(3)
            )
            for k in range(len(blob)):
                sock.sendall(blob[k : k + 1])
            dec = FrameDecoder()
            got = []
            while len(got) < 3:
                got.extend(dec.feed(sock.recv(1 << 20)))
            assert [(f.request_id, f.env["i"]) for f in got] == [
                (100 + i, i) for i in range(3)
            ]
    finally:
        server.stop()


def test_evloop_slow_reader_backpressure():
    """A peer that requests big responses but stops reading must trip the
    outbound high-water mark (server pauses *reading* that connection — no
    unbounded buffering), must not block other connections, and must get
    every response once it resumes reading."""
    server = RPCServer(_echo_table(), high_water=64 << 10, low_water=8 << 10).start()
    n_req, payload = 64, np.zeros(32 << 10, np.uint8)
    try:
        with socket.create_connection(server.endpoint, timeout=30) as slow:
            methods = _handshake(slow)
            blob = b"".join(
                encode_frame(methods["echo"], REQUEST, 1 + i, {}, [payload])
                for i in range(n_req)
            )
            # The server will stop reading once ~64 KiB of responses are
            # queued, so our send must run on a side thread (it blocks when
            # the kernel buffers fill) while this thread checks liveness.
            sender = threading.Thread(target=slow.sendall, args=(blob,), daemon=True)
            sender.start()

            deadline = time.time() + 30
            while server.backpressure_pauses == 0:
                assert time.time() < deadline, "server never paused the slow reader"
                time.sleep(0.01)

            # The loop is not wedged: a second connection still gets served.
            other = RPCClient(server.endpoint, timeout=10)
            assert other.call("echo", {"ok": 1})[0] == {"ok": 1}
            other.close()

            # Resume reading: every response arrives, none dropped.
            dec = FrameDecoder()
            got = 0
            while got < n_req:
                data = slow.recv(1 << 20)
                assert data, "server closed the backpressured connection"
                for frame in dec.feed(data):
                    assert frame.arrays[0].nbytes == payload.nbytes
                    got += 1
            sender.join(timeout=10)
            assert not sender.is_alive()
        assert server.backpressure_pauses >= 1
    finally:
        server.stop()


def test_evloop_inbound_backpressure_behind_heavy_handler():
    """Requests pipelined behind an in-flight heavy handler are bounded:
    past pending_max the server stops *reading* the connection (frames stay
    in kernel buffers, not server memory) and resumes as the backlog
    drains — with every request still answered in order."""
    server = RPCServer(_echo_table(), pending_max=8).start()
    try:
        client = RPCClient(server.endpoint, timeout=30)
        slow_fut = client.call_async("slow", {"s": 0.5})
        futs = [client.call_async("echo", {"i": i}) for i in range(100)]
        client.wait(slow_fut)
        assert [client.wait(f)[0]["i"] for f in futs] == list(range(100))
        client.close()
    finally:
        server.stop()


# ------------------------------------------------------- client semantics
def test_request_id_wraparound_skips_inflight():
    """Request ids wrap at 2³² and must skip ids still awaiting responses."""
    server = RPCServer(_echo_table()).start()
    try:
        client = RPCClient(server.endpoint, timeout=10)
        client._next_rid = 0xFFFFFFFF - 1  # near the wrap boundary
        futs = [client.call_async("echo", {"i": i}) for i in range(5)]
        assert [client.wait(f)[0]["i"] for f in futs] == list(range(5))
        assert client._next_rid < 10  # wrapped past 2³²-1 back into [1, ...]
        # Collision: a still-pending rid must be skipped, not reused.
        blocker = concurrent.futures.Future()
        with client._pending_lock:
            client._pending[5] = (client._gen, "x", blocker)
        client._next_rid = 5
        env, _ = client.call("echo", {"ok": True})
        assert env == {"ok": True}
        assert 5 in client._pending  # the fake in-flight call kept its id
        with client._pending_lock:
            del client._pending[5]
        client.close()
    finally:
        server.stop()


def test_call_timeout_surfaces_method_name():
    """CallTimeout names the *method* even through name-less wait paths."""
    server = RPCServer(_echo_table()).start()
    try:
        client = RPCClient(server.endpoint, timeout=10)
        fut = client.call_async("slow", {"s": 30.0})
        with pytest.raises(CallTimeout, match="'slow'"):
            client.wait(fut, timeout=0.05)  # note: no name= passed
        client.close()
    finally:
        server.stop()


def test_buffered_sends_flush_on_wait_and_preserve_order():
    """A buffered (fire-and-forget) frame reaches the wire before any later
    unbuffered frame, and wait() flushes so a buffered future resolves."""
    calls = []
    table = MethodTable()
    table.register("a", lambda env, arrays: (calls.append(("a", env["i"])), ({}, ()))[1])
    table.register("b", lambda env, arrays: (calls.append(("b", env["i"])), ({}, ()))[1])
    server = RPCServer(table).start()
    try:
        client = RPCClient(server.endpoint, timeout=10)
        f1 = client.call_async("a", {"i": 0}, buffered=True)
        f2 = client.call_async("a", {"i": 1}, buffered=True)
        assert client._sendbuf  # still parked client-side
        client.call("b", {"i": 2})  # unbuffered: flushes the buffer first
        client.wait(f1)
        client.wait(f2)
        assert calls == [("a", 0), ("a", 1), ("b", 2)]
        # wait() alone must also flush: nothing else will.
        f3 = client.call_async("a", {"i": 3}, buffered=True)
        client.wait(f3)
        assert calls[-1] == ("a", 3)
        client.close()
    finally:
        server.stop()


def test_shard_service_unconfigured_is_typed_error():
    table = MethodTable()
    PSShardService().register(table)
    server = RPCServer(table).start()
    try:
        client = RPCClient(server.endpoint, timeout=5)
        with pytest.raises(RemoteError) as ei:
            client.call("ps.push", arrays=[np.zeros((1, 7))])
        assert "not configured" in str(ei.value)
        client.close()
    finally:
        server.stop()


# ================================== socket federation (tests/test_federation.py)
def _random_deltas(rng, n_ranks, frames, F, grow_to=None):
    """Per-(rank, frame) delta tables from random event batches."""
    out = []
    for t in range(frames):
        for r in range(n_ranks):
            Ft = F if grow_to is None or t < frames // 2 else grow_to
            n = int(rng.integers(0, 80))
            fids = rng.integers(0, Ft, n)
            vals = rng.lognormal(3.0, 1.0, n)
            out.append((r, t, StatsTable(Ft).update_batch(fids, vals)))
    return out


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_socket_transport_bitmatches_local(num_shards):
    """transport="socket" must be a pure shard relocation: every snapshot a
    client sees and the final global table bit-match local mode (stats rows
    travel as raw float64 bytes; the wire adds zero behavioral drift)."""
    from repro_torch.launch.shard_server import LocalShardHost

    rng = np.random.default_rng(17 + num_shards)
    F, F2 = 37, 53
    local = FederatedPS(F, num_shards=num_shards, aggregate_every=7)
    with LocalShardHost(num_shards, kind="ps") as host:
        sock = FederatedPS(
            F, transport="socket", endpoints=host.endpoints, aggregate_every=7
        )
        assert sock.num_shards == num_shards
        for r, t, d in _random_deltas(rng, n_ranks=4, frames=20, F=F, grow_to=F2):
            a = local.update_and_fetch(r, t, d)
            b = sock.update_and_fetch(r, t, d)
            assert np.array_equal(a, b)  # same staleness, same bits, every push
        assert local.num_funcs == sock.num_funcs == F2  # growth crossed the wire
        assert np.array_equal(local.snapshot().table, sock.snapshot().table)
        assert sock.shard_load() == local.shard_load()
        sock.close()


def test_socket_transport_process_workers():
    """Same bit-match through real worker *processes* (the GIL-escaping
    topology benchmarked by bench_net_federation.py)."""
    from repro_torch.launch.shard_server import ShardServerPool

    rng = np.random.default_rng(23)
    F = 29
    local = FederatedPS(F, num_shards=2, aggregate_every=5)
    with ShardServerPool(2, kind="ps") as pool:
        sock = FederatedPS(
            F, transport="socket", endpoints=pool.endpoints, aggregate_every=5
        )
        for r, t, d in _random_deltas(rng, n_ranks=3, frames=10, F=F):
            local.update_and_fetch(r, t, d)
            sock.update_and_fetch(r, t, d)
        assert np.array_equal(local.snapshot().table, sock.snapshot().table)
        sock.close()


def test_monitor_socket_transport_matches_local():
    """ChimbukoMonitor end-to-end on the socket transport == local PS."""
    from repro_torch.core.sim import WorkloadGenerator, nwchem_like
    from repro_torch.launch.shard_server import LocalShardHost
    from repro_torch.trace.monitor import ChimbukoMonitor

    spec = nwchem_like(anomaly_rate=0.004, roots_per_frame=4)
    g1 = WorkloadGenerator(spec, n_ranks=2, seed=5)
    g2 = WorkloadGenerator(spec, n_ranks=2, seed=5)
    m1 = ChimbukoMonitor(num_funcs=len(g1.registry), registry=g1.registry,
                         min_samples=30, ps_shards=2)
    with LocalShardHost(2, kind="ps") as host:
        m2 = ChimbukoMonitor(num_funcs=len(g2.registry), registry=g2.registry,
                             min_samples=30, ps_transport="socket",
                             shard_endpoints=host.endpoints)
        for s in range(8):
            for r in range(2):
                m1.ingest(g1.frame(r, s)[0])
                m2.ingest(g2.frame(r, s)[0])
        assert np.array_equal(m1.ps.snapshot().table, m2.ps.snapshot().table)
        assert m2.summary()["ps_transport"] == "socket"
        m1.close()
        m2.close()


def test_incremental_refresh_bitmatches_over_socket():
    """Same bit-match guarantee when shards answer ps.peek_rows over RPC."""
    from repro_torch.launch.shard_server import LocalShardHost

    rng = np.random.default_rng(17)
    F = 19
    with LocalShardHost(2, kind="ps") as host:
        fed = FederatedPS(F, transport="socket", endpoints=host.endpoints,
                          aggregate_every=10**9)
        try:
            for r, t, d in _random_deltas(rng, n_ranks=3, frames=8, F=F):
                fed.update_and_fetch(r, t, d)
            fed.drain()
            fed._refresh_aggregate()
            full = fed.snapshot().table
            incr = S.pad_table(fed._agg, full.shape[0])
            assert np.array_equal(incr, full)
        finally:
            fed.close()



# =================== socket provenance (tests/test_provdb_federation.py)
FIXED_RUN_INFO = {"timestamp": 0.0}


def _comm_frame():
    """rank 0: tid0 main(0..100){child(10..40)}, tid1 other(0..100);
    comm events at ts 20 (child), 50 (main), 60 (tid1's call)."""
    f0 = make_func_events(
        [(0, ENTRY, 0), (1, ENTRY, 10), (1, EXIT, 40), (0, EXIT, 100)], tid=0
    )
    f1 = make_func_events([(2, ENTRY, 0), (2, EXIT, 100)], tid=1)
    ce = empty_comm_events(3)
    ce["rank"] = 0
    ce["tid"] = [0, 0, 1]
    ce["ts"] = [20, 50, 60]
    ce["partner"] = [1, 2, 3]
    ce["nbytes"] = [100, 200, 300]
    frame = Frame(
        app=0, rank=0, step=0,
        func_events=np.concatenate([f0, f1]), comm_events=ce,
    )
    return frame


def _result_for(frame, anomaly_fid):
    builder = CallStackBuilder(rank=frame.rank)
    records, ctx = builder.process(frame)
    records["label"] = 0
    idx = int(np.nonzero(records["fid"] == anomaly_fid)[0][0])
    records["label"][idx] = 1
    return ADFrameResult(
        step=frame.step, rank=frame.rank, records=records, ctx=ctx,
        anomaly_idx=np.asarray([idx]), n_events=len(frame.func_events),
        raw_bytes=frame.nbytes_raw(),
    )


def _anomaly_stream(n_ranks=4, steps=30, seed=3):
    spec = nwchem_like(anomaly_rate=0.01)
    for f in spec.funcs.values():
        f.anomaly_scale = 50.0
    gen = WorkloadGenerator(spec, n_ranks=n_ranks, seed=seed)
    ads = {r: OnNodeAD(len(gen.registry), rank=r, min_samples=20) for r in range(n_ranks)}
    stream = []
    for step in range(steps):
        for rank in range(n_ranks):
            frame, _ = gen.frame(rank, step)
            res = ads[rank].process_frame(frame)
            if res.n_anomalies:
                stream.append((res, frame.comm_events))
    assert stream, "workload produced no anomalies"
    return gen.registry, stream


@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_socket_provdb_matches_local(tmp_path, num_shards):
    """transport="socket" provenance must be byte-identical to local mode:
    same docs in the same order from every query axis, and bit-identical
    shard JSONL files (the docs and their persisted seq survive the wire
    unchanged)."""
    import torch  # noqa: F401 — static_provenance's lazy torch import and
    # CUDA probe: warm them so both stores snapshot the same env into their
    # run_info headers.
    from repro_torch.launch.shard_server import LocalShardHost

    registry, stream = _anomaly_stream()
    local = FederatedProvenanceDB(
        num_shards=num_shards, path=str(tmp_path / "local.jsonl"),
        registry=registry, run_info=FIXED_RUN_INFO,
    )
    with LocalShardHost(num_shards, kind="prov") as host:
        sock = FederatedProvenanceDB(
            path=str(tmp_path / "sock.jsonl"), registry=registry,
            run_info=FIXED_RUN_INFO, transport="socket", endpoints=host.endpoints,
        )
        assert sock.num_shards == num_shards
        for res, comm in stream:
            assert local.ingest(res, comm) == sock.ingest(res, comm)
        assert sock.records == local.records
        assert sock.shard_doc_counts() == local.shard_doc_counts()
        doc = local.records[0]
        rank, fid = doc["rank"], doc["anomaly"]["fid"]
        t_mid = doc["anomaly"]["entry"]
        for q in (
            {}, {"rank": rank}, {"fid": fid}, {"rank": rank, "fid": fid},
            {"step": doc["step"]}, {"t0": t_mid - 500, "t1": t_mid + 500},
        ):
            assert sock.query(**q) == local.query(**q)
        assert len(sock) == len(local)
        local.close()
        sock.close()
        for pl, ps_ in zip(
            shard_paths(str(tmp_path / "local.jsonl"), num_shards),
            shard_paths(str(tmp_path / "sock.jsonl"), num_shards),
        ):
            with open(pl, "rb") as fl, open(ps_, "rb") as fs:
                assert fl.read() == fs.read()


def test_socket_provdb_resume_across_transports(tmp_path):
    """append=True over the socket sees (and re-routes) docs a local-mode
    run left behind: the transport changes where shards run, not what the
    path family means."""
    from repro_torch.launch.shard_server import LocalShardHost

    path = str(tmp_path / "prov.jsonl")
    frame = _comm_frame()
    local = FederatedProvenanceDB(num_shards=2, path=path, run_info=FIXED_RUN_INFO)
    for fid in (1, 0):
        local.ingest(_result_for(frame, anomaly_fid=fid), frame.comm_events)
    before = local.records
    local.close()

    with LocalShardHost(2, kind="prov") as host:
        sock = FederatedProvenanceDB(
            path=path, run_info=FIXED_RUN_INFO, append=True,
            transport="socket", endpoints=host.endpoints,
        )
        assert sock.records == before
        sock.ingest(_result_for(frame, anomaly_fid=2), frame.comm_events)
        assert len(sock) == 3
        sock.close()


def test_secondary_index_queries_over_socket():
    """func/severity drill-downs cross the wire unchanged."""
    from repro_torch.launch.shard_server import LocalShardHost

    registry, stream = _anomaly_stream()
    local = FederatedProvenanceDB(num_shards=2, registry=registry)
    with LocalShardHost(2, kind="prov") as host:
        sock = FederatedProvenanceDB(
            registry=registry, transport="socket", endpoints=host.endpoints
        )
        for res, comm in stream:
            local.ingest(res, comm)
            sock.ingest(res, comm)
        d0 = local.records[0]
        func = d0["anomaly"]["func"]
        assert sock.query(func=func) == local.query(func=func)
        assert sock.query(min_severity=1) == local.query(min_severity=1)
        assert sock.query(severity=d0["severity"]) == local.query(
            severity=d0["severity"]
        )
        local.close()
        sock.close()


def _mini_doc(i):
    return {
        "type": "anomaly", "step": i, "rank": 0, "severity": 0,
        "anomaly": {"fid": i % 3, "entry": i * 10, "exit": i * 10 + 5},
        "call_stack": [], "neighbors": [], "comm": [],
    }


def test_mid_batch_kill_no_dropped_no_duplicated_docs(tmp_path):
    """A connection killed mid-batch surfaces ConnectionLost; the retry
    after reconnect must leave every doc exactly once — in the index AND in
    the JSONL file — whether or not the server applied the doomed batch.

    The server's ``prov.add_many`` handler waits on a gate while the doomed
    batch is in flight, so its response cannot beat the kill: the original
    leaves that to timing, and a reply that lands before the drop makes it
    fail (it does so when run alone)."""
    from repro_torch.net import ConnectionLost, RPCServer
    from repro_torch.net.shards import RemoteProvenanceShard, build_shard_table

    path = str(tmp_path / "shard.jsonl")
    table = build_shard_table("prov")
    gate = threading.Event()
    gate.set()
    name, add_many, heavy = table._by_id[table._ids["prov.add_many"]]

    def gated(env, arrays):
        gate.wait(30)
        return add_many(env, arrays)

    table._by_id[table._ids["prov.add_many"]] = (name, gated, heavy)
    server = RPCServer(table).start()
    try:
        shard = RemoteProvenanceShard(server.endpoint, path=path)
        batch1 = [_mini_doc(i) for i in range(10)]
        shard.add_many(batch1, seqs=range(10))

        batch2 = [_mini_doc(10 + i) for i in range(10)]
        gate.clear()
        fut = shard.add_many_async(batch2, seqs=range(10, 20))
        # Kill the connection under the in-flight batch: the response can
        # no longer arrive, so the client cannot know whether the server
        # applied it — the ambiguous-retry case.
        shard._client._drop_connection(ConnectionLost("mid-batch kill"), gen=None)
        with pytest.raises(ConnectionLost):
            shard.finish(fut)
        gate.set()

        # Retry transparently reconnects; per-shard seq idempotence makes
        # the ambiguity harmless.
        shard.add_many(batch2, seqs=range(10, 20))
        # And an *unambiguous* duplicate (delivered-but-unacked) is skipped.
        shard.add_many(batch2, seqs=range(10, 20))

        assert len(shard) == 20
        seqs = [seq for seq, _ in shard.dump()]
        assert seqs == list(range(20))
        shard.flush()
        with open(path) as f:
            lines = [json.loads(l) for l in f]
        assert [d["seq"] for d in lines] == list(range(20))
        shard.close()
    finally:
        gate.set()
        server.stop()


# ======================================= concurrency (tests/test_concurrency.py)
def test_prov_filesystem_handlers_registered_heavy():
    """lint: loop-blocking-io — prov.configure/flush/close hit the
    filesystem (makedirs/open/fsync/close) and must run on the worker
    pool, never inline on the RPC server's loop thread."""
    table = build_shard_table("prov")
    heavy = {name: hv for name, fn, hv in table._by_id.values()}
    assert heavy["prov.configure"] is True
    assert heavy["prov.flush"] is True
    assert heavy["prov.close"] is True
    # The ingest hot path stays light by design (buffered in-memory write).
    assert heavy["prov.add"] is False


def test_subscribe_during_dispatch_loses_no_subscriber():
    """lint: lockset-mixed — ``subscribe`` appended to ``_subscribers``
    bare while ``report_anomalies`` snapshots the list under ``_feed_lock``
    from another thread.  Hammer both sides; every subscriber registered
    before the final report must see the final report."""
    feed = AnomalyFeed()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # force contention at the bytecode level
    try:
        stop = threading.Event()

        def reporter():
            step = 0
            while not stop.is_set():
                feed.report_anomalies(rank=0, step=step, n_anomalies=1)
                step += 1

        rep = threading.Thread(target=reporter)
        rep.start()
        hits = []
        n_subs = 64
        for i in range(n_subs):
            feed.subscribe(lambda msg, i=i: hits.append(i))
        stop.set()
        rep.join()
    finally:
        sys.setswitchinterval(switch)
    assert len(feed._subscribers) == n_subs
    # One final report reaches every registered subscriber exactly once.
    hits.clear()
    feed.report_anomalies(rank=0, step=10**6, n_anomalies=0)
    assert sorted(hits) == list(range(n_subs))


def test_backpressure_counters_exact_under_contention():
    """lint: lockset-counter — ``backpressure_pauses``/``resumes`` were
    bare ``+=`` on the loop thread while tests/monitors read them
    cross-thread.  PR 8 moved them into lock-disciplined telemetry
    ``Counter``s; this hammers the server's own pause counter from many
    threads and demands an exact total (a bare += drops updates under
    contention), then checks the read side the old fields proxied to."""
    table = MethodTable()
    table.register("noop", lambda env, arrays: ({}, ()))
    server = RPCServer(table)
    per_thread, n_threads = 3000, 8
    base = server.backpressure_pauses  # ephemeral-port label could be reused
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def bump():
            for _ in range(per_thread):
                server._m_backpressure_pauses.inc()

        ts = [threading.Thread(target=bump) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    finally:
        sys.setswitchinterval(switch)
        server.stop()
    assert server.backpressure_pauses - base == per_thread * n_threads


def _sanitizer_echo_table():
    table = MethodTable()
    table.register("echo", lambda env, arrays: (dict(env), arrays))
    table.register("boom", lambda env, arrays: (_ for _ in ()).throw(
        ValueError("boom")), heavy=True)
    return table


def test_sanitizer_silent_on_correctly_threaded_server():
    """With REPRO_SANITIZE=1 (the whole suite), a round-trip through light
    and heavy handlers crosses every guarded hot path — _service, _send,
    _flush_out, _drain_pending, _run_heavy, _complete_heavy — without a
    ThreadOwnershipError."""
    from repro_torch.net.client import RPCClient

    assert san.ENABLED
    server = RPCServer(_sanitizer_echo_table()).start()
    client = RPCClient(server.endpoint, timeout=10)
    try:
        env, _ = client.call("echo", {"x": 1})
        assert env == {"x": 1}
        with pytest.raises(RemoteError):
            client.call("boom", {})
        env2, _ = client.call("echo", {"x": 2})  # server survived the heavy error
        assert env2 == {"x": 2}
    finally:
        client.close()
        server.stop()


def test_sanitizer_catches_cross_thread_send():
    """Calling a loop-owned method from a foreign thread raises before any
    state is touched — the dynamic complement of the static loop rules."""
    server = RPCServer(_sanitizer_echo_table()).start()
    try:
        class _FakeConn:
            closed = False

        deadline = time.monotonic() + 5
        while server._loop_thread is None and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(san.ThreadOwnershipError, match="_post"):
            server._send(_FakeConn(), b"nope")
    finally:
        server.stop()



# ============================================ the wire across packages
@pytest.mark.parametrize("seed", range(4))
def test_framing_bytes_identical_across_packages(seed):
    """The same message encodes to the same bytes in both framing modules
    (trace context included), and each package decodes the other's."""
    from repro.net import framing as jf
    from repro_torch.net import framing as tf

    rng = np.random.default_rng(100 + seed)
    frames = [_random_frame(rng) for _ in range(16)]
    for i, (mid, kind, rid, env, arrays) in enumerate(frames):
        tc = (int(rng.integers(1, 2**62)), int(rng.integers(1, 2**62)), 1) if i % 2 else None
        jb = jf.encode_frame(mid, kind, rid, env, arrays, tc=tc)
        tb = tf.encode_frame(mid, kind, rid, env, arrays, tc=tc)
        assert jb == tb
        for dec in (jf.FrameDecoder(), tf.FrameDecoder()):
            (got,) = dec.feed(jb)
            _assert_frames_equal([got], [(mid, kind, rid, env, arrays)])
            assert got.tc == (None if tc is None else tuple(tc))


def _shard_host(pkg, n, kind):
    if pkg == "jax":
        from repro.launch.shard_server import LocalShardHost as Host
    else:
        from repro_torch.launch.shard_server import LocalShardHost as Host
    return Host(n, kind=kind)


@pytest.mark.parametrize("client,server", [("jax", "port"), ("port", "jax"),
                                           ("jax", "jax"), ("port", "port")])
def test_cross_package_client_and_shard_server(tmp_path, client, server):
    """A JAX-package client against the port's shard servers, and the
    reverse, give the same PS snapshot bytes and provenance docs as each
    package against its own."""
    from repro.core.provenance import FederatedProvenanceDB as JProv
    from repro.core.ps import FederatedPS as JPS

    PS, Prov = (JPS, JProv) if client == "jax" else (FederatedPS, FederatedProvenanceDB)
    rng = np.random.default_rng(31)
    F = 23
    ref = JPS(F, num_shards=2, aggregate_every=4)
    registry, stream = _anomaly_stream(n_ranks=2, steps=20)
    ref_prov = JProv(num_shards=2, registry=registry)
    with _shard_host(server, 2, "both") as host:
        ps = PS(F, transport="socket", endpoints=host.endpoints, aggregate_every=4)
        prov = Prov(registry=registry, transport="socket", endpoints=host.endpoints)
        try:
            for r, t, d in _random_deltas(rng, n_ranks=3, frames=8, F=F):
                assert np.array_equal(ps.update_and_fetch(r, t, d),
                                      ref.update_and_fetch(r, t, d))
            assert ps.snapshot().table.tobytes() == ref.snapshot().table.tobytes()
            for res, comm in stream:
                assert prov.ingest(res, comm) == ref_prov.ingest(res, comm)
            assert prov.records == ref_prov.records
            doc = ref_prov.records[0]
            assert prov.query(rank=doc["rank"]) == ref_prov.query(rank=doc["rank"])
        finally:
            ps.close()
            prov.close()
            ref_prov.close()
