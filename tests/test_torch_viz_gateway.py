"""Port's live viz gateway (repro_torch.viz.{http,ws,gateway}) vs the JAX package's.

Twins of tests/test_viz_gateway.py, held against the original:

  * the HTTP request parser and the RFC 6455 codec take the same bytes,
    whole, byte by byte and in random splits, and give the same requests,
    messages, errors, statuses and close codes in both packages;
  * a port gateway and a JAX gateway over monitors fed identical frames
    answer every endpoint with identical bodies, ``/trace`` equals the
    offline export, and a finished run dir written by either package
    replays through either package's ``ReplayMonitor``;
  * the port's WebSocket side: hello and broadcast, a viewer shed with
    1013, ``ChimbukoMonitor(viz_serve=0)`` and a monitored ``serve`` with
    a live viewer counting every frame.
"""
import json
import os
import random
import socket
import struct
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro.core import sim as j_sim  # noqa: E402
from repro.trace.monitor import ChimbukoMonitor as JMonitor  # noqa: E402
from repro.viz import http as JH  # noqa: E402
from repro.viz import ws as JW  # noqa: E402
from repro.viz.gateway import ReplayMonitor as JReplay  # noqa: E402
from repro.viz.gateway import VizGateway as JGateway  # noqa: E402
from repro_torch.core import sim as t_sim  # noqa: E402
from repro_torch.export.cli import main as t_export  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.trace.monitor import ChimbukoMonitor as TMonitor  # noqa: E402
from repro_torch.viz import http as TH  # noqa: E402
from repro_torch.viz import ws as TW  # noqa: E402
from repro_torch.viz.gateway import ReplayMonitor as TReplay  # noqa: E402
from repro_torch.viz.gateway import VizGateway as TGateway  # noqa: E402
from repro_torch.viz.server import VizServer as TViz  # noqa: E402

from test_viz_gateway import _get, _read_head, _read_response, _recv_msgs, _wait, _ws_connect  # noqa: E402,E501

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------ HTTP parser
def _splits(data, rng):
    """Whole, byte by byte, and three random splittings of ``data``."""
    yield [data]
    yield [data[i:i + 1] for i in range(len(data))]
    for _ in range(3):
        out, i = [], 0
        while i < len(data):
            n = rng.randint(1, 24)
            out.append(data[i:i + n])
            i += n
        yield out


def _parse(H, chunks, **kw):
    """-> the parsed requests as plain tuples, or ("error", status, detail)."""
    p = H.HttpRequestParser(**kw)
    out = []
    try:
        for c in chunks:
            out.extend((r.method, r.target, r.path, r.query, r.version, r.headers, r.body,
                        r.keep_alive, r.wants_upgrade()) for r in p.feed(c))
    except H.HttpError as e:
        return ("error", e.status, e.detail)
    return out, p.paused, p.take_buffer() if p.paused else b""


_HTTP_CORPUS = [
    (b"GET /series?rank=3&x=entry HTTP/1.1\r\nHost: h\r\nAccept: */*\r\n\r\n" * 3, {}),
    (b"GET /a HTTP/1.1\r\n\r\nPOST /b HTTP/1.1\r\nContent-Length: 5\r\n\r\nhello"
     b"GET /c HTTP/1.0\r\nConnection: keep-alive\r\n\r\nGET /d HTTP/1.0\r\n\r\n", {}),
    (b"GET /a%20b?x=1&x=2&y= HTTP/1.1\r\nX-A: 1\r\nx-a: 2\r\nConnection: close\r\n\r\n", {}),
    (b"GET /ws HTTP/1.1\r\nUpgrade: websocket\r\nConnection: keep-alive, Upgrade\r\n\r\n"
     + JW.encode_frame(JW.OP_PING, b"x", mask=b"abcd") + b"more", {}),
    (b"GET /x HT", {}),  # truncated: pending, not an error
    (b"GARBAGE\r\n\r\n", {}),
    (b"GET /x\r\n\r\n", {}),
    (b"GET /x HTTP/9.9\r\n\r\n", {}),
    (b"G ET /x HTTP/1.1\r\n\r\n", {}),
    (b"GET x://y HTTP/1.1\r\n\r\n", {}),
    (b"GET /x HTTP/1.1\r\nBad Header\r\n\r\n", {}),
    (b"GET /x HTTP/1.1\r\nA: 1\r\n  folded\r\n\r\n", {}),
    (b"GET /x HTTP/1.1\r\nContent-Length: nope\r\n\r\n", {}),
    (b"GET /x HTTP/1.1\r\nContent-Length: -5\r\n\r\n", {}),
    (b"GET /x HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n", {}),
    (b"GET /x HTTP/1.1\r\nA: " + b"x" * 300 + b"\r\n\r\n", dict(max_head=256)),
    (b"x" * 640, dict(max_head=256)),  # a head that never ends
    (b"GET /x HTTP/1.1\r\nA: 1\r\nB: 2\r\nC: 3\r\nD: 4\r\n\r\n", dict(max_headers=3)),
    (b"POST /x HTTP/1.1\r\nContent-Length: 500\r\n\r\n", dict(max_body=100)),
]


@pytest.mark.parametrize("i", range(len(_HTTP_CORPUS)))
def test_http_parser_matches_jax_on_the_same_bytes(i):
    data, kw = _HTTP_CORPUS[i]
    rng = random.Random(i)
    results = set()
    for chunks in _splits(data, rng):
        got, want = _parse(TH, chunks, **kw), _parse(JH, chunks, **kw)
        assert got == want
        results.add(repr(got))
    assert len(results) == 1  # and the splitting changes nothing


def test_http_responses_are_the_originals_bytes():
    for H in (TH, JH):
        assert H.REASONS == JH.REASONS
    args = [(200, b'{"a":1}', (("ETag", '"3"'),), True), (304, b"", (), False),
            (101, b"", (("Upgrade", "websocket"),), True)]
    for status, body, hdrs, ka in args:
        assert TH.build_response(status, body, headers=hdrs, keep_alive=ka) == \
            JH.build_response(status, body, headers=hdrs, keep_alive=ka)
    for status in (400, 404, 413, 431, 500, 501):
        assert TH.error_response(TH.HttpError(status, "why")) == \
            JH.error_response(JH.HttpError(status, "why"))
    assert TH.chunked_head(headers=(("ETag", '"1"'),), keep_alive=False) == \
        JH.chunked_head(headers=(("ETag", '"1"'),), keep_alive=False)
    assert TH.chunk(b"abc") == JH.chunk(b"abc") and TH.CHUNK_END == JH.CHUNK_END


# -------------------------------------------------------- WebSocket codec
def _decode(W, chunks, **kw):
    dec = W.WSDecoder(**kw)
    out = []
    try:
        for c in chunks:
            out.extend((m.opcode, m.data, m.close_code) for m in dec.feed(c))
    except W.WSProtocolError as e:
        return ("error", e.code, e.reason)
    return out, dec.pending_bytes


_M = b"abcd"
_WS_CORPUS = [
    JW.encode_frame(JW.OP_TEXT, b"hel", fin=False, mask=_M)
    + JW.encode_frame(JW.OP_PING, b"p", mask=_M)
    + JW.encode_frame(JW.OP_CONT, b"lo ", fin=False, mask=_M)
    + JW.encode_frame(JW.OP_CONT, b"world", fin=True, mask=_M),
    b"".join(JW.encode_frame(JW.OP_TEXT, f"m{i}".encode(), mask=_M) for i in range(20)),
    JW.encode_close(1001, "going away", mask=_M),
    JW.encode_frame(JW.OP_TEXT, b"hello", mask=_M)[:-1],  # truncated: pending
    JW.encode_frame(JW.OP_TEXT, b"x", mask=_M, rsv=4),
    JW.encode_frame(0x3, b"x", mask=_M),
    JW.encode_frame(JW.OP_TEXT, b"x"),  # unmasked client frame
    JW.encode_frame(JW.OP_PING, b"x", fin=False, mask=_M),
    JW.encode_frame(JW.OP_PING, b"x" * 126, mask=_M),
    JW.encode_frame(JW.OP_CONT, b"x", mask=_M),
    JW.encode_frame(JW.OP_TEXT, b"a", fin=False, mask=_M)
    + JW.encode_frame(JW.OP_TEXT, b"b", mask=_M),
    JW.encode_frame(JW.OP_CLOSE, b"\x03", mask=_M),
    JW.encode_frame(JW.OP_CLOSE, struct.pack("!H", 1005), mask=_M),
    JW.encode_frame(JW.OP_TEXT, b"\xff\xfe", mask=_M),
    JW.encode_frame(JW.OP_CLOSE, struct.pack("!H", 1000) + b"\xff", mask=_M),
    struct.pack("!BBQ", 0x82, 0x80 | 127, 1 << 30) + _M,  # 1009 off the declared length
    JW.encode_frame(JW.OP_BINARY, b"x" * 800, fin=False, mask=_M)
    + JW.encode_frame(JW.OP_CONT, b"x" * 800, fin=True, mask=_M),  # 1009 cumulative
    JW.encode_frame(JW.OP_BINARY, b"payload", mask=_M)[:2] + b"zzzz"
    + JW.encode_frame(JW.OP_BINARY, b"payload", mask=_M)[6:],  # wrong mask: bytes, no crash
]


@pytest.mark.parametrize("i", range(len(_WS_CORPUS)))
def test_ws_decoder_matches_jax_on_the_same_bytes(i):
    wire = _WS_CORPUS[i]
    rng = random.Random(100 + i)
    results = set()
    for chunks in _splits(wire, rng):
        got = _decode(TW, chunks, max_message=1024)
        assert got == _decode(JW, chunks, max_message=1024)
        results.add(repr(got))
    assert len(results) == 1


@pytest.mark.parametrize("size", [0, 1, 125, 126, 4096, 65535, 65536])
def test_ws_encoder_and_roundtrip_match_jax(size):
    payload = bytes(i & 0xFF for i in range(size))
    for op, mask in ((TW.OP_BINARY, b"\x01\x02\x03\x04"), (TW.OP_TEXT, None)):
        wire = TW.encode_frame(op, payload, mask=mask)
        assert wire == JW.encode_frame(op, payload, mask=mask)
        got = _decode(TW, [wire], require_mask=mask is not None, max_message=1 << 20)
        assert got == _decode(JW, [wire], require_mask=mask is not None, max_message=1 << 20)
        if op == TW.OP_BINARY:
            assert got[0] == [(op, payload, None)]
    assert TW.encode_close(1013, "behind") == JW.encode_close(1013, "behind")
    assert TW.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo=" \
        == JW.accept_key("dGhlIHNhbXBsZSBub25jZQ==")


# ------------------------------------------------------- live gateways
def _run(Monitor, sim, td, n_ranks=3, steps=8, seed=3, **kw):
    """tests/test_export.py:_run_monitor with one package's monitor and sim."""
    spec = sim.nwchem_like(anomaly_rate=0.02)
    for f in spec.funcs.values():
        f.anomaly_scale = 40.0
    gen = sim.WorkloadGenerator(spec, n_ranks=n_ranks, seed=seed)
    monitor = Monitor(
        num_funcs=len(gen.registry), registry=gen.registry, min_samples=20,
        prov_path=os.path.join(td, "provenance.jsonl"),
        stream_path=os.path.join(td, "stream.jsonl"),
        run_info={"timestamp": 0.0}, **kw,
    )
    for step in range(steps):
        for rank in range(n_ranks):
            frame, _ = gen.frame(rank, step)
            monitor.ingest(frame)
    return monitor


_VIEWS = [
    "/dashboard", "/dashboard?stat=total&top=2&bottom=2", "/series?rank=1",
    "/function?rank=0&step=3&x=entry&y=runtime", "/callstack?rank=0&t0=0&t1=999999999",
    "/callstack?rank=1&t0=0&t1=999999999&fid=2", "/provenance", "/provenance?min_severity=1&limit=5",
    "/provenance?rank=2&limit=3", "/trace",
]
_ERRORS = ["/nope", "/series", "/series?rank=abc", "/dashboard?stat=bogus",
           "/function?rank=0&step=0&x=bogus", "/callstack?rank=0&t0=1"]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The same frames through both packages' monitors, each behind its own
    running gateway; -> {package: (dir, monitor, gateway)}."""
    out = {}
    for name, Monitor, sim, Gateway in (("jax", JMonitor, j_sim, JGateway),
                                        ("port", TMonitor, t_sim, TGateway)):
        td = str(tmp_path_factory.mktemp(name))
        mon = _run(Monitor, sim, td)
        out[name] = (td, mon, Gateway(mon).start())
    yield out
    for _td, mon, gw in out.values():
        gw.stop()
        mon.close()


@pytest.mark.parametrize("target", _VIEWS + _ERRORS)
def test_every_endpoint_answers_as_the_jax_gateway(both, target):
    (_, _, jgw), (_, _, tgw) = both["jax"], both["port"]
    jst, jh, jb = _get(jgw.endpoint, target)
    tst, th, tb = _get(tgw.endpoint, target)
    assert (tst, tb) == (jst, jb)
    for h in ("etag", "content-type", "transfer-encoding", "connection"):
        assert th.get(h) == jh.get(h), h
    if target in _VIEWS:
        assert tst == 200 and tb and th["access-control-allow-origin"] == "*"


def test_index_and_metrics_answer_as_the_jax_gateway(both):
    """``/`` differs only in the service's package name; ``/metrics``
    carries the gateway's series under the original's names."""
    (_, jmon, jgw), (_, tmon, tgw) = both["jax"], both["port"]
    jdoc = json.loads(_get(jgw.endpoint, "/")[2])
    tdoc = json.loads(_get(tgw.endpoint, "/")[2])
    assert (jdoc.pop("service"), tdoc.pop("service")) == ("repro.viz.gateway",
                                                          "repro_torch.viz.gateway")
    assert tdoc == jdoc and tdoc["frames"] == tmon.frames_ingested == 24
    st, hdrs, body = _get(tgw.endpoint, "/metrics")
    assert st == 200 and hdrs["content-type"] == _get(jgw.endpoint, "/metrics")[1]["content-type"]
    text = body.decode()
    assert "repro_ws_broadcasts_total" in text and 'server="' in text
    st, _h, body = _get(tgw.endpoint, "/spans")
    assert st == 200 and set(json.loads(body)) == {"enabled", "errors", "procs"}


def test_trace_equals_the_offline_export_and_the_jax_gateways(both, tmp_path):
    (jd, _, jgw), (td, tmon, tgw) = both["jax"], both["port"]
    st, hdrs, body = _get(tgw.endpoint, "/trace")
    assert st == 200 and hdrs["transfer-encoding"] == "chunked"
    assert t_export([td, "-o", str(tmp_path / "t.json")]) == 0
    assert body == (tmp_path / "t.json").read_bytes() == TViz(tmon).trace() \
        == _get(jgw.endpoint, "/trace")[2]


def test_etag_304_and_fresh_after_a_new_frame(tmp_path):
    mon = _run(TMonitor, t_sim, str(tmp_path), n_ranks=1, steps=2)
    gw = TGateway(mon).start()
    try:
        for target in ("/dashboard", "/series?rank=0", "/trace"):
            st, hdrs, body = _get(gw.endpoint, target)
            assert st == 200 and body and hdrs["etag"] == '"2"'
            st2, h2, b2 = _get(gw.endpoint, target, headers=[("If-None-Match", hdrs["etag"])])
            assert (st2, b2, h2["etag"]) == (304, b"", hdrs["etag"])
        gen = t_sim.WorkloadGenerator(t_sim.nwchem_like(anomaly_rate=0.02), n_ranks=1, seed=3)
        mon.ingest(gen.frame(0, 2)[0])
        st3, h3, b3 = _get(gw.endpoint, "/series?rank=0", headers=[("If-None-Match", '"2"')])
        assert st3 == 200 and h3["etag"] == '"3"' and len(json.loads(b3)) == 3
    finally:
        gw.stop()
        mon.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_replay_monitor_serves_a_run_written_by_either_package(both, writer):
    """A finished run dir replays through both packages' ReplayMonitor and
    both gateways answer every view as the live gateways did."""
    td, _, live = both[writer]
    replays = {"jax": JReplay(td), "port": TReplay(td)}
    assert replays["port"].summary() == replays["jax"].summary()
    assert replays["port"].frames_ingested == 24
    gws = {"jax": JGateway(replays["jax"]).start(), "port": TGateway(replays["port"]).start()}
    try:
        for target in _VIEWS:
            want = _get(live.endpoint, target)[2]
            if target.startswith("/provenance"):  # the live docs carry no run_info
                want = json.loads(want)
            for gw in gws.values():
                got = _get(gw.endpoint, target)[2]
                assert (json.loads(got) if isinstance(want, dict) else got) == want, target
    finally:
        for gw in gws.values():
            gw.stop()


def test_replay_cli_serves_the_offline_trace(both):
    td, _, live = both["port"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.viz.gateway", td, "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "PYTHONPATH": os.path.join(REPO, "src")})
    try:
        banner = proc.stdout.readline()
        assert "viz gateway: http://" in banner and "24 frames" in banner, banner
        host, port = banner.split("http://")[1].split("/")[0].split(":")
        st, _h, body = _get((host, int(port)), "/trace")
        assert st == 200 and body == _get(live.endpoint, "/trace")[2]
    finally:
        proc.terminate()
        proc.wait(timeout=10)
        proc.stdout.close()


def test_keep_alive_pipelining_and_malformed_input(both):
    """Two pipelined requests answered in order on one connection; garbage
    answers 400 and closes that connection, and the loop keeps serving."""
    _, _, gw = both["port"]
    s = socket.create_connection(gw.endpoint, timeout=10)
    s.sendall(b"GET /series?rank=0 HTTP/1.1\r\nHost: t\r\n\r\n"
              b"GET /series?rank=1 HTTP/1.1\r\nHost: t\r\nConnection: close\r\n\r\n")
    st1, h1, b1, rest = _read_response(s)
    assert st1 == 200 and h1["connection"] == "keep-alive" and json.loads(b1)
    while b"\r\n\r\n" not in rest:
        rest += s.recv(65536)
    head, _, tail = rest.partition(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 200") and b"connection: close" in head.lower()
    s.close()
    for garbage in (b"NOT EVEN HTTP\r\n\r\n", b"GET /series?ra"):
        s = socket.create_connection(gw.endpoint, timeout=10)
        s.sendall(garbage)
        if garbage.endswith(b"\r\n\r\n"):
            st, hdrs, _b, _r = _read_response(s)
            assert st == 400 and hdrs["connection"] == "close"
            assert s.recv(65536) == b""
        s.close()
        assert _get(gw.endpoint, "/dashboard")[0] == 200


def test_viewer_killed_mid_chunked_trace_stream(tmp_path):
    """Twin of tests/test_viz_gateway.py:893: a viewer that resets in the
    middle of a chunked /trace leaves the loop serving, and a retry gets
    every byte."""
    mon = _run(TMonitor, t_sim, str(tmp_path), n_ranks=4, steps=40)
    gw = TGateway(mon, high_water=8 << 10, low_water=2 << 10).start()
    try:
        want = _get(gw.endpoint, "/trace")[2]
        assert len(want) > 2 * (8 << 10) and want == TViz(mon).trace()
        victim = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        victim.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 10)
        victim.connect(gw.endpoint)
        victim.sendall(b"GET /trace HTTP/1.1\r\nHost: t\r\n\r\n")
        status, hdrs, rest = _read_head(victim)
        assert status == 200 and hdrs.get("transfer-encoding") == "chunked"
        assert rest or victim.recv(1024)
        victim.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER, struct.pack("ii", 1, 0))
        victim.close()
        st, _h, body = _get(gw.endpoint, "/trace")
        assert st == 200 and body == want
    finally:
        gw.stop()
        mon.close()


# ------------------------------------------------------- WebSocket side
def test_many_viewers_receive_identical_sequences(both):
    """8 viewers each receive all 50 broadcasts, in order, byte-identical."""
    _, _, gw = both["port"]
    viewers = [_ws_connect(gw.endpoint) for _ in range(8)]
    _wait(lambda: gw.n_viewers >= 8, what="viewer registration")
    for i in range(50):
        gw.publish_frame(i % 4, i, i % 3, severity=i % 7)
    seqs = [[m.data for m in _recv_msgs(s, dec, 50)] for s, dec, _h in viewers]
    assert all(seq == seqs[0] for seq in seqs)
    assert [json.loads(m)["step"] for m in seqs[0]] == list(range(50))
    for s, _d, _h in viewers:
        s.close()
    _wait(lambda: gw.n_viewers == 0, what="viewer cleanup")


def test_slow_reader_pauses_without_stalling_a_fast_one(tmp_path):
    """Twin of tests/test_viz_gateway.py:684: a viewer that stops reading
    trips the pause counter, a fast one keeps receiving, and once the slow
    one drains the resume counter fires and it gets the whole sequence."""
    mon = _run(TMonitor, t_sim, str(tmp_path), n_ranks=1, steps=2)
    gw = TGateway(mon, high_water=64 << 10, low_water=8 << 10, ws_kill_water=1 << 30).start()
    try:
        slow = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        slow.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8 << 10)
        slow.connect(gw.endpoint)
        slow.sendall(b"GET /ws HTTP/1.1\r\nHost: t\r\nUpgrade: websocket\r\nConnection: "
                     b"Upgrade\r\nSec-WebSocket-Key: aGVsbG8gd29ybGQhIQ==\r\n"
                     b"Sec-WebSocket-Version: 13\r\n\r\n")
        fast, fast_dec, _h = _ws_connect(gw.endpoint)
        _wait(lambda: gw.n_viewers == 2, what="both viewers")
        pauses0, n = gw.backpressure_pauses, 0
        deadline = time.monotonic() + 20
        while gw.backpressure_pauses == pauses0 or n < 10:
            assert time.monotonic() < deadline, "pause counter never tripped"
            gw.publish({"type": "frame", "i": n, "pad": "x" * 32768})
            n += 1
            time.sleep(0.001)
        got = _recv_msgs(fast, fast_dec, n, timeout=30)
        assert [json.loads(m.data)["i"] for m in got] == list(range(n))
        resumes0 = gw.backpressure_resumes
        status, _hdrs, rest = _read_head(slow)
        assert status == 101
        dec = TW.WSDecoder(require_mask=False)
        msgs = dec.feed(rest)
        while len(msgs) < n + 1:
            msgs.extend(dec.feed(slow.recv(1 << 20)))
        assert [json.loads(m.data).get("i") for m in msgs[1:]] == list(range(n))
        assert gw.backpressure_resumes > resumes0
        slow.close()
        fast.close()
    finally:
        gw.stop()
        mon.close()


def test_ws_hello_broadcast_and_violations(both):
    _, mon, gw = both["port"]
    s, dec, hello = _ws_connect(gw.endpoint)
    assert hello == {"type": "hello", "frames": mon.frames_ingested, "viewers": 1}
    gw.publish_frame(2, 17, 3, severity=5)
    (msg,) = _recv_msgs(s, dec, 1)
    payload = json.loads(msg.data)
    metrics, health = payload.pop("metrics"), payload.pop("health")
    assert payload == {"type": "frame", "rank": 2, "step": 17, "n_anomalies": 3, "severity": 5}
    assert health["ok"] is True and metrics["viewers"] == 1
    s.sendall(TW.encode_frame(TW.OP_PING, b"token", mask=os.urandom(4)))
    (pong,) = _recv_msgs(s, dec, 1)
    assert (pong.opcode, pong.data) == (TW.OP_PONG, b"token")
    s.sendall(TW.encode_frame(TW.OP_TEXT, b"\xff\xfe", mask=b"abcd"))
    (close,) = _recv_msgs(s, dec, 1)
    assert close.opcode == TW.OP_CLOSE and close.close_code == 1007
    assert s.recv(65536) == b""
    s.close()
    _wait(lambda: gw.n_viewers == 0, what="viewer cleanup")
    sock = socket.create_connection(gw.endpoint, timeout=10)
    sock.sendall(b"GET /ws HTTP/1.1\r\nHost: t\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                 b"Sec-WebSocket-Key: aGVsbG8=\r\nSec-WebSocket-Version: 8\r\n\r\n")
    assert _read_response(sock)[0] == 426
    sock.close()


def test_hopeless_viewer_shed_with_1013(tmp_path):
    """A viewer whose queue passes ws_kill_water is dropped with close code
    1013 and counted; the gateway keeps serving."""
    mon = _run(TMonitor, t_sim, str(tmp_path), n_ranks=1, steps=2)
    gw = TGateway(mon, high_water=16 << 10, low_water=4 << 10, ws_kill_water=32 << 10).start()
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4 << 10)
        s.connect(gw.endpoint)
        s.sendall(b"GET /ws HTTP/1.1\r\nHost: t\r\nUpgrade: websocket\r\nConnection: Upgrade\r\n"
                  b"Sec-WebSocket-Key: aGVsbG8gd29ybGQhIQ==\r\nSec-WebSocket-Version: 13\r\n\r\n")
        _wait(lambda: gw.n_viewers == 1, what="viewer registration")
        deadline = time.monotonic() + 20
        while gw.viewers_dropped == 0:
            assert time.monotonic() < deadline, "viewer never shed"
            gw.publish({"type": "frame", "pad": "y" * 8192})
            time.sleep(0.002)
        status, _h, rest = _read_head(s)
        assert status == 101
        dec = TW.WSDecoder(require_mask=False)
        msgs = dec.feed(rest)
        s.settimeout(5)
        try:
            while True:
                data = s.recv(1 << 20)
                if not data:
                    break
                msgs.extend(dec.feed(data))
        except socket.timeout:
            pass
        closes = [m for m in msgs if m.opcode == TW.OP_CLOSE]
        assert closes and closes[-1].close_code == TW.CLOSE_TRY_AGAIN == 1013
        s.close()
        assert _get(gw.endpoint, "/dashboard")[0] == 200
    finally:
        gw.stop()
        mon.close()


def test_monitor_viz_serve_broadcasts_every_ingest_and_close_stops_it():
    """Twin of tests/test_viz_gateway.py:864 on the port's monitor."""
    gen = t_sim.WorkloadGenerator(t_sim.nwchem_like(anomaly_rate=0.02), n_ranks=1, seed=1)
    mon = TMonitor(num_funcs=len(gen.registry), registry=gen.registry, min_samples=20,
                   viz_serve=0)
    gw = mon.viz_gateway
    assert isinstance(gw, TGateway)
    s, dec, hello = _ws_connect(gw.endpoint)
    assert hello["frames"] == 0
    for step in range(3):
        mon.ingest(gen.frame(0, step)[0])
    msgs = _recv_msgs(s, dec, 3)
    assert [json.loads(m.data)["step"] for m in msgs] == [0, 1, 2]
    host, port = gw.endpoint
    assert mon.summary()["viz_endpoint"] == f"http://{host}:{port}"
    assert gw.broadcasts == 3
    s.close()
    mon.close()
    assert mon.viz_gateway is None
    with pytest.raises(OSError):
        socket.create_connection((host, port), timeout=1)


def test_serve_with_a_live_viewer_sees_every_frame():
    """The CPU rehearsal of chip_smoke.py's path G: a monitored granite-moe
    smoke ``serve`` with a WebSocket viewer attached; the viewer's frame
    messages equal the gateway's broadcasts and the monitor's frames, and
    the views equal ``VizServer``'s on the same monitor."""
    mon = TMonitor(num_funcs=16, min_samples=8, viz_serve=0)
    gw = mon.viz_gateway
    s, dec, _hello = _ws_connect(gw.endpoint)
    got = []
    t = threading.Thread(target=lambda: got.extend(_recv_msgs(s, dec, 2, timeout=60)))
    t.start()
    out = tserve.serve(arch="granite-moe-1b-a400m", n_requests=4, batch=2, prompt_len=8,
                       max_new=3, monitor=mon, device="cpu")
    t.join(timeout=60)
    assert not t.is_alive()
    assert out["requests"] == 4 and out["monitor"]["frames"] == 2
    assert [json.loads(m.data)["type"] for m in got] == ["frame", "frame"]
    assert gw.broadcasts == mon.frames_ingested == 2
    viz = TViz(mon)
    assert json.loads(_get(gw.endpoint, "/series?rank=0")[2]) == \
        json.loads(json.dumps(viz.frame_series(0)))
    assert _get(gw.endpoint, "/trace")[2] == viz.trace()
    s.close()
    mon.close()


# ---------------------------------------------- chip_smoke.py's path G
def _chip_smoke():
    """chip_smoke.py as a module (it imports no CUDA code at import time)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_gateway_checks_pass_on_a_smoke_serve_and_fail_on_a_lost_frame():
    """Path G's viewer, poller and gateway checks around a granite-moe smoke
    serve on the CPU; a frame the viewer never saw fails the check."""
    cs = _chip_smoke()
    mon = TMonitor(num_funcs=16, min_samples=8, viz_serve=0)
    ep = mon.viz_gateway.endpoint
    viewer, poller = cs.Viewer(ep), cs.Poller(ep, lambda: mon.frames_ingested >= 2)
    try:
        tserve.serve(arch="granite-moe-1b-a400m", n_requests=4, batch=2, prompt_len=8,
                     max_new=3, monitor=mon, device="cpu")
        poller.close()
        assert poller.statuses and {st for _t, st in poller.statuses} == {200}
        got = cs.check_gateway("g", mon, viewer)
        assert got["frames"] == 2 and got["trace_bytes"] == len(TViz(mon).trace())
        assert viewer.kinds["frame"] == 2 + cs.VIZ_PUBLISHES
        mon.frames_ingested += 1  # a frame no viewer received
        with pytest.raises(AssertionError, match="the viewer got"):
            cs.check_gateway("g", mon, viewer)
    finally:
        poller.close()
        viewer.close()
        mon.close()


def test_chip_smoke_classes_device_time_by_kernel_name():
    cs = _chip_smoke()
    got = cs.device_classes({
        "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT": 5.0,
        "void gemmSN_NN_kernel<float, 128, 2, 4, 8, 2, 4, false>": 0.5,
        "void (anonymous namespace)::tc::flash_fwd_wgmma_bf16<64>(CUtensorMap_st,": 1.0,
        "void at::native::bitonicSortKVInPlace<2, -1, 16, 16, float, long>": 0.25,
        "void cub::DeviceRadixSortOnesweepKernel<...>": 0.25,
        "void at::native::index_elementwise_kernel<128, 4, at::native::gpu_index_kernel": 2.0,
        "void at::native::vectorized_gather_kernel<16, long>(char*, char*, long*)": 1.0,
        "void at::native::tensor_kernel_scan_innermost_dim_with_indices<long>": 0.5,
        "void at::native::vectorized_elementwise_kernel<8, at::native::BinaryFunctor>": 3.0,
    })
    assert got == {"flash": 1.0, "gemm": 5.5, "sort": 0.5, "index": 3.0, "scan": 0.5,
                   "elementwise": 3.0}


def test_chip_smoke_moe_smoke_check_replays_the_card_runs_routing():
    """smoke_card_vs_cpu on a MoE model runs on the CPU as it is: the CPU
    run replays the first run's top-k choices (none overridden between two
    CPU runs), and the one-ulp yardstick moves the bf16 logits."""
    cs = _chip_smoke()
    out = cs.smoke_card_vs_cpu(torch.device("cpu"), "granite-moe-1b-a400m", "bfloat16", "t")
    assert out["max_abs_diff"] == out["base_max_abs_diff"] == 0.0
    assert out["routing_choices"] > 0 and out["routing_overridden"] == 0
    assert out["one_ulp_max_abs_diff"] > 0
    f32 = cs.smoke_card_vs_cpu(torch.device("cpu"), "granite-moe-1b-a400m", "float32", "t")
    assert f32["max_abs_diff"] == 0.0 and f32["routing_overridden"] == 0
