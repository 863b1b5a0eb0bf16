"""The port's ``repro_torch.fault`` against the JAX package's (twin of
tests/test_fault.py).

Every test of tests/test_fault.py runs here on the port's copies: the WAL
(record/CRC discipline, torn tails, compaction, bit-exact replay), the
backoff policy, chaos determinism, the dial loop, the supervised pool and
the end-to-end SIGKILL runs at S in {1, 2, 4}, whose PS snapshot and
provenance JSONL files byte-match a no-fault run.  The WAL format is
shared: a log either package writes replays in the other to a
bit-identical table, and the same pushes write the same bytes.
"""
import multiprocessing
import os
import socket
import struct
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

from repro.core.ps import PSShard as JShard
from repro.fault import wal as JW
from repro_torch.core.provenance import shard_paths
from repro_torch.core.ps import PSShard
from repro_torch.core.sim import WorkloadGenerator, nwchem_like
from repro_torch.core.stats import StatsTable
from repro_torch.fault.chaos import ChaosStream, FlakyProxy, kill_process, tear_tail
from repro_torch.fault.policy import DEFAULT_POLICY, RetryPolicy, backoff_delay
from repro_torch.fault.wal import PSWal, read_wal_records, wal_path
from repro_torch.launch.shard_server import LocalShardHost, ShardServerPool
from repro_torch.net import ConnectionLost, RPCClient
from repro_torch.net.shards import RemotePSShard
from repro_torch.trace.monitor import ChimbukoMonitor

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _subproc_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timeout waiting for {what}"
        time.sleep(0.02)


def _rand_push(rng, F):
    """One sparse delta in exactly the form the remote stub ships."""
    n = int(rng.integers(1, 50))
    delta = StatsTable(F).update_batch(
        rng.integers(0, F, n), rng.lognormal(3.0, 1.0, n)
    )
    idx = np.flatnonzero(delta[:, 0] > 0).astype(np.int64)
    return idx, np.ascontiguousarray(delta[idx])


# ================================================================== policy
def test_backoff_delay_capped_exponential():
    assert [backoff_delay(k, 0.05, 2.0) for k in range(8)] == [
        0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 2.0, 2.0
    ]
    # pure function of the attempt index: no jitter between evaluations
    assert backoff_delay(3, 0.05, 2.0) == backoff_delay(3, 0.05, 2.0)


def test_retry_policy_delay_schedule():
    p = RetryPolicy(retries=6, base_delay=0.1, max_delay=1.0)
    assert list(p.delays()) == [0.1, 0.2, 0.4, 0.8, 1.0, 1.0]
    assert len(list(DEFAULT_POLICY.delays())) == DEFAULT_POLICY.retries


# =================================================================== chaos
def test_chaos_stream_deterministic():
    a, b = ChaosStream(1234), ChaosStream(1234)
    assert [a.next_u64() for _ in range(64)] == [b.next_u64() for _ in range(64)]
    assert [ChaosStream(1).below(10) for _ in range(4)] != [
        ChaosStream(2).below(10) for _ in range(4)
    ]
    c = ChaosStream(7)
    assert all(0 <= c.below(13) < 13 for _ in range(200))
    assert ChaosStream(9).pick(["x", "y", "z"]) == ChaosStream(9).pick(["x", "y", "z"])


def test_tear_tail(tmp_path):
    p = str(tmp_path / "f.bin")
    with open(p, "wb") as f:
        f.write(b"x" * 100)
    assert tear_tail(p, 30) == 70
    assert os.path.getsize(p) == 70
    assert tear_tail(p, 1000) == 0  # clamps at empty, never negative


# ===================================================================== WAL
def test_wal_replay_bitexact_with_growth_and_dedup(tmp_path):
    """The durability contract: restart + replay == the pre-crash table,
    bit for bit, including mid-stream growth; the seq horizon survives so
    replayed (duplicate) deliveries after restart are exact no-ops."""
    p = wal_path(str(tmp_path), 0)
    sh = PSShard(0, 1, 31, wal=PSWal(p, reset=True))
    rng = np.random.default_rng(5)
    for k in range(25):
        idx, rows = _rand_push(rng, 31)
        sh.push_rows(idx, rows, 31, seq=k)
    sh.grow(57)
    for k in range(25, 40):
        idx, rows = _rand_push(rng, 57)
        sh.push_rows(idx, rows, 57, seq=k)
    want = sh.stats.table.copy()
    n_pushes = sh.n_pushes
    sh.close()

    re = PSShard(0, 1, 31, wal=PSWal(p))
    assert re.stats.table.tobytes() == want.tobytes()
    assert re.stats.num_funcs == 57
    assert re.last_push_seq == 39
    assert re.n_pushes == n_pushes
    # duplicate delivery (a post-crash client replay) is skipped exactly
    idx, rows = _rand_push(rng, 57)
    re.push_rows(idx, rows, 57, seq=17)
    assert re.stats.table.tobytes() == want.tobytes()
    re.close()


def test_wal_torn_tail_truncated_then_replay_converges(tmp_path):
    """Crash mid-append leaves a torn final record: load() truncates back
    to the last intact one, and the client's replay of that (unacked)
    push re-applies it — converging on the exact full table."""
    p = wal_path(str(tmp_path), 0)
    sh = PSShard(0, 1, 23, wal=PSWal(p, reset=True))
    rng = np.random.default_rng(9)
    for k in range(10):
        idx, rows = _rand_push(rng, 23)
        sh.push_rows(idx, rows, 23, seq=k)
    before_last = sh.stats.table.copy()
    last_idx, last_rows = _rand_push(rng, 23)
    sh.push_rows(last_idx, last_rows, 23, seq=10)
    full = sh.stats.table.copy()
    sh.close()

    tear_tail(p, 5)  # rip bytes out of the final record
    re = PSShard(0, 1, 23, wal=PSWal(p))
    assert re.stats.table.tobytes() == before_last.tobytes()
    assert re.last_push_seq == 9
    # the stub's recovery replays the unacked push: exact convergence
    re.push_rows(last_idx, last_rows, 23, seq=10)
    assert re.stats.table.tobytes() == full.tobytes()
    re.close()


def test_wal_reader_stops_at_corruption(tmp_path):
    """A flipped byte mid-file fails that record's CRC; the reader keeps
    the intact prefix and reports the offset it ends at."""
    p = str(tmp_path / "c.wal")
    w = PSWal(p, reset=True)
    w.load()
    w.append_conf(0, 1, 8)
    offsets = [os.path.getsize(p)]
    for k in range(5):
        w.append_grow(8 + k)
        offsets.append(os.path.getsize(p))
    w.close()
    full, good = read_wal_records(p)
    assert len(full) == 6 and good == offsets[-1]

    with open(p, "rb+") as f:  # corrupt record 3's payload
        f.seek(offsets[2] + 10)
        b = f.read(1)
        f.seek(offsets[2] + 10)
        f.write(bytes([b[0] ^ 0xFF]))
    prefix, good2 = read_wal_records(p)
    assert len(prefix) == 3 and good2 == offsets[2]
    assert prefix == full[:3]


def test_wal_compaction_bounded_and_bitexact(tmp_path):
    """Compaction folds the log into CONF+SNAP without perturbing replay:
    the compacted file stays bounded and reopens to the identical state
    (table, n_pushes, seq horizon) as an unlogged twin shard."""
    p = wal_path(str(tmp_path), 0)
    sh = PSShard(0, 1, 19, wal=PSWal(p, compact_every=8, reset=True))
    twin = PSShard(0, 1, 19)
    rng = np.random.default_rng(3)
    sizes = []
    for k in range(64):
        idx, rows = _rand_push(rng, 19)
        sh.push_rows(idx, rows, 19, seq=k)
        twin.push_rows(idx, rows, 19, seq=k)
        sizes.append(os.path.getsize(p))
    assert sh.stats.table.tobytes() == twin.stats.table.tobytes()
    # the log was rewritten at least once: size is not monotone
    assert any(b < a for a, b in zip(sizes, sizes[1:]))
    n_pushes = sh.n_pushes
    sh.close()

    re = PSShard(0, 1, 19, wal=PSWal(p, compact_every=8))
    assert re.stats.table.tobytes() == twin.stats.table.tobytes()
    assert re.n_pushes == n_pushes
    assert re.last_push_seq == 63
    re.close()


# =============================================================== dial loop
def test_reconnect_backoff_schedule(monkeypatch):
    """Reconnect-storm regression: the dial loop sleeps the shared capped-
    exponential schedule — not a fixed period — and it is deterministic."""
    sleeps = []
    monkeypatch.setattr("repro_torch.net.client.time.sleep", sleeps.append)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens here: every dial is refused
    with pytest.raises(ConnectionLost):
        RPCClient(("127.0.0.1", port), connect_retries=7,
                  retry_delay=0.25, retry_delay_max=2.0)
    assert sleeps == [0.25, 0.5, 1.0, 2.0, 2.0, 2.0]
    # a storm of N clients decays to one dial per client per cap period:
    # total sleep budget is sum of the capped schedule, not N * fixed-rate
    assert sum(sleeps) == pytest.approx(7.75)


def test_try_dial_single_attempt(monkeypatch):
    """try_dial (the degraded-mode probe) spends exactly one attempt and
    restores the blocking paths' full retry budget."""
    sleeps = []
    host = LocalShardHost(1, kind="ps")
    cli = RPCClient(host.endpoints[0], connect_retries=3, retry_delay=0.01)
    host.stop()
    monkeypatch.setattr("repro_torch.net.client.time.sleep", sleeps.append)
    with pytest.raises(ConnectionLost):
        cli.call("ps.stats", {})  # detect the drop; blocking redial fails
    n0 = len(sleeps)
    assert cli.try_dial() is False
    assert len(sleeps) == n0  # the probe added no backoff sleeps
    assert cli.connect_retries == 3
    cli.close()


# ============================================================== flaky wire
def test_flaky_proxy_drop_and_torn_frame_recovery(tmp_path):
    """Connection drops and torn frames at exact seed-chosen wire-frame
    ordinals: the stub's window replays every unacked push after each
    recovery, and seq dedup keeps the re-sends exactly-once — the final
    table byte-matches an unfaulted local twin."""
    F = 29
    cs = ChaosStream(42)
    drop = 4 + cs.below(8)            # mid-stream connection kill
    trunc = 20 + cs.below(8)          # torn frame later on
    with LocalShardHost(1, kind="ps") as host:
        with FlakyProxy(host.endpoints[0], drop_at=(drop,),
                        truncate_at=(trunc,)) as proxy:
            stub = RemotePSShard(
                proxy.endpoint, 0, 1, F, wal_dir=str(tmp_path),
                policy=RetryPolicy(retries=8, base_delay=0.02),
            )
            twin = PSShard(0, 1, F)
            rng = np.random.default_rng(1)
            for k in range(40):
                idx, rows = _rand_push(rng, F)
                stub.push_sparse_nowait(idx, rows, F)
                twin.push_rows(idx, rows, F, seq=k)
            stub.drain()
            got = stub.peek_table()
            assert proxy.faults == 2
            assert got.tobytes() == twin.stats.table.tobytes()
            stub.close()


# ==================================================================== pool
def test_pool_supervisor_respawns_on_same_endpoint():
    with ShardServerPool(2, kind="both", supervise=True,
                         supervise_poll=0.05) as pool:
        eps = list(pool.endpoints)
        victim = pool.procs[1]
        kill_process(victim)
        _wait(lambda: pool.restarts >= 1, what="supervisor respawn")
        _wait(lambda: pool.procs[1].is_alive(), what="respawned worker")
        assert pool.endpoints == eps  # same address: stubs keep dialing it
        assert pool.procs[1].pid != victim.pid
        # ...and the respawn actually serves on that endpoint
        cli = RPCClient(tuple(eps[1]), connect_retries=40, retry_delay=0.05)
        env, _ = cli.call("metrics.snapshot")
        assert isinstance(env, dict)
        cli.close()


def test_pool_spawn_failure_leaks_nothing():
    """A worker that cannot bind kills the whole construction — and the
    already-spawned siblings with it; no process outlives the raise."""
    blocker = socket.socket()
    blocker.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    taken = blocker.getsockname()[1]
    try:
        with pytest.raises(RuntimeError, match="shard worker"):
            # worker 0 gets taken-1 (normally free), worker 1 collides
            ShardServerPool(2, kind="ps", port_base=taken - 1,
                            spawn_timeout=30.0)
    finally:
        blocker.close()
    _wait(lambda: not multiprocessing.active_children(),
          what="no orphan workers")


def test_pool_x_dev_teardown_clean():
    """Full lifecycle — spawn, SIGKILL, supervised respawn, stop — under
    ``-X dev -W error``: exit 0 with no ResourceWarning means no leaked
    process handles, pipe fds, or sockets."""
    script = textwrap.dedent("""
        import gc, os, signal, time
        from repro_torch.launch.shard_server import ShardServerPool

        pool = ShardServerPool(2, kind="both", supervise=True,
                               supervise_poll=0.05)
        os.kill(pool.procs[0].pid, signal.SIGKILL)
        pool.procs[0].join(10)
        deadline = time.monotonic() + 30
        while pool.restarts < 1:
            assert time.monotonic() < deadline, "no respawn"
            time.sleep(0.02)
        pool.stop()
        assert pool.procs == []
        gc.collect()
        print("TEARDOWN-OK")
    """)
    out = subprocess.run(
        [sys.executable, "-X", "dev", "-W", "error", "-c", script],
        capture_output=True, text=True, timeout=120, env=_subproc_env(),
    )
    assert out.returncode == 0, out.stderr
    assert "TEARDOWN-OK" in out.stdout
    assert "ResourceWarning" not in out.stderr


# ============================================================== end-to-end
def _chaos_run(tmp, S, kills):
    """One full monitored run over socket transport; ``kills`` is a list
    of (frame_ordinal, worker_index) SIGKILLs injected mid-stream."""
    prov = os.path.join(tmp, "prov.jsonl")
    with ShardServerPool(S, kind="both", supervise=True,
                         supervise_poll=0.05) as pool:
        mon = ChimbukoMonitor(
            num_funcs=64, prov_path=prov, min_samples=8, alpha=6.0,
            provdb_shards=S,
            ps_transport="socket", provdb_transport="socket",
            shard_endpoints=pool.endpoints,
            ps_wal_dir=os.path.join(tmp, "wal"),
            fault_policy=RetryPolicy(retries=8, base_delay=0.05),
            run_info={"timestamp": 0.0},
        )
        spec = nwchem_like(anomaly_rate=0.02)
        for f in spec.funcs.values():
            f.anomaly_scale = 40.0
        gen = WorkloadGenerator(spec, n_ranks=3, seed=0)
        kill_at = dict(kills)
        nframe = 0
        for step in range(15):
            for rank in range(3):
                mon.ingest(gen.frame(rank, step)[0])
                nframe += 1
                if nframe in kill_at:
                    kill_process(pool.procs[kill_at[nframe]])
        snap = mon.ps.snapshot().table.copy()
        summ = mon.summary()
        mon.close()
        files = {}
        for path in shard_paths(prov, S):  # prov.jsonl, or prov.shard<s>.jsonl
            with open(path, "rb") as f:
                files[os.path.basename(path)] = f.read()
        return snap, summ, files, pool.restarts


@pytest.mark.parametrize("S", [1, 2, 4])
def test_chaos_kill_bitexact_recovery(tmp_path, S):
    """Acceptance: SIGKILL a live PS/prov worker at seed-chosen frames
    mid-run; the supervisor respawns it, WAL/JSONL replay restores it,
    and the finished run byte-matches a no-fault run — PS snapshot and
    every provenance JSONL file — with the same anomaly count."""
    from repro_torch.core.provenance import static_provenance

    static_provenance()  # settle lazy env mutations (the torch import and its
    # CUDA probe) so both runs' provenance headers capture the identical environment
    cs = ChaosStream(2024 + S)
    kills = [
        (10 + cs.below(10), cs.below(S)),   # a PS/prov worker, early
        (28 + cs.below(10), cs.below(S)),   # another (maybe same), later
    ]
    ref_dir, kill_dir = str(tmp_path / "ref"), str(tmp_path / "kill")
    os.makedirs(ref_dir)
    os.makedirs(kill_dir)
    ref_snap, ref_summ, ref_files, _ = _chaos_run(ref_dir, S, [])
    snap, summ, files, restarts = _chaos_run(kill_dir, S, kills)

    assert restarts >= 1, "supervisor never respawned a killed worker"
    assert snap.tobytes() == ref_snap.tobytes(), "PS snapshot diverged"
    assert set(files) == set(ref_files) and len(ref_files) == S
    for name in ref_files:
        assert files[name] == ref_files[name], f"{name} diverged"
    assert summ["anomalies"] == ref_summ["anomalies"] > 0
    assert "health" in summ and summ["health"]["ok"] in (True, False)


# ============================================ the WAL format across packages
def _logged_pushes(Shard, Wal, path, F=31, grow=57, **wal_kw):
    """A logged shard fed one seeded stream of sparse pushes, a grow, more
    pushes; returns (table bytes, n_pushes, last seq) before close."""
    sh = Shard(0, 1, F, wal=Wal(path, reset=True, **wal_kw))
    rng = np.random.default_rng(7)
    for k in range(20):
        idx, rows = _rand_push(rng, F)
        sh.push_rows(idx, rows, F, seq=k)
    sh.grow(grow)
    for k in range(20, 34):
        idx, rows = _rand_push(rng, grow)
        sh.push_rows(idx, rows, grow, seq=k)
    out = (sh.stats.table.tobytes(), sh.n_pushes, sh.last_push_seq)
    sh.close()
    return out


_PACKAGES = {"jax": (JShard, JW.PSWal), "port": (PSShard, PSWal)}


@pytest.mark.parametrize("compact_every", [0, 8])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_wal_cross_replay_bitexact(tmp_path, writer, reader, compact_every):
    """A WAL one package wrote replays in the other package's PSShard to a
    bit-identical table, push count and seq horizon (compacted or not)."""
    wal_kw = {"compact_every": compact_every} if compact_every else {}
    p = wal_path(str(tmp_path), 0)
    want = _logged_pushes(*_PACKAGES[writer], p, **wal_kw)
    Shard, Wal = _PACKAGES[reader]
    re = Shard(0, 1, 31, wal=Wal(p, **wal_kw))
    assert (re.stats.table.tobytes(), re.n_pushes, re.last_push_seq) == want
    assert re.stats.num_funcs == 57
    re.close()


def test_wal_bytes_identical_across_packages(tmp_path):
    """The same pushes write the same log, byte for byte, in both packages."""
    pj = JW.wal_path(str(tmp_path / "jax"), 0)
    pt = wal_path(str(tmp_path / "port"), 0)
    assert os.path.relpath(pj, tmp_path / "jax") == os.path.relpath(pt, tmp_path / "port")
    assert _logged_pushes(*_PACKAGES["jax"], pj) == _logged_pushes(*_PACKAGES["port"], pt)
    with open(pj, "rb") as fj, open(pt, "rb") as ft:
        assert fj.read() == ft.read()
    assert read_wal_records(pt) == JW.read_wal_records(pj)
