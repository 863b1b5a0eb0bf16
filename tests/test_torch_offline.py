"""The port's offline mode (``repro_torch.core.offline``, ``trace.stream``)
against the JAX package's (twin of tests/test_offline.py).

One ``FrameStore`` archive is replayed through both packages' ``replay``:
the summaries are equal, the PS snapshots equal byte for byte, the
provenance docs are the same, and ``compare_runs`` rows and ``report``
text are identical.  Either package reads the archive the other wrote.
"""
import json
import threading

import numpy as np
import pytest

from repro.core import offline as j_off
from repro.core import sim as j_sim
from repro.trace import stream as j_stream
from repro_torch.core import offline as t_off
from repro_torch.core import sim as t_sim
from repro_torch.core.offline import RunProfile, compare_runs, replay, report
from repro_torch.trace import stream as t_stream
from repro_torch.trace.monitor import ChimbukoMonitor
from repro_torch.trace.stream import SSTChannel

_PKG = {"jax": (j_sim, j_stream), "port": (t_sim, t_stream)}


def _make_run(tmp_path, name, slow_factor=1.0, steps=25, ranks=3, pkg="port"):
    """tests/test_offline.py:_make_run through ``pkg``'s sim and FrameStore."""
    sim, stream = _PKG[pkg]
    spec = sim.nwchem_like(anomaly_rate=0.004)
    for f in spec.funcs.values():
        f.anomaly_scale = 40.0
    spec.funcs["SP_GTXPBL"].mean_us *= slow_factor
    gen = sim.WorkloadGenerator(spec, n_ranks=ranks, seed=11)
    store = stream.FrameStore(str(tmp_path / name))
    for step in range(steps):
        for rank in range(ranks):
            frame, _ = gen.frame(rank, step)
            store.write(frame)
    return store, gen.registry


def test_replay_equals_online(tmp_path):
    """Offline replay == the online pipeline on the same frames."""
    store, registry = _make_run(tmp_path, "runA")
    online = ChimbukoMonitor(num_funcs=len(registry), registry=registry,
                             min_samples=30)
    for step in range(25):
        for rank in store.ranks():
            online.ingest(store.read(rank, step))
    offline = replay(store, registry=registry, num_funcs=len(registry),
                     min_samples=30)
    assert offline.summary()["anomalies"] == online.summary()["anomalies"]
    assert offline.summary()["events"] == online.summary()["events"]
    np.testing.assert_allclose(
        offline.ps.snapshot().table[:, :3], online.ps.snapshot().table[:, :3],
        rtol=1e-9,
    )


def test_cross_run_comparison_finds_regression(tmp_path):
    store_a, reg_a = _make_run(tmp_path, "runA", slow_factor=1.0)
    store_b, reg_b = _make_run(tmp_path, "runB", slow_factor=1.6)
    mon_a = replay(store_a, registry=reg_a, num_funcs=len(reg_a), min_samples=30)
    mon_b = replay(store_b, registry=reg_b, num_funcs=len(reg_b), min_samples=30)
    rows = compare_runs(RunProfile.from_monitor("A", mon_a),
                        RunProfile.from_monitor("B", mon_b))
    assert rows, "comparison must produce rows"
    top = rows[0]
    assert top["func"] in ("SP_GTXPBL", "SP_GETXBL"), rows[:3]
    assert top["rel_change"] > 0.3
    txt = report(rows)
    assert "SP_GTXPBL" in txt or "SP_GETXBL" in txt


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_frame_store_reads_the_other_packages_archive(tmp_path, writer):
    store, _ = _make_run(tmp_path, "run", steps=4, ranks=2, pkg=writer)
    readers = [j_stream.FrameStore(store.root), t_stream.FrameStore(store.root)]
    assert readers[0].ranks() == readers[1].ranks() == [0, 1]
    assert readers[0].steps(1) == readers[1].steps(1) == [0, 1, 2, 3]
    for rank in (0, 1):
        for a, b in zip(readers[0].replay(rank), readers[1].replay(rank)):
            assert (a.app, a.rank, a.step) == (b.app, b.rank, b.step)
            assert a.func_events.tobytes() == b.func_events.tobytes()
            assert a.comm_events.tobytes() == b.comm_events.tobytes()
            assert a.func_events.dtype == b.func_events.dtype


def test_sst_channel_streams_frames_in_order():
    """A bounded channel hands frames over in order; close() ends the stream."""
    ch = SSTChannel(capacity=2)
    frames = list(range(5))

    def produce():
        for f in frames:
            ch.put(f)
        ch.close()

    t = threading.Thread(target=produce)
    t.start()
    assert list(ch) == frames
    t.join()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_replay_is_identical_across_packages(tmp_path, writer):
    """Both packages replay one archive to the same summary, PS snapshot
    bytes and provenance docs; the cross-run comparison of two archives
    gives the same rows and the same report text."""
    store_a, _ = _make_run(tmp_path, "runA", pkg=writer)
    store_b, _ = _make_run(tmp_path, "runB", slow_factor=1.6, pkg=writer)
    mons = {}
    for pkg, off, sim in (("jax", j_off, j_sim), ("port", t_off, t_sim)):
        registry = sim.WorkloadGenerator(sim.nwchem_like(), n_ranks=1, seed=0).registry
        store = (j_stream if pkg == "jax" else t_stream).FrameStore
        prov = str(tmp_path / f"{pkg}.jsonl")
        mons[pkg] = [off.replay(store(s.root), registry=registry, num_funcs=len(registry),
                                min_samples=30, prov_path=p, ps_shards=2, provdb_shards=2)
                     for s, p in ((store_a, prov), (store_b, None))]
    (ja, jb), (ta, tb) = mons["jax"], mons["port"]
    assert ta.summary() == ja.summary() and ta.summary()["anomalies"] > 0
    assert tb.summary() == jb.summary()
    assert ta.ps.snapshot().table.tobytes() == ja.ps.snapshot().table.tobytes()
    assert tb.ps.snapshot().table.tobytes() == jb.ps.snapshot().table.tobytes()
    assert ta.provdb.records == ja.provdb.records
    j_rows = j_off.compare_runs(j_off.RunProfile.from_monitor("A", ja),
                                j_off.RunProfile.from_monitor("B", jb))
    t_rows = t_off.compare_runs(t_off.RunProfile.from_monitor("A", ta),
                                t_off.RunProfile.from_monitor("B", tb))
    assert json.dumps(t_rows) == json.dumps(j_rows) and t_rows
    assert t_off.report(t_rows) == j_off.report(j_rows)
    for m in (ja, jb, ta, tb):
        m.close()
    docs = [[line for f in sorted(tmp_path.glob(f"{pkg}*.jsonl"))
             for line in f.read_text().splitlines() if '"run_info"' not in line]
            for pkg in ("jax", "port")]
    assert docs[0] == docs[1] and docs[0]
