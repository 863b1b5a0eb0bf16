"""Port's copy of ``repro.export`` (and ``viz.server``) vs the JAX package's.

The same frames go through both packages' writers and monitors: the
Chrome trace (``trace.json``), the persisted record stream
(``stream.jsonl``) and the export CLI's output must be byte-identical, and
the port's writer reproduces the committed golden trace.
"""
import gzip
import io
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import sim as j_sim  # noqa: E402
from repro.export import cli as j_cli  # noqa: E402
from repro.export.record_stream import iter_stream_frames as j_iter  # noqa: E402
from repro.trace.monitor import ChimbukoMonitor as JMonitor  # noqa: E402
from repro.viz.server import VizServer as JViz  # noqa: E402
from repro_torch.core import sim as t_sim  # noqa: E402
from repro_torch.core.events import empty_exec_records  # noqa: E402
from repro_torch.export import cli as t_cli  # noqa: E402
from repro_torch.export import provenance_export as t_prov  # noqa: E402
from repro_torch.export.chrome_trace import ChromeTraceWriter, validate_trace  # noqa: E402
from repro_torch.export.record_stream import iter_stream_frames as t_iter  # noqa: E402
from repro_torch.telemetry import spans as tspans  # noqa: E402
from repro_torch.trace.monitor import ChimbukoMonitor as TMonitor  # noqa: E402
from repro_torch.viz.server import VizServer as TViz  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "data", "golden_trace.json")


def _recs(rows, rank=0, tid=0):
    """(fid, entry, exit, depth[, label]) rows -> EXEC_RECORD_DTYPE array
    (tests/test_export.py:_recs on the port's events module)."""
    out = empty_exec_records(len(rows))
    for i, row in enumerate(rows):
        fid, entry, exit_, depth = row[:4]
        out["fid"][i], out["entry"][i], out["exit"][i] = fid, entry, exit_
        out["runtime"][i] = exit_ - entry
        out["depth"][i] = depth
        out["label"][i] = row[4] if len(row) > 4 else 0
    out["rank"] = rank
    out["tid"] = tid
    return out


def golden_trace_bytes() -> bytes:
    """tests/test_export.py:golden_trace_bytes through the port's writer."""
    buf = io.StringIO()
    w = ChromeTraceWriter(out=buf)
    names = {1: "main", 2: "solve", 3: "io"}
    w.add_frame(0, 0, _recs([(2, 10, 40, 2, 1), (3, 60, 70, 3), (3, 50, 90, 2)]),
                names, anomalies=[(0, 7, 4)], n_records=5, n_anomalies=1, ts=90)
    w.add_frame(0, 1, _recs([(2, 120, 140, 2), (1, 0, 150, 1)]),
                names, n_records=2, n_anomalies=0, ts=150)
    w.add_frame(1, 0, _recs([(2, 30, 60, 1)], rank=1, tid=9), names,
                n_records=1, n_anomalies=0, ts=60)
    comm = {"partner": 1, "nbytes": 64, "tag": 5}
    w.flow_start(0, 0, "msg", 35, 1, args=comm)
    w.flow_finish(1, 9, "msg", 45, 1, args={**comm, "partner": 0})
    w.close()
    return buf.getvalue().encode("utf-8")


def test_golden_trace_locked():
    """Twin of tests/test_export.py:99: the committed golden file, byte for byte."""
    data = golden_trace_bytes()
    assert data == golden_trace_bytes()
    with open(GOLDEN, "rb") as f:
        assert data == f.read()
    validate_trace(json.loads(data))


def _run(Monitor, sim, td, n_ranks=4, steps=10, seed=3, **kw):
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


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    """The same workload through both monitors, with live trace export;
    -> {package: (dir, /trace bytes)}."""
    out = {}
    for name, Monitor, sim, Viz in (("jax", JMonitor, j_sim, JViz),
                                    ("port", TMonitor, t_sim, TViz)):
        td = str(tmp_path_factory.mktemp(name))
        mon = _run(Monitor, sim, td, export_trace=os.path.join(td, "trace_live.json"))
        viz = Viz(mon).trace()
        mon.close()
        out[name] = (td, viz)
    return out


@pytest.mark.parametrize("name", ["stream.jsonl", "trace_live.json"])
def test_monitor_files_are_byte_identical_to_jax(both_runs, name):
    (jd, _), (td, _) = both_runs["jax"], both_runs["port"]
    with open(os.path.join(jd, name), "rb") as f, open(os.path.join(td, name), "rb") as g:
        want, got = f.read(), g.read()
    assert got == want and len(got) > 1000


def test_live_offline_and_viz_trace_identical_across_packages(both_runs, tmp_path):
    """Twin of tests/test_export.py:238, held to the JAX run's bytes too."""
    (jd, jviz), (td, tviz) = both_runs["jax"], both_runs["port"]
    with open(os.path.join(td, "trace_live.json"), "rb") as f:
        live = f.read()
    assert t_cli.main([td, "-o", str(tmp_path / "t.json")]) == 0
    assert j_cli.main([jd, "-o", str(tmp_path / "j.json")]) == 0
    offline = (tmp_path / "t.json").read_bytes()
    assert live == offline == tviz == jviz == (tmp_path / "j.json").read_bytes()
    counts = validate_trace(json.loads(live))
    assert counts["durations"] > 0 and counts["instants"] > 0


def test_export_cli_outputs_are_byte_identical_to_jax(both_runs, tmp_path, capsys):
    (jd, _), (td, _) = both_runs["jax"], both_runs["port"]
    for gz in ([], ["--gzip"]):
        sfx = ".json.gz" if gz else ".json"
        assert t_cli.main([td, "-o", str(tmp_path / f"t{sfx}")] + gz) == 0
        assert j_cli.main([jd, "-o", str(tmp_path / f"j{sfx}")] + gz) == 0
        assert (tmp_path / f"t{sfx}").read_bytes() == (tmp_path / f"j{sfx}").read_bytes()
    with gzip.open(tmp_path / "t.json.gz", "rb") as f:
        assert f.read() == (tmp_path / "t.json").read_bytes()
    # provenance windows: same docs (the header lines differ: torch vs jax)
    assert t_cli.main([td, "--provenance", "-o", str(tmp_path / "tp.json")]) == 0
    assert j_cli.main([jd, "--provenance", "-o", str(tmp_path / "jp.json")]) == 0
    assert (tmp_path / "tp.json").read_bytes() == (tmp_path / "jp.json").read_bytes()
    capsys.readouterr()
    assert t_cli.main(["--validate", str(tmp_path / "t.json")]) == 0
    tcounts = json.loads(capsys.readouterr().out)
    assert j_cli.main(["--validate", str(tmp_path / "j.json")]) == 0
    assert tcounts == json.loads(capsys.readouterr().out) and tcounts["durations"] > 0


def test_stream_readers_agree_across_packages(both_runs):
    (jd, _), (td, _) = both_runs["jax"], both_runs["port"]
    jframes = list(j_iter(os.path.join(jd, "stream.jsonl")))
    tframes = list(t_iter(os.path.join(jd, "stream.jsonl")))  # the port reads JAX's file
    assert len(tframes) == len(jframes) == 40
    for a, b in zip(tframes, jframes):
        assert (a["rank"], a["step"], a["ts"]) == (b["rank"], b["step"], b["ts"])
        assert a["records"].tobytes() == b["records"].tobytes()
    assert [f["records"].tobytes() for f in t_iter(os.path.join(td, "stream.jsonl"))] == \
        [f["records"].tobytes() for f in jframes]


def test_span_rendering_closes_into_a_valid_trace(tmp_path):
    """export_trace with spans on renders the monitor's own flight recorder
    at close (shard processes wait for item 2b)."""
    td = str(tmp_path)
    tspans.set_enabled(True)
    try:
        mon = _run(TMonitor, t_sim, td, trace_spans=True,
                   export_trace=os.path.join(td, "trace.json"))
        mon.close()
    finally:
        tspans.set_enabled(False)
    with open(os.path.join(td, "trace.json")) as f:
        doc = json.load(f)
    assert validate_trace(doc)["durations"] > 0
    assert any(e["ph"] == "X" and e.get("cat") == "span" for e in doc["traceEvents"])


def test_live_queries_wait_for_the_socket_transport(tmp_path):
    with pytest.raises(NotImplementedError, match="item 2"):
        t_prov.query_live_endpoints([("127.0.0.1", 1)], rank=0)
    with pytest.raises(NotImplementedError, match="item 2"):
        t_cli.main(["--provenance", "--endpoints", "127.0.0.1:1"])
    assert np.dtype(empty_exec_records(0).dtype) == np.dtype(empty_exec_records(3).dtype)
