"""The port's exposition, build info and shard federation against the JAX
package's (twin of the exposition, parse and federation tests of
tests/test_telemetry.py).

The same registry renders to byte-identical Prometheus text in both
packages, each parses the other's, and the port's shard workers answer
``metrics.snapshot`` as the original's do.  ``build_info`` labels torch
where the original labels jax.
"""
import os
import subprocess
import sys

import pytest

from repro import telemetry as jtm
from repro_torch.telemetry import (
    CONTENT_TYPE,
    MetricRegistry,
    get_registry,
    is_enabled,
    merge_snapshots,
    parse_exposition,
    render_exposition,
)
from repro_torch.telemetry import buildinfo

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _sample_registry(Registry=MetricRegistry):
    """tests/test_telemetry.py:_sample_registry on either package."""
    reg = Registry()
    reg.counter("req_total", "requests", ["method"]).labels(method="get").inc(3)
    reg.gauge("depth", "queue depth").set(2)
    h = reg.histogram("lat_us", "latency", ["server"]).labels(server="a:1")
    for v in (1, 5, 1000):
        h.observe(v)
    return reg


def test_render_parse_roundtrip_line_by_line():
    text = render_exposition(_sample_registry().snapshot())
    assert text.endswith("\n")
    for i, line in enumerate(text.splitlines(), 1):
        assert line.startswith("# ") or " " in line, f"line {i}: {line!r}"
    fams = parse_exposition(text)
    assert set(fams) == {"req_total", "depth", "lat_us"}
    assert fams["req_total"]["type"] == "counter"
    assert fams["lat_us"]["type"] == "histogram"
    samples = {n: (l, v) for n, l, v in fams["req_total"]["samples"]}
    assert samples["req_total"] == ({"method": "get"}, 3.0)
    names = [n for n, _l, _v in fams["lat_us"]["samples"]]
    assert "lat_us_sum" in names and "lat_us_count" in names
    inf_bucket = [
        v for n, l, v in fams["lat_us"]["samples"]
        if n == "lat_us_bucket" and l.get("le") == "+Inf"
    ]
    assert inf_bucket == [3.0]
    assert "version=0.0.4" in CONTENT_TYPE


def test_parse_rejects_malformed_expositions():
    with pytest.raises(ValueError):
        parse_exposition("not a metric line at all !!!\n")
    with pytest.raises(ValueError):
        parse_exposition("9bad_name 1\n")
    bad_hist = (
        "# TYPE h histogram\n"
        'h_bucket{le="1"} 5\n'
        'h_bucket{le="2"} 3\n'
        'h_bucket{le="+Inf"} 5\n'
        "h_sum 9\n"
        "h_count 5\n"
    )
    with pytest.raises(ValueError):
        parse_exposition(bad_hist)
    with pytest.raises(ValueError):
        parse_exposition(
            "# TYPE h histogram\n" 'h_bucket{le="1"} 5\n' "h_sum 9\nh_count 5\n"
        )


@pytest.mark.parametrize("registry_pkg", ["jax", "port"])
def test_exposition_byte_identical_across_packages(registry_pkg):
    """One registry's snapshot renders to the same bytes through both
    renderers, merged under proc labels too, and both parsers agree."""
    reg = _sample_registry(jtm.MetricRegistry if registry_pkg == "jax" else MetricRegistry)
    snap = reg.snapshot()
    text = render_exposition(snap)
    assert text == jtm.render_exposition(snap)
    assert parse_exposition(text) == jtm.parse_exposition(text)
    merged = merge_snapshots([snap, snap], proc_label=["gateway", "shard0"])
    assert merged == jtm.merge_snapshots([snap, snap], proc_label=["gateway", "shard0"])
    assert render_exposition(merged) == jtm.render_exposition(merged)
    port_text = render_exposition(_sample_registry().snapshot())
    assert port_text == jtm.render_exposition(_sample_registry(jtm.MetricRegistry).snapshot())


def test_validate_cli(tmp_path):
    good = tmp_path / "m.txt"
    good.write_text(render_exposition(_sample_registry().snapshot()))
    bad = tmp_path / "bad.txt"
    bad.write_text("9bad_name 1\n")
    env = {**os.environ, "PYTHONPATH": SRC + os.pathsep + os.environ.get("PYTHONPATH", "")}
    outs = [subprocess.run([sys.executable, "-m", pkg, "--validate", str(p)],
                           capture_output=True, text=True, timeout=60, env=env)
            for pkg in ("repro_torch.telemetry", "repro.telemetry") for p in (good, bad)]
    assert [o.returncode for o in outs] == [0, 1, 0, 1]
    assert outs[0].stdout == outs[2].stdout and outs[0].stdout.startswith("OK: 3 families")


def test_build_info_labels_torch_where_the_original_labels_jax():
    import torch

    info = buildinfo.build_info()
    want = jtm.build_info()
    assert set(info) == (set(want) - {"jax"}) | {"torch"}
    assert info["torch"] == torch.__version__
    for key in ("git_sha", "python", "numpy"):
        assert info[key] == want[key]
    assert is_enabled()
    labels = buildinfo.register_build_info()
    fams = parse_exposition(render_exposition(get_registry().snapshot()))
    (sample,) = fams["repro_build_info"]["samples"]
    assert sample[1] == labels and sample[2] == 1.0


def test_metrics_federated_from_out_of_process_shards():
    """tests/test_telemetry.py:278 on the port: two out-of-process shard
    workers behind a socket-transport monitor, scraped with the reserved
    ``metrics.snapshot`` verb and merged under ``proc`` labels (the
    original then serves the merge at the viz gateway's /metrics, which
    waits for ROADMAP.md queue 1, item 2d)."""
    from repro_torch.core.sim import WorkloadGenerator, nwchem_like
    from repro_torch.launch.shard_server import ShardServerPool
    from repro_torch.telemetry.federate import federated_snapshot, fetch_shard_snapshot
    from repro_torch.trace.monitor import ChimbukoMonitor

    spec = nwchem_like(anomaly_rate=0.05)
    for f in spec.funcs.values():
        f.anomaly_scale = 40.0
    gen = WorkloadGenerator(spec, n_ranks=2, seed=3)
    with ShardServerPool(2, kind="both") as pool:
        monitor = ChimbukoMonitor(
            num_funcs=len(gen.registry), registry=gen.registry, min_samples=4,
            ps_transport="socket", provdb_transport="socket",
            shard_endpoints=pool.endpoints,
        )
        try:
            for step in range(4):
                for rank in range(2):
                    frame, _ = gen.frame(rank, step)
                    monitor.ingest(frame)
            shard_snap = fetch_shard_snapshot(pool.endpoints[0])
            assert "repro_rpc_latency_us" in shard_snap
            assert "repro_loop_lag_us" in shard_snap
            merged, errors = federated_snapshot(pool.endpoints, local_proc="gateway")
            assert errors == []
            fams = parse_exposition(render_exposition(merged))
            for family in (
                "repro_loop_lag_us",
                "repro_rpc_latency_us",
                "repro_worker_queue_depth",
                "repro_backpressure_pauses_total",
                "repro_frame_stage_us",
                "repro_ps_update_us",
            ):
                assert family in fams, family
            procs = {
                labels["proc"]
                for fam in fams.values()
                for _n, labels, _v in fam["samples"]
                if "proc" in labels
            }
            assert {"gateway", "shard0", "shard1"} <= procs
        finally:
            monitor.close()
