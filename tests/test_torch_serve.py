"""Port's monitored serving driver and monitor copies vs the JAX package, on the CPU.

``repro_torch.launch.serve`` against ``repro.launch.serve`` with the same
weights (carried from JAX ``init_params``), and the port's copy of
``ChimbukoMonitor`` (with its copies of ad, ps, reduction, provenance,
telemetry and health) against the original on identical trace frames.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import sim as j_sim  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models.common import init_params as j_init_params  # noqa: E402
from repro.trace.monitor import ChimbukoMonitor as JMonitor  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import sim as t_sim  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.telemetry import spans as tspans  # noqa: E402
from repro_torch.trace.monitor import ChimbukoMonitor as TMonitor  # noqa: E402

COUNTS = ("frames", "events", "anomalies", "ps_updates")


def test_serve_driver_runs():
    """Twin of tests/test_training.py:125 on the CPU."""
    before = tfa.launches
    out = tserve.serve(arch="gemma-2b", n_requests=4, batch=2, prompt_len=8, max_new=4,
                       device="cpu")
    assert out["requests"] == 4
    assert out["tokens"] == 16
    assert all(len(s) > 0 for s in out["samples"])
    assert out["monitor"]["frames"] == 2 and out["monitor"]["health"]["ok"]
    assert tfa.launches == before  # CPU tensors take the plain version


def test_serve_without_a_device_runs_on_cuda_or_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; chip_smoke.py drives serve there")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.serve(arch="gemma-2b", n_requests=1, batch=1, prompt_len=4, max_new=1)


@pytest.mark.parametrize("arch", ["gemma-2b", "falcon-mamba-7b"])
def test_serve_matches_jax_with_carried_weights(arch, monkeypatch):
    """float32 smoke model: identical generated tokens and monitor counts.

    3 requests in waves of 2 pad the second wave; max_new 6 keeps every
    token in ``samples``.  Anomaly counts are timing-free here: each
    function gets at most 2 × 6 = 12 samples per run, and the largest
    z-score n samples can reach is (n-1)/sqrt(n) < 6 = alpha for n < 37,
    so both monitors must report 0.  falcon-mamba's prefill runs the scan
    kernel's plain version here, JAX's the chunked associative scan.
    """
    f32 = {"j": dataclasses.replace(jconfigs.smoke(arch), compute_dtype=jnp.float32),
           "t": dataclasses.replace(tconfigs.smoke(arch), compute_dtype=torch.float32)}
    monkeypatch.setattr(jserve.configs, "smoke", lambda arch: f32["j"])
    monkeypatch.setattr(tserve.configs, "smoke", lambda arch: f32["t"])
    kw = dict(arch=arch, n_requests=3, batch=2, prompt_len=12, max_new=6, seed=4)
    jp = jax.tree.map(np.asarray, j_init_params(f32["j"], jax.random.key(4)))
    jmon = JMonitor(num_funcs=16, min_samples=8)
    tmon = TMonitor(num_funcs=16, min_samples=8)
    want = jserve.serve(monitor=jmon, **kw)
    got = tserve.serve(monitor=tmon, params=convert.params_from_jax(jp, f32["t"], device="cpu"),
                       device="cpu", **kw)
    assert got["samples"] == want["samples"]
    assert (got["requests"], got["tokens"]) == (want["requests"], want["tokens"]) == (3, 18)
    assert {k: got["monitor"][k] for k in COUNTS} == {k: want["monitor"][k] for k in COUNTS}
    assert got["monitor"]["anomalies"] == 0 and got["monitor"]["frames"] == 2
    assert tmon.registry.names == jmon.registry.names
    jmon.close()
    tmon.close()


@pytest.mark.parametrize("layout", [
    dict(ps_shards=2, ps_batch_frames=2),  # PS federation, batched pushes
    dict(provdb_shards=2),  # provenance federation
])
def test_monitor_copy_matches_the_original_on_identical_frames(layout, tmp_path):
    """Same frames through both monitors: same summary, kept records,
    provenance documents and straggler verdicts."""
    def spec(sim):
        s = sim.nwchem_like(anomaly_rate=0.02, roots_per_frame=4)
        for fs in s.funcs.values():
            fs.anomaly_scale = 40.0
        return s

    gen = j_sim.WorkloadGenerator(spec(j_sim), n_ranks=3, seed=5)
    assert gen.registry.names == t_sim.WorkloadGenerator(spec(t_sim), n_ranks=3,
                                                         seed=5).registry.names
    mons = []
    for name, cls in (("jax", JMonitor), ("port", TMonitor)):
        mons.append(cls(num_funcs=len(gen.registry), min_samples=5,
                        prov_path=str(tmp_path / f"{name}.jsonl"), **layout))
    step_times = np.random.default_rng(1).lognormal(0, 0.1, (12, 3))
    step_times[11, 1] = 50.0  # one straggler
    for step in range(12):
        for r in range(3):
            frame, _ = gen.frame(r, step)
            for m in mons:
                m.ingest(frame)
        for m in mons:
            m.record_step_times(step, dict(enumerate(step_times[step])))
    for m in mons:
        m.flush_ps()
    (js, ts) = (m.summary() for m in mons)
    js.pop("reduction_factor"), ts.pop("reduction_factor")  # inf == inf, but nan-safe
    assert ts == js and js["anomalies"] > 0 and js["provenance_records"] > 0
    ranks = [[(s.step, s.rank) for s in m.stragglers] for m in mons]
    assert ranks[1] == ranks[0] and (11, 1) in ranks[0]
    assert mons[1].kept.keys() == mons[0].kept.keys()
    for key in mons[0].kept:
        assert mons[1].kept[key].tobytes() == mons[0].kept[key].tobytes()
    for m in mons:
        m.close()
    docs = [sorted(line for f in sorted(tmp_path.glob(f"{n}*.jsonl"))
                   for line in f.read_text().splitlines() if '"run_info"' not in line)
            for n in ("jax", "port")]
    assert docs[0] == docs[1] and len(docs[0]) == js["provenance_records"]


@pytest.mark.parametrize("option", [
    dict(viz_serve=0),
    dict(ps_transport="socket", shard_endpoints=["127.0.0.1:1"]),
    dict(provdb_transport="socket", shard_endpoints=["127.0.0.1:1"]),
    dict(ps_wal_dir="wal"),
])
def test_unported_monitor_options_raise(option):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 2"):
        TMonitor(num_funcs=4, **option)


def test_span_federation_raises_and_the_run_info_names_torch(tmp_path):
    from repro_torch.core.provenance import static_provenance
    from repro_torch.core.ps import FederatedPS

    mon = TMonitor(num_funcs=4, trace_spans=True)  # no shard: the local recorder only
    try:
        assert mon.quiesce() == {"errors": []}
    finally:
        tspans.set_enabled(False)
        mon.close()
    mon = TMonitor(num_funcs=4, trace_spans=True, shard_endpoints=[("127.0.0.1", 1)])
    try:
        with pytest.raises(NotImplementedError, match="span federation"):
            mon.quiesce()
    finally:
        tspans.set_enabled(False)
        mon.close()
    with pytest.raises(NotImplementedError, match="repro.fault.wal"):
        FederatedPS(4, wal_dir=str(tmp_path))
    info = static_provenance()
    assert info["torch_version"] == torch.__version__ and "jax_version" not in info
    assert info["device_name"] == (torch.cuda.get_device_name(0)
                                   if torch.cuda.is_available() else "cpu")
