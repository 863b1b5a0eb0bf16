"""Port's on-device AD (repro_torch.core.torch_ad) vs repro.core.jax_ad, on the CPU.

Inputs are made once with numpy from a seed and handed to both packages.
Tolerances follow tests/test_jax_ad.py: counts and labels exact, mean
rtol 1e-4 (atol 1e-3), M2 rtol 1e-3 (atol 1.0).
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import jax_ad as J  # noqa: E402
from repro.core.stats import StatsTable  # noqa: E402
from repro_torch import device as tdevice  # noqa: E402
from repro_torch.core import torch_ad as T  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_tables_close(t_port, t_jax, m2_rtol=1e-3, m2_atol=1.0):
    a, b = np.asarray(t_port), np.asarray(t_jax)
    np.testing.assert_array_equal(a[:, T.N], b[:, J.N])
    np.testing.assert_allclose(a[:, T.MEAN], b[:, J.MEAN], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(a[:, T.M2], b[:, J.M2], rtol=m2_rtol, atol=m2_atol)
    np.testing.assert_array_equal(a[:, [T.MIN, T.MAX]], b[:, [J.MIN, J.MAX]])


def test_init_table_matches_jax():
    np.testing.assert_array_equal(T.init_table(6, device="cpu").numpy(),
                                  np.asarray(J.init_table(6)))


def test_batch_table_matches_jax_and_host():
    rng = np.random.default_rng(0)
    fids = rng.integers(0, 16, 300).astype(np.int32)
    durs = rng.lognormal(3, 1, 300).astype(np.float32)
    fids = np.concatenate([fids, -np.ones(50, np.int32)])  # padding
    durs = np.concatenate([durs, np.zeros(50, np.float32)])
    t = T.batch_table(_t(fids), _t(durs), 16).numpy()
    _assert_tables_close(t, J.batch_table(jnp.asarray(fids), jnp.asarray(durs), 16))
    host = StatsTable(16)
    host.update_batch(fids[:300].astype(np.int64), durs[:300].astype(np.float64))
    np.testing.assert_array_equal(t[:, T.N], host.counts())
    np.testing.assert_allclose(t[:, T.MEAN], host.means(), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(t[:, T.M2], host.table[:, 2], rtol=1e-3, atol=1.0)


def test_merge_tables_matches_jax():
    rng = np.random.default_rng(1)
    a_f, a_d = rng.integers(0, 8, 100).astype(np.int32), rng.lognormal(2, 0.5, 100).astype(np.float32)
    b_f, b_d = rng.integers(0, 8, 150).astype(np.int32), rng.lognormal(2, 0.5, 150).astype(np.float32)
    ta_j = J.batch_table(jnp.asarray(a_f), jnp.asarray(a_d), 8)
    tb_j = J.batch_table(jnp.asarray(b_f), jnp.asarray(b_d), 8)
    merged = T.merge_tables(_t(ta_j), _t(tb_j)).numpy()  # same operands, both sides
    _assert_tables_close(merged, J.merge_tables(ta_j, tb_j), m2_rtol=1e-6, m2_atol=0.0)
    host = StatsTable(8)
    host.update_batch(np.concatenate([a_f, b_f]), np.concatenate([a_d, b_d]))
    np.testing.assert_array_equal(merged[:, T.N], host.counts())
    np.testing.assert_allclose(merged[:, T.MEAN], host.means(), rtol=1e-4)
    # an empty side leaves the other intact
    empty = T.merge_tables(T.init_table(8, device="cpu"), _t(tb_j)).numpy()
    _assert_tables_close(empty, J.merge_tables(J.init_table(8), tb_j), m2_rtol=1e-6, m2_atol=0.0)


def test_label_events_matches_jax():
    rng = np.random.default_rng(4)
    F = 12
    table = np.asarray(J.batch_table(jnp.asarray(rng.integers(0, F, 400), jnp.int32),
                                     jnp.asarray(rng.normal(50, 4, 400), jnp.float32), F))
    fids = rng.integers(-1, F, 1000).astype(np.int32)
    durs = rng.normal(50, 12, 1000).astype(np.float32)
    for alpha, min_count in ((6.0, 10.0), (3.0, 30.0), (2.0, 40.0)):
        want = np.asarray(J.label_events(jnp.asarray(table), jnp.asarray(fids),
                                         jnp.asarray(durs), alpha, min_count))
        got = T.label_events(_t(table), _t(fids), _t(durs), alpha, min_count).numpy()
        np.testing.assert_array_equal(got, want)
    assert 0 < want.sum() < len(want)  # the check reaches both sides of the bound


def test_ad_step_labels_matches_jax():
    """Twin of tests/test_jax_ad.py:test_ad_step_labels."""
    rng = np.random.default_rng(3)
    fids = rng.integers(0, 4, 400).astype(np.int32)
    durs = rng.normal(100, 5, 400).astype(np.float32)
    tj, lj = J.ad_step(J.init_table(4), jnp.asarray(fids), jnp.asarray(durs))
    tt, lt = T.ad_step(T.init_table(4, device="cpu"), _t(fids), _t(durs))
    _assert_tables_close(tt.numpy(), tj)
    assert int(lt.sum()) == 0 and np.array_equal(lt.numpy(), np.asarray(lj))
    f2, d2 = np.asarray([0, 1], np.int32), np.asarray([100.0, 5000.0], np.float32)
    tj, lj = J.ad_step(tj, jnp.asarray(f2), jnp.asarray(d2))
    tt, lt = T.ad_step(tt, _t(f2), _t(d2))
    assert lt.tolist() == np.asarray(lj).tolist() == [0, 1]
    _assert_tables_close(tt.numpy(), tj)


def test_straggler_scores_matches_jax():
    times = np.asarray([1.0, 1.05, 0.98, 1.02, 4.0], np.float32)
    z = T.straggler_scores(_t(times))
    np.testing.assert_allclose(z.numpy(), np.asarray(J.straggler_scores(jnp.asarray(times))),
                               rtol=1e-5, atol=1e-6)
    assert int(torch.argmax(z)) == 4 and float(z[4]) > 1.5


def test_padded_num_funcs_matches_jax():
    for f, s in ((30, 4), (32, 4), (7, 1), (1, 8)):
        assert T.padded_num_funcs(f, s) == J.padded_num_funcs(f, s)


# ------------------------------------------------------------ no CPU fallback
def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.default_device()
    with pytest.raises(RuntimeError):  # entry points do not quietly pick the CPU
        T.init_table(4)
    assert T.init_table(4, device="cpu").device.type == "cpu"


def test_parity_mode_pins_float32():
    state = tdevice.parity_mode()
    assert state == {"torch.backends.cuda.matmul.allow_tf32": False,
                     "torch.backends.cudnn.allow_tf32": False}
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


_ISOLATION_SCRIPT = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "repro" or m.startswith("repro."))
assert not bad, bad
assert "repro_torch.core.torch_ad" in names and "repro_torch.kernels.moments" in names, names
assert {"repro_torch.compat", "repro_torch.launch.roofline", "repro_torch.launch.dryrun",
        "repro_torch.launch.mesh", "repro_torch.launch.sharding",
        "repro_torch.optim.compression", "repro_torch.models.collectives",
        "repro_torch.checkpoint.ckpt", "repro_torch.models.common", "repro_torch.models.model",
        "repro_torch.launch.steps"} <= set(names), names
assert "repro_torch._unported" not in names, names  # no part of the JAX package is left unported
print("ISOLATED", len(names))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    r = subprocess.run([sys.executable, "-c", _ISOLATION_SCRIPT], capture_output=True,
                       text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert "ISOLATED" in r.stdout, r.stdout + r.stderr


def _imported_modules(path):
    """Every module an ``import`` or absolute ``from`` names anywhere in the
    file, function and class bodies included (relative imports stay in
    the package)."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_no_jax_and_nothing_of_repro_at_any_depth():
    """Importing every module (above) misses an import written inside a
    function body; this reads the sources themselves: the package, the
    port's examples (``examples/*_torch.py``) and chip_smoke.py."""
    package = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    examples = sorted((REPO / "examples").glob("*_torch.py"))
    files = package + examples + [REPO / "chip_smoke.py"]
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
    assert {f.name for f in examples} >= {"serve_monitored_torch.py", "train_monitored_torch.py"}
    walked = {str(f.relative_to(REPO / "src")).replace("/", ".")[:-3] for f in package}
    assert {"repro_torch.models.model", "repro_torch.kernels.flash_attention",
            "repro_torch.launch.serve", "repro_torch.trace.monitor",
            "repro_torch.core.ps", "repro_torch.core.provenance",
            "repro_torch.trace.stream", "repro_torch.core.offline",
            "repro_torch.fault.policy", "repro_torch.fault.wal", "repro_torch.fault.chaos",
            "repro_torch.telemetry.exposition", "repro_torch.telemetry.buildinfo",
            "repro_torch.telemetry.__main__", "repro_torch.telemetry.federate",
            "repro_torch.lint.runtime", "repro_torch.net.framing", "repro_torch.net.client",
            "repro_torch.net.server", "repro_torch.net.shards",
            "repro_torch.launch.shard_server", "repro_torch.models.moe",
            "repro_torch.viz.http", "repro_torch.viz.ws", "repro_torch.viz.gateway",
            "repro_torch.lint.model", "repro_torch.lint.callgraph", "repro_torch.lint.rules",
            "repro_torch.lint.baseline", "repro_torch.lint.cli",
            "repro_torch.lint.__main__", "repro_torch.compat", "repro_torch.launch.roofline",
            "repro_torch.launch.dryrun", "repro_torch.launch.mesh",
            "repro_torch.launch.sharding", "repro_torch.optim.compression",
            "repro_torch.models.mamba", "repro_torch.launch.steps",
            "repro_torch.convert", "repro_torch.models.collectives",
            "repro_torch.checkpoint.ckpt", "repro_torch.optim.adamw",
            "repro_torch.models.common", "repro_torch.models.model"} <= walked
    assert "repro_torch._unported" not in walked
    # the check sees nested imports: a function-level one is caught
    probe = REPO / "src" / "repro_torch" / "trace" / "monitor.py"
    assert "repro_torch.fault.health" in set(_imported_modules(probe))


_WORKER_IMPORTS_SCRIPT = r"""
import sys
import repro_torch.launch.shard_server
from repro_torch.net.shards import build_shard_table
build_shard_table("both")
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "jaxlib", "repro"))
assert not bad, bad
print("TORCH-FREE")
"""


def test_shard_worker_imports_neither_torch_nor_jax():
    """A spawned shard worker re-imports ``repro_torch.launch.shard_server``
    and builds its service table: that closure loads no torch (no CUDA
    probe on a respawn) and no jax."""
    r = subprocess.run([sys.executable, "-c", _WORKER_IMPORTS_SCRIPT], capture_output=True,
                       text=True, timeout=120, env={**os.environ, "PYTHONPATH": str(REPO / "src")})
    assert "TORCH-FREE" in r.stdout, r.stdout + r.stderr


# ------------------------------------------------------- distributed step
# The JAX reference: make_distributed_ad_step on 4 host devices, as a
# (ranks,) mesh of 4 and as a (ranks, funcs) mesh of 2 x 2 (as in
# tests/test_jax_ad.py:65-105 and tests/test_federation.py:292-323).
_JAX_DISTRIBUTED_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np, jax, jax.numpy as jnp
from repro.core import jax_ad as J
inp = np.load(sys.argv[1]); F = int(inp["F"]); out = {}
for name, shape, axes, func_axis in (("ranks4", (4,), ("ranks",), None),
                                     ("grid2x2", (2, 2), ("ranks", "funcs"), "funcs")):
    mesh = jax.make_mesh(shape, axes)
    for use in (0, 1):
        step = J.make_distributed_ad_step(mesh, ("ranks",), min_count=10.0,
                                          use_pallas=bool(use), func_axis=func_axis)
        t1, l1 = step(J.init_table(F), jnp.asarray(inp["fids"]), jnp.asarray(inp["durs"]))
        t2, l2 = step(t1, jnp.asarray(inp["fids2"]), jnp.asarray(inp["durs2"]))
        for k, v in (("t1", t1), ("l1", l1), ("t2", t2), ("l2", l2)):
            out[f"{name}_{use}_{k}"] = np.asarray(v)
np.savez(sys.argv[2], **out)
print("JAX_DISTRIBUTED_OK")
"""

# The port: one gloo process per device of the meshes above.  Process g sits
# at rank index g // nf and funcs index g % nf of a row-major (ranks, funcs)
# grid; rank_group holds the processes of its funcs index, func_group those
# of its rank index.
_TORCH_WORKER_SCRIPT = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.core import torch_ad as T
rank, world, init, inputs, outdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
inp = np.load(inputs); F = int(inp["F"]); R = inp["fids"].shape[0]; out = {}
for name, nf in (("ranks4", 1), ("grid2x2", 2)):
    nr, r, fi = world // nf, rank // nf, rank % nf
    groups = [dist.new_group([i * nf + j for i in range(nr)]) for j in range(nf)]
    rank_group = groups[fi]
    func_group = None
    if nf > 1:  # every process creates every group, in the same order
        groups = [dist.new_group([i * nf + j for j in range(nf)]) for i in range(nr)]
        func_group = groups[r]
    rows = slice(r * R // nr, (r + 1) * R // nr)
    Fs = F // nf
    ev = [torch.from_numpy(np.ascontiguousarray(inp[k][rows])) for k in ("fids", "durs", "fids2", "durs2")]
    for use in (0, 1):
        step = T.make_distributed_ad_step(rank_group, func_group, min_count=10.0, use_kernel=bool(use))
        t0 = T.init_table(F, device="cpu")[fi * Fs:(fi + 1) * Fs].contiguous()
        t1, l1 = step(t0, ev[0], ev[1])
        t2, l2 = step(t1, ev[2], ev[3])
        for k, v in (("t1", t1), ("l1", l1), ("t2", t2), ("l2", l2)):
            out[f"{name}_{use}_{k}"] = v.numpy()
np.savez(f"{outdir}/rank{rank}.npz", **out)
dist.destroy_process_group()
print("TORCH_WORKER_OK", rank)
"""

_WORLD = 4
_SUBPROCESS_TIMEOUT = 150


@pytest.fixture(scope="module")
def distributed_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    rng = np.random.default_rng(0)
    F, R, E = 30, 8, 64
    fids = rng.integers(0, F, (R, E)).astype(np.int32)
    durs = rng.lognormal(3, 0.4, (R, E)).astype(np.float32)
    fids2 = rng.integers(0, F, (R, 8)).astype(np.int32)
    durs2 = rng.lognormal(3, 0.4, (R, 8)).astype(np.float32)
    fids2[3, 2], durs2[3, 2] = 20, 1e6  # an outlier on a row of the second funcs block
    np.savez(d / "inputs.npz", F=F, fids=fids, durs=durs, fids2=fids2, durs2=durs2)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}

    jax_run = subprocess.run(
        [sys.executable, "-c", _JAX_DISTRIBUTED_SCRIPT, str(d / "inputs.npz"), str(d / "jax.npz")],
        capture_output=True, text=True, timeout=_SUBPROCESS_TIMEOUT, env=env)
    assert "JAX_DISTRIBUTED_OK" in jax_run.stdout, jax_run.stdout + jax_run.stderr

    procs = [subprocess.Popen(
        [sys.executable, "-c", _TORCH_WORKER_SCRIPT, str(r), str(_WORLD), str(d / "pg"),
         str(d / "inputs.npz"), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(_WORLD)]
    try:
        logs = [p.communicate(timeout=_SUBPROCESS_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"TORCH_WORKER_OK {r}" in text, text
    ranks = [np.load(d / f"rank{r}.npz") for r in range(_WORLD)]
    return np.load(d / "jax.npz"), ranks, (fids, durs, fids2, durs2)


def _assemble(ranks, name, use, k):
    """The global table or labels from the per-process pieces."""
    key = f"{name}_{use}_{k}"
    if name == "ranks4":  # table replicated, labels split by rank rows
        if k[0] == "t":
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[key], ranks[0][key])
            return ranks[0][key]
        return np.concatenate([r[key] for r in ranks])
    # grid 2 x 2: process g = r * 2 + fi
    if k[0] == "t":
        return np.concatenate([ranks[0][key], ranks[1][key]])  # funcs blocks of rank row 0
    for r in range(2):
        np.testing.assert_array_equal(ranks[2 * r][key], ranks[2 * r + 1][key])
    return np.concatenate([ranks[0][key], ranks[2][key]])


@pytest.mark.parametrize("use", [0, 1], ids=["plain", "kernel"])
@pytest.mark.parametrize("name", ["ranks4", "grid2x2"])
def test_distributed_ad_step_matches_jax_mesh(distributed_runs, name, use):
    """gloo processes == the JAX shard_map step on a host-device mesh of the
    same shape: n and labels exact, mean rtol 1e-4; and == the host table."""
    jax_out, ranks, (fids, durs, fids2, durs2) = distributed_runs
    host = StatsTable(30)
    host.update_batch(fids.reshape(-1).astype(np.int64), durs.reshape(-1).astype(np.float64))
    for k in ("t1", "t2"):
        got, want = _assemble(ranks, name, use, k), jax_out[f"{name}_{use}_{k}"]
        np.testing.assert_array_equal(got[:, T.N], want[:, J.N])
        np.testing.assert_allclose(got[:, T.MEAN], want[:, J.MEAN], rtol=1e-4)
        np.testing.assert_array_equal(got[:, [T.MIN, T.MAX]], want[:, [J.MIN, J.MAX]])
    t1 = _assemble(ranks, name, use, "t1")
    np.testing.assert_array_equal(t1[:, T.N], host.counts())
    np.testing.assert_allclose(t1[:, T.MEAN], host.means(), rtol=1e-4)
    for k in ("l1", "l2"):
        np.testing.assert_array_equal(_assemble(ranks, name, use, k), jax_out[f"{name}_{use}_{k}"])
    l2 = _assemble(ranks, name, use, "l2")
    assert l2[3, 2] == 1 and l2.sum() >= 1
