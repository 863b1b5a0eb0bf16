"""The port's cost model, dry run and sharding rules vs the JAX package.

Roofline formulas and sharding rules are pure arithmetic on the same
configs, so they are held equal to JAX's exactly.  The counting context
(``compat.CostCounter``) is held to hand-counted FLOPs and bytes, the dry
run's extrapolations to direct counts, and every runnable smoke cell is
dry-run on the meta device.  Twins of tests/test_dryrun.py:34,52,62,72,80,108
and tests/test_misc.py:76.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as JR  # noqa: E402
from repro.launch import sharding as JSH  # noqa: E402
from repro.models.common import init_params as j_init_params  # noqa: E402
from repro_torch import compat  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402
from repro_torch.launch import sharding as TSH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba as TMB  # noqa: E402
from repro_torch.models.common import init_params, param_shapes  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = list(tconfigs.ARCHS)


@pytest.fixture
def mini_shapes():
    """Small cells registered at run time, as tests/test_dryrun.py:92 does."""
    added = {"mini_train": tconfigs.ShapeCell("mini_train", 64, 8, "train"),
             "mini_pre": tconfigs.ShapeCell("mini_pre", 64, 8, "prefill"),
             "mini_dec": tconfigs.ShapeCell("mini_dec", 64, 8, "decode")}
    tconfigs.SHAPES.update(added)
    yield added
    for name in added:
        del tconfigs.SHAPES[name]


# ------------------------------------------------------------ roofline
@pytest.mark.parametrize("arch", ARCHS)
def test_roofline_formulas_equal_jax(arch, monkeypatch):
    """model_flops, attn_scores_traffic, analytic_memory_floor (tp 16, as
    JAX's) and roofline_terms (on JAX's hardware numbers) equal JAX's for
    every shape and devices 256 and 512, exactly."""
    for key, jkey in (("peak_flops", "peak_flops"), ("hbm_bw", "hbm_bw"),
                      ("nvlink_bw", "ici_bw")):
        monkeypatch.setitem(TR.HW, key, JR.HW[jkey])
    tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
    rng = np.random.default_rng(len(arch))
    for shape, cell in tconfigs.SHAPES.items():
        B, S, mode = cell.global_batch, cell.seq_len, cell.mode
        assert TR.model_flops(tcfg, mode, B, S) == JR.model_flops(jcfg, mode, B, S)
        for devices in (256, 512):
            assert TR.attn_scores_traffic(tcfg, mode, B, S, devices) == \
                JR.attn_scores_traffic(jcfg, mode, B, S, devices)
            for mb in (1, 4):
                assert TR.analytic_memory_floor(tcfg, mode, B, S, devices, mb) == \
                    JR.analytic_memory_floor(jcfg, mode, B, S, devices, mb)
        flops, hbm, wire = rng.uniform(1e9, 1e15, 3)
        assert TR.roofline_terms(flops, hbm, wire) == JR.roofline_terms(flops, hbm, wire)
    assert TR.roofline_terms(0.0, 0.0, 0.0) == JR.roofline_terms(0.0, 0.0, 0.0)


def test_one_device_formulas_take_tp_1():
    """JAX's tp = 16 divides by zero at one device; tp=1 does not, and a
    decode floor reads every weight once."""
    cfg = tconfigs.get_config("gemma-2b")
    with pytest.raises(ZeroDivisionError):
        TR.attn_scores_traffic(cfg, "train", 4, 1024, 1)
    t = TR.attn_scores_traffic(cfg, "train", 4, 1024, 1, tp=1)
    assert t == 18 * 4 * 8 * 1024 * 1024 * 16.0 * 3
    f = TR.analytic_memory_floor(cfg, "decode", 4, 1024, 1, tp=1)
    assert f > 2 * cfg.n_active_params()


def test_roofline_terms_math():
    """Twin of tests/test_dryrun.py:62 on the H100's numbers."""
    t = TR.roofline_terms(989e12, 3.35e12, 450e9)  # exactly 1s each
    assert abs(t["compute_s"] - 1.0) < 1e-9
    assert abs(t["memory_s"] - 1.0) < 1e-9
    assert abs(t["collective_s"] - 1.0) < 1e-9
    t2 = TR.roofline_terms(989e12, 0.0, 0.0)
    assert t2["dominant"] == "compute"
    assert t2["compute_fraction_of_bound"] == 1.0
    assert TR.mfu(tconfigs.get_config("gemma-2b"), "train", 4, 1024, 1.0) == \
        6.0 * tconfigs.get_config("gemma-2b").n_active_params() * 4096 / 989e12


def test_model_flops_modes():
    """Twin of tests/test_dryrun.py:72."""
    cfg = tconfigs.get_config("gemma-2b")
    n = cfg.n_active_params()
    assert TR.model_flops(cfg, "train", 4, 128) == 6.0 * n * 512
    assert TR.model_flops(cfg, "prefill", 4, 128) == 2.0 * n * 512
    assert TR.model_flops(cfg, "decode", 4, 128) == 2.0 * n * 4
    moe = tconfigs.get_config("qwen3-moe-30b-a3b")
    assert moe.n_active_params() < 0.2 * moe.n_params()


def test_memory_floor_sane():
    """Twin of tests/test_dryrun.py:80."""
    cfg = tconfigs.get_config("gemma-2b")
    f_train = TR.analytic_memory_floor(cfg, "train", 256, 4096, 256, 1)
    f_dec = TR.analytic_memory_floor(cfg, "decode", 128, 32768, 256, 1)
    assert f_train > f_dec
    assert 1e8 < f_dec < 1e12
    assert f_dec > 2 * cfg.n_active_params() / 16


# ------------------------------------------------------------ collectives
_HLO = """
  %ag = bf16[16,4096]{1,0} all-gather(bf16[16,256]{1,0} %p), dims={1}
  %ar.1 = f32[1024]{0} all-reduce(f32[1024]{0} %x), to_apply=%add
  %ars = f32[512]{0} all-reduce-start(f32[512]{0} %y), to_apply=%add
  %rs = (f32[128]{0}, f32[128]{0}) reduce-scatter(f32[1024]{0} %a, f32[1024]{0} %b), dims={0}
  %cp = u8[64]{0} collective-permute(u8[64]{0} %z), source_target_pairs={{0,1}}
"""

# The same collectives as _HLO's, issued by two gloo ranks and recorded on
# rank 0 (rank 0's send is the collective-permute; rank 1 receives).
_RECORD_SCRIPT = r"""
import json, sys
import torch, torch.distributed as dist
from repro_torch import compat
from repro_torch.launch import roofline as R
rank, init, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=2)
rec = compat.CollectiveRecorder()
with rec:
    dist.all_gather_into_tensor(torch.zeros(16, 4096, dtype=torch.bfloat16),
                                torch.ones(8, 4096, dtype=torch.bfloat16))
    dist.all_reduce(torch.ones(1024))
    dist.all_reduce(torch.ones(512))
    dist.reduce_scatter_tensor(torch.zeros(256), torch.ones(512))
    if rank == 0:
        dist.send(torch.ones(64, dtype=torch.uint8), dst=1)
    else:
        dist.recv(torch.zeros(64, dtype=torch.uint8), src=0)
if rank == 0:
    json.dump(R.collective_bytes(rec.collectives), open(out, "w"))
dist.destroy_process_group()
print("RECORDED", rank)
"""


def test_collective_bytes_of_recorded_collectives_equal_jax_hlo_parse(tmp_path):
    """Twin of tests/test_dryrun.py:52: collectives recorded from c10d ops
    give the dict JAX's parser gives for the same collectives in HLO."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = tmp_path / "coll.json"
    procs = [subprocess.Popen([sys.executable, "-c", _RECORD_SCRIPT, str(r),
                               str(tmp_path / "pg"), str(out)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"RECORDED {r}" in text, text[-3000:]
    got = json.loads(out.read_text())
    assert got == JR.collective_bytes(_HLO)
    assert got["all-reduce"]["wire_bytes"] == 2 * (1024 * 4 + 512 * 4)


def test_collective_bytes_refuses_an_unknown_op():
    with pytest.raises(ValueError, match="broadcast"):
        TR.collective_bytes([("broadcast", 4)])
    assert TR.collective_bytes([]) == JR.collective_bytes("")


# ------------------------------------------------------------ the counter
def test_counter_counts_a_matmul_chain_exactly():
    """x (64,128) @ w1 (128,256) -> relu -> @ w2 (256,32) + b: FLOPs
    2·64·128·256 + 64·256 (relu) + 2·64·256·32 + 64·32 (add); bytes each
    op's inputs and outputs; a view moves nothing; no transcendental; the
    peak holds the arguments and the live intermediates."""
    x = torch.empty(64, 128, device="meta")
    w1, w2 = torch.empty(128, 256, device="meta"), torch.empty(256, 32, device="meta")
    b = torch.empty(32, device="meta")
    c = compat.CostCounter()
    with c:
        args = c.hold((x, w1, w2, b))
        h = torch.relu(x @ w1)
        y = (h @ w2).t().t() + b  # two views
        del h
    f4 = 4
    assert c.flops == 2 * 64 * 128 * 256 + 64 * 256 + 2 * 64 * 256 * 32 + 64 * 32
    assert c.bytes_accessed == f4 * (
        (64 * 128 + 128 * 256 + 64 * 256)  # mm 1
        + (64 * 256 + 64 * 256)  # relu
        + (64 * 256 + 256 * 32 + 64 * 32)  # mm 2
        + (64 * 32 + 32 + 64 * 32))  # add
    assert c.transcendentals == 0
    assert args == f4 * (64 * 128 + 128 * 256 + 256 * 32 + 32)
    assert c.peak_bytes == args + f4 * 2 * 64 * 256  # mm 1's output beside relu's
    assert c.ops == 6
    assert compat.cost_analysis(c) == {"flops": float(c.flops),
                                       "bytes accessed": float(c.bytes_accessed),
                                       "transcendentals": 0.0}
    assert y.shape == (64, 32)


def test_counter_counts_every_loop_iteration():
    """Twin of tests/test_dryrun.py:34: XLA counts a loop body once; eager
    counting counts every iteration."""
    def f(x, n):
        for _ in range(n):
            x = x @ x
        return x

    x = torch.empty(256, 256, device="meta")
    counts = {}
    for n in (4, 8):
        c = compat.CostCounter()
        with c:
            f(x, n)
        counts[n] = c.flops
    assert counts[8] == 2 * counts[4] == 8 * 2 * 256 ** 3


def test_counter_counts_transcendentals_and_frees_what_dies():
    x = torch.empty(10, 100, device="meta")
    c = compat.CostCounter()
    with c:
        c.hold(x)
        y = torch.softmax(torch.exp(x), dim=-1)
        del y
        z = torch.tanh(x)
    assert c.transcendentals == 3 * 1000
    assert c.live_bytes == 2 * 4000  # x and z; exp's and softmax's outputs freed
    assert c.peak_bytes == 3 * 4000
    assert z.shape == x.shape


# ------------------------------------------------------------ the dry run
def test_probe_extrapolation_matches_unrolled(mini_shapes):
    """Twin of tests/test_dryrun.py:108: C(1) + (NP−1)(C(2)−C(1)) equals the
    direct count of the full probe cell, exactly."""
    cfg = tconfigs.smoke("gemma2-2b")  # period 2, smoke n_layers = 4 (2 periods)
    probe = D.probe_costs(cfg, "mini_train", None, {}, 1)
    full = D.count(TS.make_cell(cfg, "mini_train", None, TS.StepOptions(probe=True, microbatch=1)))
    for k in ("flops", "bytes_accessed", "transcendentals"):
        assert probe[k] == full[k] > 0, k


@pytest.mark.parametrize("arch", ["gemma2-2b", "falcon-mamba-7b", "granite-moe-1b-a400m",
                                  "qwen2-vl-2b"])
def test_dry_run_extrapolation_equals_the_direct_count(arch, mini_shapes):
    """The dry run counts a train cell of 4 microbatches at full depth with
    2 of them and adds 2 more microbatches' costs, extrapolated from 1 and
    2 periods; that equals counting the cell itself: every cost exactly,
    and the peak of live bytes.  Prefill and decode are counted as they are."""
    cfg = tconfigs.smoke(arch)
    cfg = dataclasses.replace(cfg, n_layers=cfg.period * 3)
    for shape, opts in (("mini_train", TS.StepOptions(microbatch=4, ce_chunk=32)),
                        ("mini_pre", TS.StepOptions()), ("mini_dec", TS.StepOptions())):
        TL._section_ids.cache_clear()  # M-RoPE's per-device ids, made by a first step
        ev, points = D.evaluate(cfg, shape, opts)
        direct = D.count(TS.make_cell(cfg, shape, None, opts))
        assert set(points) == ({"p3m2", "p1m2", "p1m3", "p2m2", "p2m3"}
                               if shape == "mini_train" else {"p3m1"})
        for k in D._COSTS + D._MEMORY:
            assert ev[k] == direct[k], (shape, k, ev[k], direct[k])


@pytest.mark.parametrize("arch", ARCHS)
def test_make_cell_dry_runs_every_runnable_smoke_cell(arch):
    """Every runnable cell of the smoke config, at the shape's batch and
    sequence, on the meta device (probe mode: single-block attention and
    whole-sequence scans, so few ops): a record with positive costs; the
    argument bytes are the sum of the arguments' element sizes."""
    cfg = tconfigs.smoke(arch)
    for shape in tconfigs.SHAPES:
        ok, why = tconfigs.cell_applicable(cfg, shape)
        rec = D.run_cell(cfg, shape, opts_kw=dict(probe=True))
        assert rec["status"] == ("ok" if ok else "skipped"), (shape, rec)
        if not ok:
            assert rec["reason"] == why == jconfigs.cell_applicable(
                jconfigs.smoke(arch), shape)[1]
            continue
        cell = TS.make_cell(cfg, shape, None, TS.StepOptions(probe=True))
        nbytes = sum(t.numel() * t.element_size() for t in compat._tensors(cell.args))
        m = rec["memory"]
        assert m["argument_size_in_bytes"] == nbytes
        assert m["live_bytes_per_device"] == m["peak_bytes"] >= nbytes
        assert (m["argument_size_in_bytes"] + m["output_size_in_bytes"]
                + m["temp_size_in_bytes"] - m["alias_size_in_bytes"]) == m["peak_bytes"]
        assert m["fits_80gb_hbm"] == (m["peak_bytes"] < 80e9)
        assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
        assert rec["mode"] == tconfigs.SHAPES[shape].mode == cell.mode
        assert rec["model_flops_global"] == TR.model_flops(
            cfg, cell.mode, tconfigs.SHAPES[shape].global_batch, tconfigs.SHAPES[shape].seq_len)
        assert rec["roofline"]["dominant"] in ("compute", "memory")


def test_run_cell_with_probes_matches_jax_record_keys(mini_shapes):
    """The record keeps JAX's keys (fits_80gb_hbm for fits_16gb_hbm)."""
    rec = D.run_cell(tconfigs.smoke("falcon-mamba-7b"), "mini_train", probes=True,
                     opts_kw=dict(ce_chunk=32))
    assert {"arch", "shape", "mesh", "devices", "status", "lower_s", "compile_s", "mode",
            "opts", "memory", "cost", "collectives", "wire_bytes_per_device",
            "model_flops_global", "n_params", "n_active_params", "roofline", "probe",
            "roofline_probe", "microbatch"} <= set(rec)
    assert {"argument_size_in_bytes", "output_size_in_bytes", "temp_size_in_bytes",
            "alias_size_in_bytes", "live_bytes_per_device", "fits_80gb_hbm"} <= set(rec["memory"])
    assert rec["devices"] == 1 and rec["mesh"] == "none"
    assert rec["collectives"]["all-reduce"]["count"] == 0
    # the probe counts what the main count counts, with other chunking
    assert rec["probe"]["flops"] > 0
    assert rec["roofline_probe"]["memory_floor_bytes"] == TR.analytic_memory_floor(
        tconfigs.smoke("falcon-mamba-7b"), "train", 8, 64, 1, 1, tp=1)


def test_dryrun_cli_writes_a_record(tmp_path):
    assert D.main(["--arch", "hubert-xlarge", "--shape", "decode_32k",
                   "--out-dir", str(tmp_path)]) == 0
    rec = json.loads((tmp_path / "hubert-xlarge__decode_32k__none.json").read_text())
    assert rec["status"] == "skipped" and rec["reason"] == "encoder-only arch: no decode step"


# ------------------------------------------------------------ sharding rules
def _jax_leaves(cfg):
    """(key, shape, stacked) of every leaf, as JAX's param_shardings sees it."""
    struct = jax.eval_shape(lambda: j_init_params(cfg, jax.random.key(0)))
    out = []
    for path, leaf in jax.tree_util.tree_flatten_with_path(struct)[0]:
        key = [p.key for p in path if isinstance(p, jax.tree_util.DictKey)][-1]
        stacked = any(isinstance(p, jax.tree_util.SequenceKey) for p in path)
        out.append((key, tuple(leaf.shape), stacked))
    return out


def _port_leaves(cfg):
    return [(re.findall(r"\['(\w+)'\]", path)[-1], tuple(shape), "'layers'][" in path)
            for path, shape in T.paths(param_shapes(cfg))]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_pspec_equals_jax_for_every_leaf(arch):
    """Twin of tests/test_misc.py:76 over every leaf of the config: tp 16
    and dp 16 over ("data",), and dp 32 over ("pod", "data"), with FSDP and
    Mamba TP on and off."""
    leaves = _port_leaves(tconfigs.get_config(arch))
    assert leaves == _jax_leaves(jconfigs.get_config(arch))
    for dpa, dp in ((("data",), 16), (("pod", "data"), 32)):
        for fsdp in (True, False):
            for mamba_tp in (True, False):
                for key, shape, stacked in leaves:
                    got = TSH.param_pspec(key, shape, 16, dpa, dp, stacked, fsdp, mamba_tp)
                    want = JSH.param_pspec(key, shape, 16, dpa, dp, stacked, fsdp, mamba_tp)
                    assert got == tuple(want), (key, shape, dpa, fsdp, mamba_tp)


def test_param_pspec_rules():
    """tests/test_misc.py:76's cases, as tuples."""
    assert TSH.param_pspec("wq", (8, 2048, 4096), 16, ("data",), 16, True) == (
        None, "data", "model")
    assert TSH.param_pspec("wo", (8, 4096, 2048), 16, ("data",), 16, True) == (
        None, "model", "data")
    assert TSH.param_pspec("moe_gate", (8, 128, 2048, 768), 16, ("data",), 16, True)[1] == "model"
    assert TSH.param_pspec("wk", (8, 2560, 117), 16, ("data",), 16, True)[2] is None
    assert TSH.param_pspec("ln1", (8, 2048), 16, ("data",), 16, True)[1] != "model"


@pytest.mark.parametrize("axes,shape", [(("data", "model"), (16, 16)),
                                        (("pod", "data", "model"), (2, 16, 16)),
                                        (("data", "model"), (4, 1))])
def test_batch_and_cache_pspecs_equal_jax(axes, shape):
    jmesh = SimpleNamespace(axis_names=axes, shape=dict(zip(axes, shape)))
    tmesh = SimpleNamespace(mesh_dim_names=axes, shape=shape)
    assert TMESH.batch_axes(tmesh) == tuple(a for a in axes if a != "model")
    assert TMESH.tp_size(tmesh) == dict(zip(axes, shape))["model"]
    assert TMESH.batch_shards(tmesh) == int(np.prod(shape)) // TMESH.tp_size(tmesh)
    for arch in ("gemma-2b", "jamba-v0.1-52b", "minicpm3-4b", "qwen2-vl-2b"):
        tcfg, jcfg = tconfigs.get_config(arch), jconfigs.get_config(arch)
        for name, bshape in (("tokens", (256, 4096)), ("tokens", (1, 4096)),
                             ("pos3", (3, 32, 1024)), ("embeds", (32, 1024, 8))):
            assert TSH.batch_pspec(tcfg, name, bshape, tmesh) == \
                tuple(JSH.batch_pspec(jcfg, name, bshape, jmesh))
        cache = TM.init_cache(tcfg, 32, 64, device="meta")
        for path, leaf in T.paths(cache["layers"]):
            keys = re.findall(r"\['(\w+)'\]", path)
            assert TSH.cache_pspec(keys, tuple(leaf.shape), tcfg, tmesh) == \
                tuple(JSH.cache_pspec(keys, tuple(leaf.shape), jcfg, jmesh)), path
        assert TSH.cache_pspec(["pos"], (), tcfg, tmesh) == tuple(
            JSH.cache_pspec(["pos"], (), jcfg, jmesh))


# ------------------------------------------------------------ plain prefill
@pytest.mark.parametrize("arch", ["gemma2-2b", "falcon-mamba-7b", "minicpm3-4b", "jamba-v0.1-52b"])
def test_plain_prefill_equals_the_kernel_route(arch):
    """The dry run's prefill (``ShardCtx(plain=True)``: layers.attention and
    the chunked scan) gives the logits and caches of the default prefill
    (on the CPU: the kernels' plain versions), float32 compute, rtol 1e-5;
    caches at rtol 1e-4; its Mamba states own their storage (a view of the
    last chunk's states kept 268 MB a layer alive at 4 x 1024, which the
    dry run showed)."""
    from repro_torch.data.pipeline import synthetic_batch

    cfg = dataclasses.replace(tconfigs.smoke(arch), compute_dtype=torch.float32)
    params = TM.compute_params(cfg, init_params(cfg, 0, "cpu"))
    batch = synthetic_batch(cfg, 2, 256, seed=3, device="cpu")
    batch.pop("labels")
    want_logits, want = TM.prefill(cfg, params, batch)
    got_logits, got = TM.prefill(cfg, params, batch, TM.ShardCtx(plain=True))
    np.testing.assert_allclose(got_logits.numpy(), want_logits.numpy(), rtol=1e-5, atol=1e-5)
    assert got["pos"] == want["pos"]
    for (path, g), (_, w) in zip(T.paths(got["layers"]), T.paths(want["layers"])):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        # a Mamba layer's chunked associative scan sums in another order
        # than the sequential one, which later layers' caches inherit
        np.testing.assert_allclose(g.float().numpy(), w.float().numpy(), rtol=1e-4, atol=5e-5,
                                   err_msg=path)
    if cfg.mixer_has("mamba"):
        pos = [s.mixer for s in cfg.layout].index("mamba")
        p = {k: v[0] for k, v in params["layers"][pos].items()}
        u = torch.randn(2, 64, cfg.d_model, generator=torch.Generator().manual_seed(0))
        _, state = TMB.mamba_prefill(p, u, cfg, chunk=16)
        _, kstate = TMB.mamba_prefill(p, u, cfg)
        np.testing.assert_allclose(state["h"].numpy(), kstate["h"].numpy(), rtol=1e-5, atol=1e-6)
        h = state["h"]
        assert h.untyped_storage().nbytes() == h.numel() * h.element_size()


def test_peak_memory_is_counted_at_full_depth():
    """gemma-2b's 4 x 1024 train step at its published width: the peak
    comes from the optimizer's pass over the 18-period leaves at full depth,
    from the cross-entropy chunks at 1 and 2 periods, so a line through
    the 1- and 2-period peaks misses it by 7.5 GB; the record's peak is the
    full-depth count, which an H100 measured within 0.2 % (PERF.md)."""
    tconfigs.SHAPES["k_train"] = tconfigs.ShapeCell("k_train", 1024, 4, "train")
    try:
        cfg = tconfigs.get_config("gemma-2b")
        opts = TS.StepOptions(remat="block", ce_chunk=512)
        rec = D.run_cell(cfg, "k_train", opts_kw=dict(remat="block", ce_chunk=512))
        direct = D.count(TS.make_cell(cfg, "k_train", None, opts))
        small = [D.count(TS.make_cell(dataclasses.replace(cfg, n_layers=n), "k_train", None,
                                      opts))["peak_bytes"] for n in (1, 2)]
    finally:
        del tconfigs.SHAPES["k_train"]
    assert rec["memory"]["peak_bytes"] == direct["peak_bytes"]
    assert rec["cost"]["flops"] == direct["flops"]
    line = small[0] + 17 * (small[1] - small[0])
    assert direct["peak_bytes"] - line > 5e9, (direct["peak_bytes"], line)
