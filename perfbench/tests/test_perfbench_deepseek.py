"""The DeepSeek-V2-Lite cell: its files found and held to the program, the
plain reference against the program at a CPU size, the readers of its five
per-layer metrics on made-up spans and traces (and on a program without
the spans, the parent of the change that added them), and runs of the tiny
cut with one DeepSeek behaviour broken underneath, which come out not
correct."""
from __future__ import annotations

import dataclasses
import math
import types

import pytest
import torch

from conftest import run_tiny
from deepseek_tiny import CELL, make_deepseek_root
from perfbench.harness import check as CK
from perfbench.harness import model as MD
from perfbench.harness import peaks, peaks_mla
from perfbench.harness import spec as SP
from perfbench.harness.cli import Run
from perfbench.harness.profile import Trace
from perfbench.reference import deepseek_v2 as RF
from repro_torch.models import layers as L
from test_perfbench_metrics import closed_loop
from test_perfbench_program_spans import RUN, _span, _with_spans
from test_perfbench_reference import float32_served

NAME = "deepseek-v2-lite.doc-16k"
NEW = ("mla_prefill_ms", "shared_expert_ms", "moe_drop_share", "mla_flash_roofline",
       "mfu.prefill_mla")


@pytest.fixture(scope="module")
def ds_root(tmp_path_factory):
    return make_deepseek_root(tmp_path_factory.mktemp("deepseek"))


def test_the_cell_is_found_and_its_configuration_is_the_published_one():
    cell = SP.load_cell(NAME)
    cfg = MD.port_config(cell.conf)
    MD.check_layout(cfg, MD.weight_leaves(cell.conf))
    assert cfg.n_params() == 15_706_484_224
    assert cell.config["reduced"] == cell.conf["reduced"] == []
    assert [m["name"] for m in cell.metrics(trace=True)] == list(NEW)
    assert [m["name"] for m in cell.metrics(trace=False)] == ["tok_per_s", "ttft_p90_ms",
                                                              "setup_s"]
    t = cell.traffic
    assert (t["clients"], t["prompt_len"], t["max_new"], t["check_tokens"], t["trace_waves"]) \
        == (4, 16384, 8, 64, 2)
    assert set(cell.limits) == {"gap_p90", "logit_err_p50", "ad_labels", "ad_stats"}
    c, m = cell.conf, cell.model
    published = {"num_hidden_layers": "n_layers", "hidden_size": "d_model",
                 "vocab_size": "vocab", "num_attention_heads": "n_heads",
                 "kv_lora_rank": "kv_lora_rank", "qk_nope_head_dim": "qk_nope_dim",
                 "qk_rope_head_dim": "qk_rope_dim", "v_head_dim": "v_head_dim",
                 "intermediate_size": "d_ff", "moe_intermediate_size": "moe_dff",
                 "n_routed_experts": "moe_experts", "num_experts_per_tok": "moe_topk",
                 "n_shared_experts": "moe_shared_experts", "rms_norm_eps": "norm_eps",
                 "rope_theta": "rope_theta", "norm_topk_prob": "moe_renormalize",
                 "tie_word_embeddings": "tie_embeddings"}
    assert {k: c[k] for k in published} == {k: m[v] for k, v in published.items()}
    yarn = {"factor": "yarn_factor", "original_max_position_embeddings": "yarn_original_max_pos",
            "mscale_all_dim": "yarn_mscale_all_dim"}
    assert {k: c["rope_scaling"][k] for k in yarn} == {k: m[v] for k, v in yarn.items()}
    # the published keys the program fixes, which the reference writes out
    fixed = {k: c["rope_scaling"][k] for k in ("beta_fast", "beta_slow", "mscale")}
    assert fixed == {"beta_fast": RF.BETA_FAST, "beta_slow": RF.BETA_SLOW, "mscale": RF.MSCALE}
    assert (L.YARN_BETA_FAST, L.YARN_BETA_SLOW) == (RF.BETA_FAST, RF.BETA_SLOW)
    assert c["rope_scaling"]["mscale"] == c["rope_scaling"]["mscale_all_dim"]  # cos/sin × 1
    assert c["q_lora_rank"] is None and m["q_lora_rank"] == 0
    assert m["layout"][:c["first_k_dense_replace"]] == [["mla", "dense"]]
    assert m["layout"][c["first_k_dense_replace"]:] == [["mla", "moe"]] * 26
    assert len(c["departures"]) == 3


def test_the_reference_has_the_program_layout_at_a_small_size(ds_root):
    cell = SP.load_cell(CELL, ds_root)
    cfg = MD.port_config(cell.conf)
    leaves = MD.weight_leaves(cell.conf)
    MD.check_layout(cfg, leaves)
    with pytest.raises(ValueError, match="shared_gate"):
        MD.check_layout(cfg, [leaf for leaf in leaves if leaf[0][-1] != "shared_gate"])
    with pytest.raises(ValueError):
        MD.check_layout(dataclasses.replace(cfg, moe_shared_experts=0), leaves)


@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_the_reference_matches_the_program_in_float32(ds_root, seed):
    cell = SP.load_cell(CELL, ds_root)
    w, waves = float32_served(cell, seed)
    numbers = CK.model_numbers(cell, w, waves, [0, 1], "cpu")
    assert numbers["tokens"] == 2 * cell.traffic["clients"] * cell.traffic["max_new"]
    assert numbers["gap"] == 0.0
    assert numbers["logit_err"] < 1e-4


def test_the_bounds_count_the_published_model():
    m = SP.load_cell(NAME).model
    B, S = 4, 16384
    attn = 2.0 * B * 16 * (192 + 128) * S * (S + 1) / 2
    per_token = (2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048) * 27 \
        + 3 * 2048 * 10944 + 26 * (2048 * 64 + 6 * 3 * 2048 * 1408 + 3 * 2048 * 2816)
    want = 2.0 * per_token * B * S + 27 * attn + 2.0 * 2048 * 102400 * B
    assert peaks_mla.prefill_flops(m, B, S) == want
    assert want == pytest.approx(442.2549e12, rel=1e-6)
    bound = peaks_mla.flash_bound(B, S, 16, 192, 128)
    assert bound["flops"] == attn and bound["bound_by"] == "operations"
    assert bound["bytes"] == 2 * B * S * 16 * (192 + 192 + 128 + 128)


def _cell_run(waves, trace=None):
    return Run(SP.load_cell(NAME), waves, 0.0, 1.0, 1.0, trace)


def test_the_readers_arithmetic(monkeypatch):
    spans = [_span("model/prefill", 1, 0, 10, device_ms=1.0),  # before the window closed
             _span("mla/prefill", 2, 1, 11, device_ms=0.5)]
    for w, t0 in ((0, 2_000_000), (1, 3_000_000)):  # two traced waves
        base = 100 * (w + 1)
        spans += [_span("model/prefill", base, 0, t0, device_ms=1800.0),
                  _span("mla/prefill", base + 1, base, t0 + 1, device_ms=300.0 + w),
                  _span("mla/prefill", base + 2, base, t0 + 2, device_ms=300.0),
                  _span("moe", base + 3, base, t0 + 3, pairs=100, kept=90, slots=128),
                  _span("moe/shared", base + 4, base, t0 + 4, device_ms=60.0 + 2 * w),
                  _span("moe", base + 5, base, t0 + 5, pairs=100, kept=100, slots=128)]
        spans += [_span("model/decode_step", base + 10, 0, t0 + 100),
                  _span("moe", base + 11, base + 10, t0 + 101, pairs=24, kept=0, slots=64)]
    _with_spans(monkeypatch, spans)
    read = {m: SP.metric_reader(m).read(RUN) for m in NEW[:3]}
    assert read["mla_prefill_ms"] == pytest.approx(600.5)
    assert read["shared_expert_ms"] == pytest.approx(61.0)
    assert read["moe_drop_share"] == pytest.approx(5.0)  # decode's moe spans left out

    waves = closed_loop(3)
    for w, ms in zip(waves, (1810.0, 1790.0, 1800.0)):
        w.prefill_ms = ms
    trace = Trace(window_s=5.0, busy_s=4.0, by_kernel={
        "void flash_fwd_wgmma_bf16<256>(CUtensorMap_st)": (0.75, 54),
        "nvjet_tst_128x256": (1.0, 100)}, idle_by_range={}, n_waves=2)
    run = _cell_run(waves, trace)
    bound = peaks_mla.flash_bound(4, 16384, 16, 192, 128)["bound_s"]
    assert SP.metric_reader("mla_flash_roofline").read(run) == \
        pytest.approx(100.0 * bound * 54 / 0.75)
    mfu = SP.metric_reader("mfu.prefill_mla").read(run)
    assert mfu == pytest.approx(100.0 * peaks_mla.prefill_flops(run.model, 4, 16384)
                                / (1.8 * peaks.BF16_FLOPS))
    assert 0 < mfu < 100


def test_the_readers_find_nothing_in_a_program_without_the_spans(monkeypatch):
    # the parent's spans: moe counts no pairs, no mla/prefill or moe/shared span
    spans = [_span("model/prefill", 100, 0, 2_000_000, device_ms=1800.0),
             _span("moe", 101, 100, 2_000_001, device_ms=5.0, kept=90, slots=128)]
    _with_spans(monkeypatch, spans)
    assert [SP.metric_reader(m).read(RUN) for m in NEW[:3]] == [None] * 3
    waves = closed_loop(2)  # untimed waves and no trace
    assert SP.metric_reader("mla_flash_roofline").read(_cell_run(waves)) is None
    assert SP.metric_reader("mfu.prefill_mla").read(_cell_run(waves)) is None
    no_flash = Trace(window_s=1.0, busy_s=1.0, by_kernel={"nvjet": (1.0, 3)},
                     idle_by_range={}, n_waves=1)
    assert SP.metric_reader("mla_flash_roofline").read(_cell_run(waves, no_flash)) is None


def _no_renormalisation_undone(monkeypatch):
    real = MD.port_config
    monkeypatch.setattr(MD, "port_config",
                        lambda conf: dataclasses.replace(real(conf), moe_renormalize=True))


def _shared_experts_left_out(monkeypatch):
    from repro_torch.models import model as M

    monkeypatch.setattr(M, "shared_experts", lambda p, x, cfg: torch.zeros_like(x))


def _mscale_left_out(monkeypatch):
    from repro_torch.models import model as M

    monkeypatch.setattr(M, "_mla_scale", lambda cfg: 1.0 / math.sqrt(cfg.qk_dim))


def _latent_cache_stale(monkeypatch):
    """Decode steps that advance the position but leave the latent cache
    as they found it: the decoded tokens' latents are never kept."""
    from repro_torch.models import model as M

    real = M.decode_step

    def decode_step(cfg, params, cache, tokens, *a, **kw):
        before = [{k: v.clone() for k, v in layer.items()} for layer in cache["layers"]]
        logits, cache = real(cfg, params, cache, tokens, *a, **kw)
        for layer, old in zip(cache["layers"], before):
            for k, v in old.items():
                layer[k].copy_(v)
        return logits, cache

    monkeypatch.setattr(M, "decode_step", decode_step)


FAULTS = {"top_k_renormalised": _no_renormalisation_undone,
          "shared_experts_left_out": _shared_experts_left_out,
          "yarn_mscale_left_out": _mscale_left_out,
          "latent_cache_stale": _latent_cache_stale}


def test_the_tiny_cell_is_correct_as_it_is(ds_root):
    res = run_tiny(ds_root, CELL)
    assert res["correct"] is True
    assert {"tok_per_s", "ttft_p90_ms", "setup_s"} == set(res["metrics"])


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_deepseek_path_is_not_correct(ds_root, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    res = run_tiny(ds_root, CELL)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for k, c in res["checks"].items()
               if not k.startswith("ad_"))


def test_the_tiny_traced_cell_leaves_the_device_metrics_out_on_the_cpu(ds_root):
    res = run_tiny(ds_root, CELL, trace=True)
    assert res["correct"] is True
    assert not set(NEW) & set(res["metrics"])
