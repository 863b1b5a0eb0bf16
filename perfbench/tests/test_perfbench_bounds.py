"""The copied bounds against the values the port's bring-up recorded."""
from __future__ import annotations

import pytest

from perfbench.harness import peaks


def test_scan_bound_at_falcon_mamba_wave_of_4():
    b = peaks.scan_bound(4, 1024, 8192, 16)
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] * 1e6 == pytest.approx(1322.8, abs=0.05)
    assert b["bytes"] == 4_431_544_320


def test_flash_bound_at_gemma_bf16_wave():
    b = peaks.flash_bound(4, 1024, 8, 1, 256)
    assert b["bound_by"] == "operations"
    assert b["bound_s"] * 1e6 == pytest.approx(17.39, abs=0.005)
    assert b["flops"] == pytest.approx(17.20e9, rel=1e-3)


def test_prefill_flops_counts_active_experts_and_causal_pairs():
    m = {"n_layers": 2, "d_model": 8, "vocab": 16, "layout": [["full", "moe"], ["mamba", "dense"]],
         "n_heads": 2, "n_kv_heads": 1, "head_dim": 4, "d_ff": 16, "moe_experts": 4,
         "moe_topk": 2, "moe_dff": 16, "ssm_expand": 2, "ssm_d_state": 4, "dt_rank": 2}
    attn = 8 * 4 * (2 * 2 + 2 * 1)
    moe = 8 * 4 + 2 * 3 * 8 * 16
    mamba = 8 * 32 + 16 * (2 + 8) + 2 * 16 + 16 * 8
    dense = 3 * 8 * 16
    B, S = 3, 5
    want = 2.0 * (attn + moe + mamba + dense) * B * S + 2.0 * 2 * 4 * 2 * B * S * (S + 1) / 2 \
        + 2.0 * 8 * 16 * B
    assert peaks.prefill_flops(m, B, S) == pytest.approx(want)
    assert peaks.mfu(989e12, 1.0) == pytest.approx(1.0)
