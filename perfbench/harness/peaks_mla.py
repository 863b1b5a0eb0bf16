"""The yardstick's numbers for a model of latent attention (MLA) and
shared experts, DeepSeek-V2's: the least time of its flash launch and the
model operations of its prefill.  The peaks are :mod:`peaks`' (one H100
SXM); :mod:`peaks` counts no MLA mixer and no shared expert, and its
``flash_bound`` takes one head dim for q, k and v.
"""
from __future__ import annotations

from .peaks import BF16_FLOPS, _bound


def flash_bound(B: int, S: int, H: int, qk: int, v: int) -> dict:
    """Causal bf16 MLA attention's least time for one launch over S
    positions, on its unpadded widths: QK^T at ``qk`` and PV at ``v`` over
    the S(S+1)/2 live (query, key) pairs of each of H heads at the bf16
    tensor cores' rate, against q and k (qk wide, every head) and v read
    once and the output (v wide) written once, bf16."""
    flops = 2.0 * B * H * (qk + v) * (S * (S + 1) / 2)
    nbytes = 2 * B * S * H * (2 * qk + 2 * v)
    return _bound(flops, nbytes, BF16_FLOPS)


def layer_params(m: dict, mlp: str) -> int:
    """Weights a token multiplies by in one MLA layer with its MLP (norms
    are not products): wq (no query latent), wdkv, wuk, wuv and wo; the
    dense SwiGLU, or the router, ``moe_topk`` routed experts and the shared
    SwiGLU."""
    d, H = m["d_model"], m["n_heads"]
    nope, rope, kvr, vh = m["qk_nope_dim"], m["qk_rope_dim"], m["kv_lora_rank"], m["v_head_dim"]
    n = d * H * (nope + rope) + d * (kvr + rope) + kvr * H * (nope + vh) + H * vh * d
    if mlp == "dense":
        n += 3 * d * m["d_ff"]
    elif mlp == "moe":
        n += d * m["moe_experts"] + m["moe_topk"] * 3 * d * m["moe_dff"]
        n += 3 * d * m["moe_shared_experts"] * m["moe_dff"]
    return n


def prefill_flops(m: dict, B: int, S: int) -> float:
    """The model operations of one prefill of B prompts of S tokens: 2 per
    multiply-add of every token through each layer's active weights
    (:func:`layer_params`), the causal QK^T at nope + rope and PV at v over
    the live pairs of every layer, and the logits of each prompt's last
    position.  The embedding is a lookup and counts nothing."""
    n_periods = m["n_layers"] // len(m["layout"])
    per_token = sum(layer_params(m, mlp) for _, mlp in m["layout"]) * n_periods
    attn = flash_bound(B, S, m["n_heads"], m["qk_nope_dim"] + m["qk_rope_dim"],
                       m["v_head_dim"])["flops"] * m["n_layers"]
    return 2.0 * per_token * B * S + attn + 2.0 * m["d_model"] * m["vocab"] * B
