"""The yardstick's numbers: the card's published peaks, the least time of
each kernel the benchmark reads, and the model operations of a prefill.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, 700 W):
989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32 outside them,
3.35 TB/s of HBM3.  The bounds are those the port's bring-up measured its
kernels against (``chip_smoke.py``: ``scan_bound`` and the bf16 causal case
of ``flash_bound``), copied here so that the program cannot move them.
"""
from __future__ import annotations

BF16_FLOPS = 989e12
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

SCAN_OPS_PER_STATE = 4  # h = a*h + b (2), h*C and its share of the sum over st (2)


def _bound(flops: float, nbytes: float, flops_per_s: float) -> dict:
    ops_s, bytes_s = flops / flops_per_s, nbytes / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes, "ops_s": ops_s, "bytes_s": bytes_s,
            "bound_s": max(ops_s, bytes_s),
            "bound_by": "operations" if ops_s >= bytes_s else "bytes"}


def scan_bound(B: int, S: int, di: int, st: int) -> dict:
    """The selective scan's least time for one launch: a and b (B,S,di,st)
    and C (B,S,st) read once, y (B,S,di) and h_last (B,di,st) written once,
    all float32, against SCAN_OPS_PER_STATE float32 operations per state
    element and step."""
    nbytes = 4 * (2 * B * S * di * st + B * S * st + B * S * di + B * di * st)
    return _bound(float(SCAN_OPS_PER_STATE * B * S * di * st), nbytes, F32_FLOPS)


def flash_bound(B: int, S: int, H: int, KV: int, hd: int) -> dict:
    """Causal bf16 self-attention's least time for one launch over S
    positions: the QK^T and PV products of the S(S+1)/2 live (query, key)
    pairs at the bf16 tensor cores' rate, against q, k, v read once and the
    output written once."""
    flops = 2.0 * 2 * hd * B * H * (S * (S + 1) / 2)
    nbytes = 2 * (B * S * H * 2 * hd + B * S * KV * 2 * hd)
    return _bound(flops, nbytes, BF16_FLOPS)


def layer_params(m: dict, mixer: str, mlp: str, active: bool) -> int:
    """Weights a token multiplies by in one layer (norms and the scan's
    per-channel vectors are not products); with ``active`` only its
    ``moe_topk`` experts of a mixture."""
    d = m["d_model"]
    n = 0
    if mixer == "mamba":
        di, st, dr = m["ssm_expand"] * d, m["ssm_d_state"], m["dt_rank"]
        n += d * 2 * di + di * (dr + 2 * st) + dr * di + di * d
    elif mixer == "full":
        n += d * m["head_dim"] * (2 * m["n_heads"] + 2 * m["n_kv_heads"])
    if mlp == "dense":
        n += 3 * d * m["d_ff"]
    elif mlp == "moe":
        n += d * m["moe_experts"]
        n += (m["moe_topk"] if active else m["moe_experts"]) * 3 * d * m["moe_dff"]
    return n


def prefill_flops(m: dict, B: int, S: int) -> float:
    """The model operations of one prefill of B prompts of S tokens: 2 per
    multiply-add of every token through each layer's active weights, the
    causal attention products (QK^T and PV over the live pairs), and the
    logits of each prompt's last position.  The embedding is a lookup and
    counts nothing; the scan's own operations are its kernel's (above)."""
    n_periods = m["n_layers"] // len(m["layout"])
    per_token = sum(layer_params(m, mixer, mlp, True) for mixer, mlp in m["layout"])
    flops = 2.0 * per_token * n_periods * B * S
    n_attn = sum(mixer == "full" for mixer, _ in m["layout"]) * n_periods
    flops += n_attn * 2.0 * 2 * m.get("head_dim", 0) * m.get("n_heads", 0) * B * S * (S + 1) / 2
    return flops + 2.0 * m["d_model"] * m["vocab"] * B


def mfu(flops: float, seconds: float, chips: int = 1) -> float:
    """The share of ``chips`` cards' bf16 peak that ``flops`` in ``seconds`` is."""
    return flops / (seconds * BF16_FLOPS) / chips
