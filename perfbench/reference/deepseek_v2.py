"""Plain float32 reference of DeepSeek-V2 (DeepSeek-AI, arXiv:2405.04434)
as the configuration file's ``model`` block states it: DeepSeek-V2-Lite's
block, multi-head latent attention with no query latent, YaRN rope, a
leading dense SwiGLU and then mixtures of fine-grained routed experts with
always-on shared experts.

Each layer is a pre-norm residual MLA mixer followed by a pre-norm
residual MLP.  The mixer over whole sequences, per head h:

    q       = u W_q                       (nope + rope per head)
    c, k_r  = split(u W_dkv)              (kv_lora_rank, rope)
    c       = RMSNorm(c)
    k_nope  = c W_uk,  v = c W_uv
    q_r, k_r rotated (rotate-half) by YaRN's table, k_r shared by every head
    out     = softmax(causal, [q_nope, q_r]·[k_nope, k_r] · scale) v  W_o

with scale = (nope + rope)^(-1/2) · mscale(mscale_all_dim)^2.  YaRN's
inverse frequencies over the rope dim, written from its formula:
freq_extra = theta^(-2i/rope), freq_inter = freq_extra / factor, and
inv = freq_inter · (1 - mask) + freq_extra · mask, mask = 1 - clamp((i - low)
/ (high - low), 0, 1), low = floor(c(beta_fast)), high = ceil(c(beta_slow)),
c(r) = rope · ln(original / (2 pi r)) / (2 ln theta); cos and sin are
multiplied by mscale(mscale) / mscale(mscale_all_dim), mscale(m) = 0.1 · m ·
ln(factor) + 1.  The program's configuration carries neither beta nor
``mscale`` (DeepSeek-V2-Lite's alone is run), so they are the published
``rope_scaling``'s, below.

The MLP is a SwiGLU (``silu(x W_gate) * (x W_up) W_down``) at the layout's
dense positions, else the mixture: each token's ``moe_topk`` experts by the
softmax of ``x W_router`` (ties to the lower index), each weighted by its
probability as it is (``moe_renormalize`` false; renormalised over the
chosen ones where true), plus the shared experts, one SwiGLU of width
``moe_shared_experts · moe_dff`` on every token.  Each routed expert's load
per routing call is bounded at ``max(ceil(topk · N / E · capacity_factor),
min(N, 16))`` tokens of the call's N, taken in token order; a token past
its expert's bound gets nothing from that expert.  A served batch routes
once per call: the prompt rows of one batch together, then each decoded
position of the batch on its own, so ``logits`` takes the rows' grouping
(``groups``) and the prompt length.

Departures from the published model, which the program shares and the
configuration file lists:

* the capacity bound above (the published model routes without drops at
  inference), as in the Jamba cell; on the cell doc-16k with random
  weights it drops 11.9-13.4 % of a prefill's routed pairs;
* the program computes the router's product in its compute dtype, where
  the published code computes it in float32 (here float32, as everything);
* rotate-half on contiguous rope columns, where the published checkpoint
  interleaves them: a published checkpoint would need its rope columns
  permuted on load; random weights are drawn in the program's layout.

Float32 throughout from the benchmark's weights, TF32 off, one layer at a
time over blocks of whole groups, attention in blocks of queries.  It
imports nothing of the program.  ``quant="fp8"`` is the control, as in
:mod:`mamba1`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .jamba import block_groups, swiglu
from .mamba1 import f32, final_logits, layer_weights, linear, rms_norm, top_leaves

Q_CHUNK = 256  # query rows per block of attention scores


def mla_leaves(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    d, H = m["d_model"], m["n_heads"]
    nope, rope, kvr, vh = m["qk_nope_dim"], m["qk_rope_dim"], m["kv_lora_rank"], m["v_head_dim"]
    if m["q_lora_rank"]:
        raise ValueError("this reference has no query latent (q_lora_rank 0)")
    return {"ln1": ((d,), "ones"), "wq": ((d, H * (nope + rope)), "dense"),
            "wdkv": ((d, kvr + rope), "dense"), "kv_ln": ((kvr,), "ones"),
            "wuk": ((kvr, H * nope), "dense"), "wuv": ((kvr, H * vh), "dense"),
            "wo": ((H * vh, d), "dense")}


def mlp_leaves(m: dict, kind: str) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    d = m["d_model"]
    if kind == "dense":
        f = m["d_ff"]
        return {"ln2": ((d,), "ones"), "w_gate": ((d, f), "dense"),
                "w_up": ((d, f), "dense"), "w_down": ((f, d), "dense")}
    E, f, fs = m["moe_experts"], m["moe_dff"], m["moe_shared_experts"] * m["moe_dff"]
    out = {"ln2": ((d,), "ones"), "router": ((d, E), "dense"),
           "moe_gate": ((E, d, f), "dense"), "moe_up": ((E, d, f), "dense"),
           "moe_down": ((E, f, d), "dense")}
    if fs:
        out.update({"shared_gate": ((d, fs), "dense"), "shared_up": ((d, fs), "dense"),
                    "shared_down": ((fs, d), "dense")})
    return out


def leaves(m: dict) -> List[Tuple[Tuple, Tuple[int, ...], str]]:
    """Every weight as (path, shape with the period axis, init kind)."""
    n_periods = m["n_layers"] // len(m["layout"])
    out = top_leaves(m)
    for i, (mixer, mlp) in enumerate(m["layout"]):
        if mixer != "mla" or mlp not in ("dense", "moe"):
            raise ValueError(f"a DeepSeek-V2 layer is MLA with a dense or moe MLP, got "
                             f"{mixer}/{mlp}")
        block = dict(mla_leaves(m))
        block.update(mlp_leaves(m, mlp))
        out += [(("layers", i, k), (n_periods, *s), kind) for k, (s, kind) in block.items()]
    return out


def float32_leaf(name: str) -> bool:
    return name == "final_ln"


# ------------------------------------------------------------------- YaRN
BETA_FAST, BETA_SLOW, MSCALE = 32, 1, 0.707  # DeepSeek-V2-Lite's rope_scaling


def yarn_mscale(factor: float, mscale: float) -> float:
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


def yarn_range(m: dict) -> Tuple[int, int]:
    dim, theta, original = m["qk_rope_dim"], m["rope_theta"], m["yarn_original_max_pos"]

    def c(rotations: float) -> float:
        return dim * math.log(original / (2 * math.pi * rotations)) / (2 * math.log(theta))

    return max(math.floor(c(BETA_FAST)), 0), min(math.ceil(c(BETA_SLOW)), dim - 1)


def inv_freq(m: dict) -> torch.Tensor:
    """(rope/2,) float64 inverse frequencies: YaRN's where ``yarn_factor``
    is set, else theta^(-2i/rope)."""
    dim, theta = m["qk_rope_dim"], m["rope_theta"]
    i = torch.arange(dim // 2, dtype=torch.float64)
    extra = theta ** (-2.0 * i / dim)
    factor = m["yarn_factor"]
    if not factor:
        return extra
    low, high = yarn_range(m)
    mask = 1.0 - ((i - low) / max(high - low, 1e-3)).clamp(0.0, 1.0)
    return extra / factor * (1.0 - mask) + extra * mask


def rope_table(m: dict, T: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos, sin (T, rope/2), float32, of positions 0 .. T-1."""
    ang = torch.arange(T, dtype=torch.float64)[:, None] * inv_freq(m)[None, :]
    scale = 1.0
    if m["yarn_factor"]:
        scale = (yarn_mscale(m["yarn_factor"], MSCALE)
                 / yarn_mscale(m["yarn_factor"], m["yarn_mscale_all_dim"]))
    return ((torch.cos(ang) * scale).to(torch.float32).to(device),
            (torch.sin(ang) * scale).to(torch.float32).to(device))


def softmax_scale(m: dict) -> float:
    scale = (m["qk_nope_dim"] + m["qk_rope_dim"]) ** -0.5
    if m["yarn_factor"] and m["yarn_mscale_all_dim"]:
        scale *= yarn_mscale(m["yarn_factor"], m["yarn_mscale_all_dim"]) ** 2
    return scale


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half over the last dim of x (R, T, heads, rope); cos/sin (T, rope/2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# ------------------------------------------------------------------ layers
def mla(p: Dict[str, torch.Tensor], u: torch.Tensor, m: dict, cos, sin,
        quant: Optional[str]) -> torch.Tensor:
    """Causal MLA over whole sequences u (R, T, d)."""
    R, T, _ = u.shape
    H, nope, rope = m["n_heads"], m["qk_nope_dim"], m["qk_rope_dim"]
    kvr, vh = m["kv_lora_rank"], m["v_head_dim"]
    q = linear(u, p["wq"], quant).view(R, T, H, nope + rope)
    dkv = linear(u, p["wdkv"], quant)
    c = rms_norm(dkv[..., :kvr], p["kv_ln"], m["norm_eps"])
    k_rope = rotate(dkv[..., kvr:].reshape(R, T, 1, rope), cos, sin)
    q = torch.cat([q[..., :nope], rotate(q[..., nope:], cos, sin)], dim=-1)
    k = torch.cat([linear(c, p["wuk"], quant).view(R, T, H, nope),
                   k_rope.expand(R, T, H, rope)], dim=-1)
    v = linear(c, p["wuv"], quant).view(R, T, H, vh)
    del dkv, c, k_rope
    q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))  # (R, H, T, .)
    scale = softmax_scale(m)
    out = torch.empty((R, T, H, vh), dtype=torch.float32, device=u.device)
    for q0 in range(0, T, Q_CHUNK):
        q1 = min(T, q0 + Q_CHUNK)  # keys past q1 - 1 are in every query's future
        s = (q[:, :, q0:q1] @ k[:, :, :q1].transpose(-1, -2)) * scale
        future = torch.arange(q1, device=u.device)[None, :] > \
            torch.arange(q0, q1, device=u.device)[:, None]
        s = s.masked_fill(future, float("-inf"))
        out[:, q0:q1] = (torch.softmax(s, dim=-1) @ v[:, :, :q1]).transpose(1, 2)
    return linear(out.view(R, T, H * vh), p["wo"], quant)


def route(p: Dict[str, torch.Tensor], x: torch.Tensor, m: dict, quant: Optional[str]):
    """One routing call over the N tokens of x (N, d), in their order ->
    (kept (N, E) bool, weight (N, E) float32)."""
    N = x.shape[0]
    E, k = m["moe_experts"], m["moe_topk"]
    probs = torch.softmax(linear(x, p["router"], quant), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    if m["moe_renormalize"]:
        vals = vals / vals.sum(-1, keepdim=True).clamp(min=1e-9)
    weight = torch.zeros((N, E), dtype=torch.float32, device=x.device)
    weight.scatter_(1, ids, vals)
    chosen = torch.zeros((N, E), dtype=torch.bool, device=x.device)
    chosen.scatter_(1, ids, True)
    bound = max(math.ceil(k * N / E * m["moe_capacity_factor"]), min(N, 16))
    return chosen & (torch.cumsum(chosen.to(torch.int64), dim=0) <= bound), weight


def moe(p: Dict[str, torch.Tensor], x: torch.Tensor, m: dict, groups: Sequence[Sequence[int]],
        prompt_len: int, quant: Optional[str]) -> torch.Tensor:
    """The routed experts over x (R, T, d), plus the shared ones: per group
    of rows, one routing call over its prompt positions (row-major), then
    one per later position; each expert then runs once over the tokens all
    calls kept for it."""
    R, T, d = x.shape
    flat = x.reshape(R * T, d)
    pos = torch.arange(T, device=x.device)
    calls = []
    for rows in groups:
        rows = torch.as_tensor(list(rows), device=x.device)
        calls.append((rows[:, None] * T + pos[None, :prompt_len]).flatten())
        calls += [rows * T + t for t in range(prompt_len, T)]
    routed = [route(p, flat[idx], m, quant) for idx in calls]
    idx = torch.cat(calls)
    kept = torch.cat([r[0] for r in routed])
    weight = torch.cat([r[1] for r in routed])
    del routed
    out = torch.zeros_like(flat)
    for e in range(m["moe_experts"]):
        sel = torch.nonzero(kept[:, e]).flatten()
        if sel.numel():
            toks = idx[sel]
            y = swiglu(flat[toks], p["moe_gate"][e], p["moe_up"][e], p["moe_down"][e], quant)
            out.index_add_(0, toks, y * weight[sel, e, None])
    if m["moe_shared_experts"]:
        out += swiglu(flat, p["shared_gate"], p["shared_up"], p["shared_down"], quant)
    return out.view(R, T, d)


@torch.no_grad()
def logits(m: dict, weights, tokens: torch.Tensor, n_last: int, *,
           groups: Optional[Sequence[Sequence[int]]] = None, prompt_len: Optional[int] = None,
           quant: Optional[str] = None, rows_per_block: int = 4) -> torch.Tensor:
    """Float32 logits at the last ``n_last`` positions of each row of
    ``tokens`` (R, T): (R, n_last, vocab).  ``groups`` (lists of row
    indices) are the batches the rows were served in, ``prompt_len`` their
    prompt length; by default every row is its own batch and all of T is
    prompt."""
    R, T = tokens.shape
    groups = [[r] for r in range(R)] if groups is None else groups
    prompt_len = T if prompt_len is None else prompt_len
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        n_periods = m["n_layers"] // len(m["layout"])
        cos, sin = rope_table(m, T, tokens.device)
        out = torch.empty((R, n_last, m["vocab"]), dtype=torch.float32, device=tokens.device)
        for block in block_groups(groups, rows_per_block):
            rows = [r for g in block for r in g]
            local = {r: i for i, r in enumerate(rows)}
            local_groups = [[local[r] for r in g] for g in block]
            x = f32(weights["embed"][tokens[rows]])
            for period in range(n_periods):
                for i, (_, mlp) in enumerate(m["layout"]):
                    p = layer_weights(weights, i, period)
                    x = x + mla(p, rms_norm(x, p["ln1"], m["norm_eps"]), m, cos, sin, quant)
                    h = rms_norm(x, p["ln2"], m["norm_eps"])
                    if mlp == "dense":
                        x = x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"], quant)
                    else:
                        x = x + moe(p, h, m, local_groups, prompt_len, quant)
            out[rows] = final_logits(m, weights, x[:, -n_last:], quant)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
