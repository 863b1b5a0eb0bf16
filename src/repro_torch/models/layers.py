"""Shared neural layers (port of ``repro.models.layers``): norms, RoPE/M-RoPE, attention, MLP.

Attention supports GQA/MQA grouping, causal and bidirectional,
sliding-window and logit softcapping.  Layouts follow the JAX package:
q (B,Sq,H,hd), k/v (B,Sk,KV,hd).  Two plain paths, as in JAX:

  * direct   — one einsum; short sequences and decode.
  * chunked  — online-softmax loops over (q, kv) blocks, the plain twin of
               the flash kernel, for sequences too long to materialise.

The prefill path of ``models.model`` runs the hand-written flash kernel
(``kernels.ops.flash_attention``) instead; these functions are what JAX
computes in XLA and what the port's forward and decode paths run.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """In float32, cast back to x's dtype; multiplies by ``w`` (not 1 + w)."""
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return torch.tanh(x / cap) * cap if cap > 0 else x


# ------------------------------------------------------------------- RoPE
def rope_cos_sin(
    positions: torch.Tensor, dim: int, theta: float = 10000.0
) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> cos/sin (..., dim//2), in float32."""
    half = dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


YARN_BETA_FAST, YARN_BETA_SLOW = 32.0, 1.0  # rotations that bound YaRN's ramp (DeepSeek-V2's)


def yarn_range(dim: int, theta: float, original: int) -> Tuple[int, int]:
    """YaRN's (low, high) pair indices: the dims whose wavelength fits
    ``YARN_BETA_FAST`` and ``YARN_BETA_SLOW`` rotations into ``original`` positions."""
    def at(rotations: float) -> float:
        return dim * math.log(original / (rotations * 2 * math.pi)) / (2 * math.log(theta))

    return max(math.floor(at(YARN_BETA_FAST)), 0), min(math.ceil(at(YARN_BETA_SLOW)), dim - 1)


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention scale 0.1·mscale·ln(factor) + 1 (1 for factor ≤ 1)."""
    return 0.1 * mscale * math.log(factor) + 1.0 if factor > 1 else 1.0


@functools.lru_cache(maxsize=None)
def yarn_inv_freq(dim: int, theta: float, factor: float, original: int,
                  device: torch.device) -> torch.Tensor:
    """YaRN's (dim//2,) float32 inverse frequencies, made once per device:
    θ^(−2i/dim) above pair ``high``, divided by ``factor`` below ``low``,
    blended linearly between (DeepSeek-V2's ``DeepseekV2YarnRotaryEmbedding``)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (factor * theta ** exps)
    low, high = yarn_range(dim, theta, original)
    ramp = (torch.arange(dim // 2, dtype=torch.float32, device=device) - low) / \
        (high - low if high != low else 0.001)
    keep = 1.0 - ramp.clamp(0.0, 1.0)  # 1: the pair keeps its frequency
    return inter * (1.0 - keep) + extra * keep


def yarn_cos_sin(positions: torch.Tensor, dim: int, theta: float, factor: float,
                 original: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> YaRN's cos/sin (..., dim//2), float32.  DeepSeek's
    factor on them, mscale(mscale)/mscale(mscale_all_dim), is 1: its two
    mscales are equal."""
    inv = yarn_inv_freq(dim, float(theta), float(factor), int(original), positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, hd); cos/sin (B, S, hd//2), cast to x's dtype first —
    rotate-half convention."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def mrope_cos_sin(
    pos3: torch.Tensor, dim: int, sections: Tuple[int, int, int], theta: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Qwen2-VL multimodal RoPE: pos3 (3, B, S) -> cos/sin (B, S, dim//2),
    in float32; sections are pair counts per (temporal, height, width)
    summing to dim//2, and each pair takes its angle from its section's row."""
    half = dim // 2
    assert sum(sections) == half, (sections, half)
    exps = torch.arange(half, dtype=torch.float32, device=pos3.device) / half
    freqs = 1.0 / (theta ** exps)
    ang = pos3.float()[..., None] * freqs  # (3, B, S, half)
    sec_id = _section_ids(tuple(sections), pos3.device)
    ang = torch.gather(ang, 0, sec_id.expand(1, *ang.shape[1:]))[0]
    return torch.cos(ang), torch.sin(ang)


@functools.lru_cache(maxsize=None)
def _section_ids(sections: Tuple[int, int, int], device: torch.device) -> torch.Tensor:
    """Each pair's row of pos3, made once per device: a host-to-device copy
    per decode step would make the host wait on the card each time."""
    return torch.repeat_interleave(torch.arange(3), torch.tensor(sections)).to(device)


def text_positions(batch: int, seq: int, offset: int = 0, device=None) -> torch.Tensor:
    return (torch.arange(seq, dtype=torch.int32, device=device)[None, :]
            + torch.zeros((batch, 1), dtype=torch.int32, device=device) + offset)


def mrope_text_positions(batch: int, seq: int, offset: int = 0, device=None) -> torch.Tensor:
    """Degenerate (t=h=w) M-RoPE positions (3, B, S) for text-only streams."""
    return text_positions(batch, seq, offset, device=device)[None].expand(3, batch, seq)


# -------------------------------------------------------------- attention
def _mask_bias(
    qpos: torch.Tensor,
    kpos: torch.Tensor,
    causal: bool,
    window: int,
    kv_len: Optional[Union[int, torch.Tensor]] = None,
) -> torch.Tensor:
    """(…, Sq, Sk) additive float32 bias from query/key absolute positions."""
    q = qpos[..., :, None]
    k = kpos[..., None, :]
    ok = k >= 0  # kpos = -1 marks unwritten cache slots
    ok = ok.expand(torch.broadcast_shapes(q.shape, k.shape))
    if causal:
        ok = ok & (k <= q)
    if window > 0:
        ok = ok & ((q - k) < window)
    if kv_len is not None:
        ok = ok & (k < kv_len)
    return torch.where(ok, 0.0, NEG_INF).float()


def _gqa_scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    """q (B,Sq,H,hd) k (B,Sk,KV,hd) -> float32 scores (B,KV,G,Sq,Sk)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    return torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale


def attention_direct(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    cap: float = 0.0,
    scale: Optional[float] = None,
    qpos: Optional[torch.Tensor] = None,
    kpos: Optional[torch.Tensor] = None,
    kv_len=None,
) -> torch.Tensor:
    """Materialised-scores attention. q (B,Sq,H,hd), k/v (B,Sk,KV,hd)."""
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    if qpos is None:
        qpos = torch.arange(Sq, device=q.device)[None]
    if kpos is None:
        kpos = torch.arange(Sk, device=q.device)[None]
    s = softcap(_gqa_scores(q, k, scale), cap)  # (B,KV,G,Sq,Sk) fp32
    s = s + _mask_bias(qpos, kpos, causal, window, kv_len)[:, None, None]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def attention_partial(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    window: int,
    cap: float,
    scale: float,
    qpos: torch.Tensor,
    kpos: torch.Tensor,
    kv_len=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unnormalised attention over a KV block: returns (acc, m, l).

    out = Σ_blocks acc·e^{m−m*} / Σ_blocks l·e^{m−m*}; decode uses it over
    the whole cache, the chunked path over each kv chunk.
    """
    s = softcap(_gqa_scores(q, k, scale), cap)
    s = s + _mask_bias(qpos, kpos, causal, window, kv_len)[:, None, None]
    m = s.amax(dim=-1)  # (B,KV,G,Sq)
    p = torch.exp(s - m[..., None])
    # rows that saw only masked keys: zero contribution
    dead = m <= NEG_INF / 2
    p = torch.where(dead[..., None], 0.0, p)
    m = torch.where(dead, NEG_INF, m)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, v.float())
    return acc, m, l


def attention_chunked(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    cap: float = 0.0,
    scale: Optional[float] = None,
    q_offset: int = 0,
    k_offset: int = 0,
    chunk_q: int = 512,
    chunk_k: int = 1024,
) -> torch.Tensor:
    """Online-softmax attention over (chunk_q, chunk_k) blocks, O(S·chunk)
    live memory: the loops of JAX's double ``lax.scan``."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    dv = v.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    assert Sq % cq == 0 and Sk % ck == 0, (Sq, cq, Sk, ck)
    blocks = []
    for q0 in range(0, Sq, cq):
        qb = q[:, q0:q0 + cq]
        qp = (torch.arange(cq, device=q.device) + q0 + q_offset)[None]
        m = torch.full((B, KV, G, cq), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, KV, G, cq), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, KV, G, cq, dv), dtype=torch.float32, device=q.device)
        for k0 in range(0, Sk, ck):
            kp = (torch.arange(ck, device=q.device) + k0 + k_offset)[None]
            a, mb, lb = attention_partial(
                qb, k[:, k0:k0 + ck], v[:, k0:k0 + ck], causal=causal, window=window,
                cap=cap, scale=scale, qpos=qp, kpos=kp,
            )
            m_new = torch.maximum(m, mb)
            r_old = torch.exp(m - m_new)
            r_new = torch.exp(mb - m_new)
            acc = acc * r_old[..., None] + a * r_new[..., None]
            l = l * r_old + lb * r_new
            m = m_new
        out = acc / l.clamp(min=1e-30)[..., None]
        blocks.append(out.permute(0, 3, 1, 2, 4).reshape(B, cq, H, dv).to(q.dtype))
    return torch.cat(blocks, dim=1)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    cap: float = 0.0,
    scale: Optional[float] = None,
    direct_threshold: int = 1024,
    chunk_q: int = 512,
    chunk_k: int = 1024,
) -> torch.Tensor:
    """Dispatch: direct einsum for short S, chunked online softmax for long."""
    Sq, Sk = q.shape[1], k.shape[1]
    if max(Sq, Sk) <= direct_threshold or Sq % min(chunk_q, Sq) or Sk % min(chunk_k, Sk):
        return attention_direct(q, k, v, causal=causal, window=window, cap=cap, scale=scale)
    return attention_chunked(
        q, k, v, causal=causal, window=window, cap=cap, scale=scale,
        chunk_q=chunk_q, chunk_k=chunk_k,
    )


# --------------------------------------------------------------------- MLP
# The activations are written op by op as jax.nn writes them, each op in
# x's dtype: in bf16 every op rounds, as it does in JAX, where the fused
# F.silu / F.gelu(approximate="tanh") round once and differ from JAX in
# about 40 % of bf16 outputs.  In float32 the two forms agree to rounding.
def silu(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.silu: x * sigmoid(x), sigmoid(x) = 1 / (1 + exp(-x))."""
    return x * (1.0 / (1.0 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)),
    rounded op by op as JAX rounds it (``F.softplus`` rounds once)."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype``, as a Python float.

    Multiplying a tensor by it rounds like an op with a constant held in
    that dtype (as JAX holds it), and, unlike a device tensor built from
    ``v``, needs no blocking host-to-device copy.
    """
    return float(torch.tensor(v, dtype=dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.gelu(approximate=True), with its constants rounded to x's dtype."""
    k0, k1 = rounded(math.sqrt(2.0 / math.pi), x.dtype), rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(k0 * (x + k1 * (x * x * x)))))


def mlp(p, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif activation == "geglu":
        h = gelu_tanh(x @ p["w_gate"]) * (x @ p["w_up"])
    else:  # plain dense gelu (hubert)
        h = gelu_tanh(x @ p["w_up"])
    return h @ p["w_down"]
