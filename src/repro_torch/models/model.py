"""The model (port of ``repro.models.model``): forward, loss, prefill, decode.

Modes:
  forward / loss_and_metrics
               full-sequence pass (attention through ``layers.attention``,
               Mamba through ``mamba.mamba_sequence``); the training path
  prefill      sequence pass that also builds the decode cache; its
               attention runs the hand-written flash kernel and its Mamba
               layers the hand-written scan kernel (``kernels.ops``)
  decode_step  single-token step against the cache

The subset of the JAX model ported so far: FULL, SWA and MAMBA mixers, the
dense MLP (or none), ``sandwich_norm``, ``emb_scale`` and both softcaps.
MLA and MoE raise ``NotImplementedError`` naming their ROADMAP.md item.

Differences of form, not of values, from the JAX package:
  * ``lax.scan`` over periods is a Python loop over layers; parameters and
    caches keep JAX's layout, stacked over periods per layout position.
  * The cache is updated in place (JAX donates it instead), and its ``pos``
    is a host int, so a decode step never waits on the device for it.
  * forward, prefill and decode_step take weights already in the compute
    dtype: cast the float32 master weights once with :func:`compute_params`
    (see there), where JAX casts them inside every call.  The training
    path, :func:`loss_and_metrics`, takes the master weights and casts them
    where JAX does (in each block, in the embedding lookup and in each
    cross-entropy chunk's unembedding), so autograd carries float32
    gradients back to them.
  * ``jax.checkpoint`` is ``torch.utils.checkpoint`` (non-reentrant).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve
from ..kernels import ops
from . import layers as L
from . import mamba as MB
from .common import MAMBA, MLA, MOE, NONE, SWA, LayerSpec, ModelConfig, unported


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """How the current step runs.  The port runs on one device: meshes and
    sequence parallelism wait for ROADMAP.md queue 1, item 11."""

    remat: str = "none"  # none | block


def _check_supported(cfg: ModelConfig) -> None:
    """Raise for what the port does not cover yet; every path starts here
    (embed_tokens, init_cache)."""
    if cfg.modality != "text":
        raise unported(cfg.modality)
    if cfg.pos == "mrope":
        raise unported("mrope")
    for spec in cfg.layout:
        if spec.mixer == MLA:
            raise unported(MLA)
        if spec.mlp == MOE:
            raise unported(MOE)


# ---------------------------------------------------------------- embedding
def embed_tokens(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    _check_supported(cfg)
    if params["embed"].dtype != cfg.compute_dtype:
        raise ValueError(f"weights are {params['embed'].dtype}, the config computes in "
                         f"{cfg.compute_dtype}: pass compute_params(cfg, params)")
    return _embed(cfg, params["embed"], batch["tokens"])


def _embed(cfg: ModelConfig, table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``table`` cast to the compute dtype (a no-op for compute
    weights), scaled as gemma scales them."""
    x = F.embedding(tokens, table).to(cfg.compute_dtype)
    if cfg.emb_scale:
        # The scale is rounded to the compute dtype before the multiply, as
        # in JAX: in bf16, sqrt(2048) = 45.2548 becomes 45.25.
        x = x * L.rounded(math.sqrt(cfg.d_model), cfg.compute_dtype)
    return x


def _positions(cfg: ModelConfig, B: int, S: int, offset: int = 0, device=None) -> torch.Tensor:
    return L.text_positions(B, S, offset, device=device)  # M-RoPE: _check_supported


def _rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor, dim: int):
    if cfg.pos == "none":
        return None, None
    return L.rope_cos_sin(positions, dim, cfg.rope_theta)


def unembed(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """-> float32 logits over the padded vocab, padding columns at -1e30."""
    x = L.rms_norm(x, params["final_ln"], cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T.to(cfg.compute_dtype)
    else:
        logits = x @ params["unembed"].to(cfg.compute_dtype)
    logits = L.softcap(logits.float(), cfg.logit_softcap)
    if cfg.vocab_padded != cfg.vocab:  # mask the padding columns exactly
        pad_ok = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab
        logits = torch.where(pad_ok, logits, L.NEG_INF)
    return logits


# ----------------------------------------------------------------- blocks
_F32_KEYS = frozenset({"A_log"})  # kept f32: used only inside f32 math


def _cast_block_params(p: Dict[str, torch.Tensor], dtype) -> Dict[str, torch.Tensor]:
    """Compute-dtype casts of the float32 master weights (mixed precision)."""
    return {k: (v if k in _F32_KEYS else v.to(dtype)) for k, v in p.items()}


def compute_params(cfg: ModelConfig, params) -> Dict[str, Any]:
    """The weights forward, prefill and decode_step compute with, cast once.

    JAX casts the float32 master weights to the compute dtype inside every
    call (``_cast_block_params`` in apply_block, decode_block and prefill;
    the embedding in embed_tokens and unembed): at gemma-2b's full width
    that is 18 × 110 M parameters per decode token.  The cast is elementwise
    and deterministic, so casting once here and keeping the copy gives the
    same values every call would have computed; the entry points then cast
    nothing.  ``final_ln`` stays float32 as JAX reads it (``rms_norm``
    widens its weight to float32 either way, but a bf16 round trip would
    change it).
    """
    dt = cfg.compute_dtype
    out = {
        "embed": params["embed"].to(dt),
        "final_ln": params["final_ln"],
        "layers": [_cast_block_params(p, dt) for p in params["layers"]],
    }
    if "unembed" in params:
        out["unembed"] = params["unembed"].to(dt)
    return out


def _layer(params, pos: int, period: int) -> Dict[str, torch.Tensor]:
    """One layer's weights: the ``period`` slice of layout position ``pos``."""
    return {k: v[period] for k, v in params["layers"][pos].items()}


def _qkv(cfg, p, h, cos, sin):
    B, S, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    k = (h @ p["wk"]).reshape(B, S, KV, hd)
    v = (h @ p["wv"]).reshape(B, S, KV, hd)
    if cos is not None:
        q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    return q, k, v


def _attn_seq(cfg, spec, p, h, cos, sin) -> torch.Tensor:
    B, S, _ = h.shape
    q, k, v = _qkv(cfg, p, h, cos, sin)
    window = cfg.window if spec.mixer == SWA else 0
    out = L.attention(q, k, v, causal=cfg.causal, window=window, cap=cfg.attn_softcap)
    return out.reshape(B, S, -1) @ p["wo"]


def _attn_seq_with_cache(cfg, spec, p, h, cos, sin):
    """Prefill: returns (attn_out, (k_full, v_full)); attention through the
    flash kernel (its plain version for CPU tensors)."""
    B, S, _ = h.shape
    q, k, v = _qkv(cfg, p, h, cos, sin)
    window = cfg.window if spec.mixer == SWA else 0
    out = ops.flash_attention(q, k, v, causal=cfg.causal, window=window, cap=cfg.attn_softcap)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


def _mlp_residual(cfg, spec, p, x):
    if spec.mlp == NONE:
        return x
    h = L.mlp(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg.activation)
    if cfg.sandwich_norm:
        h = L.rms_norm(h, p["post_ln2"], cfg.norm_eps)
    return x + h


def _mixer_residual(cfg, x, h, p):
    if cfg.sandwich_norm:
        h = L.rms_norm(h, p["post_ln1"], cfg.norm_eps)
    return x + h


def apply_block(cfg, spec: LayerSpec, p, x, cos, sin) -> torch.Tensor:
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == MAMBA:
        h = MB.mamba_sequence(p, h, cfg)
    else:
        h = _attn_seq(cfg, spec, p, h, cos, sin)
    x = _mixer_residual(cfg, x, h, p)
    return _mlp_residual(cfg, spec, p, x)


# ----------------------------------------------------------------- forward
def _cast_block(cfg, spec: LayerSpec, p, x, cos, sin) -> torch.Tensor:
    """apply_block on compute-dtype casts of ``p`` (no-ops for compute weights)."""
    return apply_block(cfg, spec, _cast_block_params(p, cfg.compute_dtype), x, cos, sin)


def _unstacked(params) -> List[List[Dict[str, torch.Tensor]]]:
    """Each period's weights, ``[period][layout position]``, as views made by
    one ``unbind`` per stacked leaf.  Autograd then stacks each leaf's
    gradient once; indexing the stacked tensor once per period instead
    gives every period a full-size zero gradient to add up (at gemma-2b's
    width 18 × 7.9 GB of fills and adds per step)."""
    per_pos = [{k: v.unbind(0) for k, v in layer.items()} for layer in params["layers"]]
    n_periods = len(next(iter(per_pos[0].values())))
    return [[{k: t[period] for k, t in pos.items()} for pos in per_pos]
            for period in range(n_periods)]


def _period(cfg: ModelConfig, layers: List[Dict[str, torch.Tensor]], x, cos, sin,
            remat: str) -> torch.Tensor:
    for spec, p in zip(cfg.layout, layers):
        if remat == "block" and cfg.period > 1:
            # nested remat, as JAX: a multi-layer period would otherwise hold
            # all its layers' intermediates in the backward working set
            x = checkpoint(_cast_block, cfg, spec, p, x, cos, sin, use_reentrant=False)
        else:
            x = _cast_block(cfg, spec, p, x, cos, sin)
    return x


def _layers(cfg: ModelConfig, params, x: torch.Tensor, ctx: ShardCtx) -> torch.Tensor:
    if ctx.remat not in ("none", "block"):
        raise ValueError(f"remat must be 'none' or 'block', got {ctx.remat!r}")
    B, S, _ = x.shape
    cos, sin = _rope_cos_sin(cfg, _positions(cfg, B, S, device=x.device), cfg.qk_dim)
    for layers in _unstacked(params):
        if ctx.remat == "block":  # each period's activations recomputed in backward
            x = checkpoint(_period, cfg, layers, x, cos, sin, ctx.remat, use_reentrant=False)
        else:
            x = _period(cfg, layers, x, cos, sin, ctx.remat)
    return x


def hidden_states(cfg: ModelConfig, params, batch, ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    return _layers(cfg, params, embed_tokens(cfg, params, batch), ctx)


def forward(cfg: ModelConfig, params, batch, ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    logits = unembed(cfg, params, hidden_states(cfg, params, batch, ctx))
    return logits[..., : cfg.vocab]  # crop padding (API surface only)


def _ce_chunk(cfg: ModelConfig, params, xc: torch.Tensor, lc: torch.Tensor):
    """(Σ masked token loss, Σ mask, Σ hits) of one sequence chunk."""
    logits = unembed(cfg, params, xc)  # over vocab_padded, as JAX (no crop)
    logp = torch.log_softmax(logits, dim=-1)
    mask = (lc >= 0).to(torch.float32)
    # torch.gather refuses the label -1 that JAX's take_along_axis takes:
    # clamp it, and the mask drops it
    tl = -torch.gather(logp, -1, lc.clamp(min=0).long()[..., None])[..., 0]
    hit = ((logits.argmax(-1) == lc) * mask).sum()
    return (tl * mask).sum(), mask.sum(), hit


def loss_and_metrics(cfg: ModelConfig, params, batch, ctx: ShardCtx = ShardCtx(),
                     ce_chunk: int = 1024):
    """Next-token CE with sequence-chunked unembedding, on master weights.

    Full logits of a 256k-vocab model are (B·S·V).  Chunking the
    unembed+CE over the sequence, each chunk under a checkpoint, keeps live
    logits at (B, chunk, V); the backward pass recomputes each chunk's
    logits from the final hidden states.  -> (loss, {"loss", "accuracy",
    "tokens"}), float32 scalars on the weights' device.
    """
    _check_supported(cfg)
    x = _layers(cfg, params, _embed(cfg, params["embed"], batch["tokens"]), ctx)
    B, S, _ = x.shape
    labels = batch["labels"]
    cs = min(ce_chunk, S)
    if S % cs != 0:
        cs = S  # fall back to unchunked
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    lsum, msum, hits = zero, zero, zero
    for c in range(S // cs):
        sl = slice(c * cs, (c + 1) * cs)
        l, m, h = checkpoint(_ce_chunk, cfg, params, x[:, sl], labels[:, sl],
                             use_reentrant=False)
        lsum, msum, hits = lsum + l, msum + m, hits + h
    loss = lsum / torch.clamp(msum, min=1.0)
    return loss, {"loss": loss, "accuracy": hits / torch.clamp(msum, min=1.0), "tokens": msum}


# ------------------------------------------------------------------- cache
def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> Dict[str, Any]:
    """Zeroed decode cache, stacked over periods per layout position;
    ``device=None`` is the port's default device."""
    _check_supported(cfg)
    device = resolve(device)
    NP, dt = cfg.n_periods, cfg.compute_dtype
    per_pos: List[Dict[str, torch.Tensor]] = []
    for spec in cfg.layout:
        if spec.mixer == MAMBA:
            state = MB.init_mamba_state(cfg, batch, dt, device)
            per_pos.append({k: v.new_zeros((NP, *v.shape)) for k, v in state.items()})
            continue
        Sc = min(max_seq, cfg.window) if spec.mixer == SWA else max_seq
        shape = (NP, batch, Sc, cfg.n_kv_heads, cfg.head_dim)
        per_pos.append({
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "kpos": torch.full((NP, Sc), -1, dtype=torch.int32, device=device),
        })
    return {"pos": 0, "layers": per_pos}


def _attn_decode(cfg, spec, p, h, cache, pos: int, cos, sin):
    """One-token attention against the (possibly ring-buffered) cache; the
    new key and value are written into ``cache`` in place."""
    B = h.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v = _qkv(cfg, p, h, cos, sin)
    Sc = cache["k"].shape[1]  # this layer's slice: (B, Sc, KV, hd)
    slot = pos % Sc  # ring for SWA; plain index otherwise (pos < Sc)
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]
    cache["kpos"][slot] = pos
    window = cfg.window if spec.mixer == SWA else 0
    acc, m, l = L.attention_partial(
        q, cache["k"], cache["v"], causal=True, window=window, cap=cfg.attn_softcap,
        scale=1.0 / math.sqrt(hd),
        qpos=torch.full((1, 1), pos, device=h.device), kpos=cache["kpos"][None, :],
    )
    out = acc / l.clamp(min=1e-30)[..., None]  # (B,KV,G,1,hd)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, 1, H * hd).to(h.dtype)
    return out @ p["wo"]


def decode_block(cfg, spec, p, x, cache, pos: int, cos, sin):
    """One layer of a decode step; ``cache`` (this layer's slice) is
    updated in place."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == MAMBA:
        h, _ = MB.mamba_decode(p, h, cache, cfg)
    else:
        h = _attn_decode(cfg, spec, p, h, cache, pos, cos, sin)
    x = _mixer_residual(cfg, x, h, p)
    return _mlp_residual(cfg, spec, p, x)


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                ctx: ShardCtx = ShardCtx()):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache).

    The cache's tensors are updated in place and returned with ``pos``
    advanced; the cache passed in is not to be stepped again.
    """
    pos = int(cache["pos"])
    x = embed_tokens(cfg, params, {"tokens": tokens})
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    cos, sin = _rope_cos_sin(cfg, positions, cfg.qk_dim)
    for period in range(cfg.n_periods):
        for i, spec in enumerate(cfg.layout):
            c = {name: t[period] for name, t in cache["layers"][i].items()}
            x = decode_block(cfg, spec, _layer(params, i, period), x, c, pos, cos, sin)
    logits = unembed(cfg, params, x)
    return logits, {"pos": pos + 1, "layers": cache["layers"]}


def _expand_prefill_cache(cfg: ModelConfig, layer_caches, S: int, max_seq: int):
    """Grow prefill caches to max_seq decode slots, ring-aligned for SWA;
    Mamba states pass through."""
    out = []
    for spec, c in zip(cfg.layout, layer_caches):
        if spec.mixer == MAMBA:
            out.append(c)
            continue
        w = c["k"].shape[2]  # stored length after prefill
        Sc = min(max_seq, cfg.window) if spec.mixer == SWA else max_seq
        if Sc == w:
            if S > w:  # ring-align: position p must live in slot p % w
                sh = S % w
                c = {
                    "k": torch.roll(c["k"], sh, dims=2),
                    "v": torch.roll(c["v"], sh, dims=2),
                    "kpos": torch.roll(c["kpos"], sh, dims=1),
                }
        else:
            assert Sc > w, (Sc, w)
            NP, B, _, KV, hd = c["k"].shape
            off = S - w  # slots == positions (no wrap: S <= Sc here)
            k = c["k"].new_zeros((NP, B, Sc, KV, hd))
            v = c["v"].new_zeros((NP, B, Sc, KV, hd))
            kpos = torch.full((NP, Sc), -1, dtype=torch.int32, device=c["kpos"].device)
            k[:, :, off:off + w] = c["k"]
            v[:, :, off:off + w] = c["v"]
            kpos[:, off:off + w] = c["kpos"]
            c = {"k": k, "v": v, "kpos": kpos}
        out.append(c)
    return out


def prefill(cfg: ModelConfig, params, batch, ctx: ShardCtx = ShardCtx(),
            max_seq: Optional[int] = None):
    """Sequence pass returning (last-position logits, populated cache).

    A Mamba layer runs ``mamba.mamba_prefill``: one scan-kernel launch
    gives its output and its decode state, where JAX computes the state in
    a second pass (``_mamba_prefill_state``)."""
    x = embed_tokens(cfg, params, batch)
    B, S, _ = x.shape
    cos, sin = _rope_cos_sin(cfg, _positions(cfg, B, S, device=x.device), cfg.qk_dim)
    per_pos: List[Dict[str, List[torch.Tensor]]] = [{} for _ in cfg.layout]
    for period in range(cfg.n_periods):
        for i, spec in enumerate(cfg.layout):
            p = _layer(params, i, period)
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            if spec.mixer == MAMBA:
                h, cch = MB.mamba_prefill(p, h, cfg)
            else:
                h, (k, v) = _attn_seq_with_cache(cfg, spec, p, h, cos, sin)
                if spec.mixer == SWA:
                    w = min(cfg.window, S)
                    k, v = k[:, -w:], v[:, -w:]
                    kpos = torch.arange(S - w, S, dtype=torch.int32, device=x.device)
                else:
                    kpos = torch.arange(S, dtype=torch.int32, device=x.device)
                cch = {"k": k, "v": v, "kpos": kpos}
            x = _mixer_residual(cfg, x, h, p)
            x = _mlp_residual(cfg, spec, p, x)
            for name, t in cch.items():
                per_pos[i].setdefault(name, []).append(t)
    layer_caches = [{name: torch.stack(ts) for name, ts in c.items()} for c in per_pos]
    logits = unembed(cfg, params, x[:, -1:])
    if max_seq is not None and max_seq != S:
        layer_caches = _expand_prefill_cache(cfg, layer_caches, S, max_seq)
    return logits, {"pos": S, "layers": layer_caches}
