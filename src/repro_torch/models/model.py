"""The model (port of ``repro.models.model``): forward, loss, prefill, decode.

Modes:
  forward / loss_and_metrics
               full-sequence pass (attention through ``layers.attention``,
               Mamba through ``mamba.mamba_sequence``); the training path
  prefill      sequence pass that also builds the decode cache; its
               attention (MLA's too, v head dim and all) runs the
               hand-written flash kernel and its Mamba layers the
               hand-written scan kernel (``kernels.ops``)
  decode_step  single-token step against the cache (MLA: absorbed-matrix
               attention on the compressed latent cache)

Every mixer (FULL, SWA, MLA with or without a query latent, MAMBA), the
dense and MoE MLPs (or none; MoE with shared experts), RoPE (YaRN-scaled
where configured) and M-RoPE positions, the text, audio-stub and vision-stub
embeddings, ``sandwich_norm``, ``emb_scale`` and both softcaps.

Differences of form, not of values, from the JAX package:
  * ``lax.scan`` over periods is a Python loop over layers; parameters and
    caches keep JAX's layout, stacked over periods per layout position.
  * The cache is updated in place (JAX donates it instead), and its ``pos``
    is a host int, so a decode step never waits on the device for it; or,
    on one device, a 0-d integer tensor on the cache's device, which a
    decode step reads there (the CUDA graph of ``launch.steps``: one graph
    serves every position).
  * forward, prefill and decode_step take weights already in the compute
    dtype: cast the float32 master weights once with :func:`compute_params`
    (see there), where JAX casts them inside every call.  The training
    path, :func:`loss_and_metrics`, takes the master weights and casts them
    where JAX does (in each block, in the embedding lookup and in each
    cross-entropy chunk's unembedding), so autograd carries float32
    gradients back to them.
  * ``jax.checkpoint`` is ``torch.utils.checkpoint`` (non-reentrant).

On a mesh (:class:`ShardCtx`) :func:`loss_and_metrics` also takes the
placed train state of ``launch.sharding.place``: DTensor leaves, each
gathered where it is used (:func:`collectives.gathered`) and its gradient
reduced back to its placement by the gather's backward.  :func:`prefill`
and :func:`decode_step` take placed compute weights alike
(``launch.sharding.placed_compute_params``), gathered one layer at a time,
and a batch leaf placed by ``launch.sharding.batch_shardings`` (a DTensor)
is taken as the rank's rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from ..device import resolve
from ..kernels import ops
from ..telemetry.selftrace import get_self_tracer
from . import collectives as C
from . import layers as L
from . import mamba as MB
from .common import MAMBA, MLA, MOE, NONE, SWA, LayerSpec, ModelConfig
from .moe import EXPERT_KEYS, EPInfo, moe_block, shared_experts

# spans model/prefill, model/decode_step, mla/prefill, moe/shared and the decode mixers
_TRACER = get_self_tracer()


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """How the current step is distributed (None mesh = one device).

    On a mesh the port runs SPMD by hand, as JAX's ``shard_map`` bodies do:
    every rank calls the same entry point with the same global batch and
    computes only its own blocks.  The hidden state is (B/dp, S/tp, D)
    where ``seq_shard`` holds for the pass (:func:`_use_seq_parallel`), else
    (B/dp, S, D), the sequence replicated over the model axis; parameters
    are replicated except the expert leaves, of which rank r of the model
    axis holds experts [r·E/tp, (r+1)·E/tp) where :meth:`ep_info` applies
    (:func:`local_params`), or placed and gathered at use; the caches are
    split by ``launch.sharding.cache_pspec``'s rule (batch over the batch
    axes; the attention caches' sequence and Mamba's d_inner channels over
    the model axis, the decode step then running Mamba tensor-parallel:
    :func:`mamba.mamba_decode_tp`).  The collectives are
    ``torch.distributed`` calls on the mesh's groups
    (``mesh.get_group(name)``): an all-gather into a list and
    all-reduces (sum, max), which gloo and NCCL both take.  Where a
    gradient is taken the gather and the sum carry autograd
    (:mod:`collectives`: their backwards are a reduce-scatter and an
    all-reduce), so the loss's gradient passes through every body.  JAX's
    head-sharding constraints are placements and change no value, so they
    have no counterpart.

    ``mesh`` is a ``DeviceMesh`` (``compat.make_mesh``) with dims named
    ``batch_axes`` and ``model_axis``.  ``unroll`` is JAX's probe mode (the
    dry run's cost probe): single-block attention and whole-sequence Mamba
    chunks.  ``plain`` sends prefill's attention and scan through their
    plain versions (``layers.attention`` and the chunked scan, as the
    training path runs them) instead of the kernels: the dry run's meta
    tensors, which no kernel takes.  A probe is plain too.
    """

    mesh: Optional[Any] = None
    batch_axes: Tuple[str, ...] = ()
    model_axis: Optional[str] = "model"
    batch_shardable: bool = True  # False for global_batch=1 cells
    seq_shard: bool = False  # sequence-parallel activations
    remat: str = "none"  # none | block
    unroll: bool = False
    plain: bool = False

    @property
    def kernels(self) -> bool:
        """Whether prefill launches the kernels (through ``kernels.ops``)."""
        return not (self.unroll or self.plain)

    def direct_threshold(self) -> int:
        """``layers.attention``'s switch to the chunked path: never in a probe."""
        return (1 << 30) if self.unroll else 1024

    def mamba_chunk(self, S: int) -> int:
        return S if self.unroll else 128

    # ---------------------------------------------------------- the mesh
    def _size(self, axis: str) -> int:
        return self.mesh.shape[tuple(self.mesh.mesh_dim_names).index(axis)]

    @property
    def tp(self) -> int:
        """Size of the model axis (1 without a mesh)."""
        if self.mesh is None or self.model_axis not in _dim_names(self.mesh):
            return 1
        return self._size(self.model_axis)

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on the model axis (0 without a mesh)."""
        if self.mesh is None or self.model_axis not in _dim_names(self.mesh):
            return 0
        return self.mesh.get_local_rank(self.model_axis)

    @property
    def model_dim(self) -> int:
        """The model axis's index among the mesh's dims."""
        return _dim_names(self.mesh).index(self.model_axis)

    @property
    def dp(self) -> int:
        return math.prod(self._size(a) for a in self.batch_axes) if self.mesh is not None else 1

    def hidden_spec(self) -> Tuple:
        """JAX's ``hidden_spec``: (batch, sequence, model) as a spec tuple."""
        b = self.batch_axes if self.batch_shardable else None
        return (b, self.model_axis if self.seq_shard else None, None)

    def ep_info(self, cfg: ModelConfig) -> Optional[EPInfo]:
        if self.mesh is None or self.model_axis is None:
            return None
        n = self._size(self.model_axis)
        if cfg.moe_experts % n != 0:
            return None
        return EPInfo(axis=self.model_axis, n_shards=n, mesh=self.mesh)

    @property
    def batch_split(self) -> bool:
        """Whether the batch is split over the batch axes."""
        return self.dp > 1 and self.batch_shardable

    def batch_rows(self, B: int) -> slice:
        """This rank's rows of a global batch of B: row-major over the batch
        axes where the batch is split."""
        if not self.batch_split:
            return slice(None)
        i = 0
        for a in self.batch_axes:
            i = i * self._size(a) + self.mesh.get_local_rank(a)
        return slice(i * B // self.dp, (i + 1) * B // self.dp)

    @property
    def replicas(self) -> int:
        """How many ranks compute each of this pass's tokens: the model
        axis where the sequence is replicated over it, times the batch axes
        where the batch is."""
        return (1 if self.seq_shard else self.tp) * (1 if self.batch_split else self.dp)

    def token_dims(self) -> Tuple[str, ...]:
        """The mesh dims over which the ranks hold different tokens."""
        return (self.batch_axes if self.batch_split else ()) + \
            ((self.model_axis,) if self.seq_shard else ())

    def for_pass(self, B: int, S: int) -> "ShardCtx":
        """The context of one pass over a global (B, S) batch, its layout
        resolved: ``batch_shardable`` to whether the batch axes split B,
        ``seq_shard`` to whether the hidden state is sequence-sharded
        (:func:`_use_seq_parallel`).  Blocks see only their local rows and
        cannot tell either."""
        return dataclasses.replace(self, batch_shardable=self.batch_shardable and B % self.dp == 0,
                                   seq_shard=_use_seq_parallel(self, S))

    # ------------------------------------------------- model-axis collectives
    def all_gather(self, t: torch.Tensor, axis: Optional[str] = None) -> List[torch.Tensor]:
        """Every rank's ``t`` along ``axis`` (default the model axis), in
        rank order; with autograd where a gradient is taken."""
        return C.all_gather(t, self.mesh.get_group(axis or self.model_axis))

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the model axis: in place, or with autograd where a
        gradient is taken."""
        return C.all_reduce(t, self.mesh.get_group(self.model_axis))

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Max over the model axis, in place, without a gradient: the
        merge it stabilises (:func:`merge_partials`) does not depend on it."""
        t = t.detach()
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.mesh.get_group(self.model_axis))
        return t


def _dim_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _use_seq_parallel(ctx: ShardCtx, S: int) -> bool:
    return (
        ctx.seq_shard
        and ctx.mesh is not None
        and ctx.model_axis in _dim_names(ctx.mesh)
        and S % ctx.tp == 0
        and S >= ctx.tp * 16
    )


def _seq_sharded(ctx: ShardCtx, Sc: int) -> bool:
    """Does the model axis split a cache dim of Sc entries (an attention
    cache's slots, Mamba's d_inner channels)?  ``cache_pspec``'s rule."""
    return (
        ctx.mesh is not None
        and ctx.model_axis in _dim_names(ctx.mesh)
        and Sc % ctx.tp == 0
        and Sc >= ctx.tp
    )


def _state_split(cfg: ModelConfig, ctx: ShardCtx) -> bool:
    """Is Mamba's decode state split over d_inner across more than one
    model rank (the tensor-parallel decode)?"""
    return ctx.mesh is not None and ctx.tp > 1 and _seq_sharded(ctx, cfg.d_inner)


def _rank_rows(ctx: ShardCtx, name: str, v: torch.Tensor, B: int) -> torch.Tensor:
    """The rank's rows of a batch leaf of global batch B: a leaf placed by
    ``batch_shardings`` (a DTensor) holds them as its local block; else
    they are cut from the global batch (``pos3`` on its axis 1)."""
    if isinstance(v, DTensor):
        return v.to_local()
    rows = ctx.batch_rows(B)
    return v[:, rows] if name == "pos3" else v[rows]


def _gathered_top(params) -> Dict[str, torch.Tensor]:
    """The embedding, final norm and unembedding: placed leaves gathered
    whole, compute weights as given."""
    return {k: C.gathered(v) for k, v in params.items() if k != "layers"}


def local_params(cfg: ModelConfig, params, ctx: ShardCtx) -> Dict[str, Any]:
    """This rank's parameters on ``ctx``'s mesh: the expert leaves cut to
    the rank's experts where ``ctx.ep_info`` applies (views), the rest as
    given."""
    ep = ctx.ep_info(cfg)
    if ep is None or not any(s.mlp == MOE for s in cfg.layout):
        return params
    e_loc = cfg.moe_experts // ep.n_shards
    lo = ctx.model_rank * e_loc
    layers = [{k: (v[:, lo:lo + e_loc] if k in EXPERT_KEYS else v) for k, v in layer.items()}
              for layer in params["layers"]]
    return {**params, "layers": layers}


# ---------------------------------------------------------------- embedding
def embed_tokens(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    _check_compute(cfg, params)
    return _embed(cfg, C.gathered(params["embed"]), batch)


def _check_compute(cfg: ModelConfig, params) -> None:
    if params["embed"].dtype != cfg.compute_dtype:
        raise ValueError(f"weights are {params['embed'].dtype}, the config computes in "
                         f"{cfg.compute_dtype}: pass compute_params(cfg, params)")


def _embed(cfg: ModelConfig, table: torch.Tensor, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The batch's input rows in the compute dtype, scaled as gemma scales
    them: the audio stub's ``embeds``, else rows of ``table`` (cast: a no-op
    for compute weights) whose first ``n_vis`` the vision stub replaces
    with ``visual_embeds``."""
    if cfg.modality == "audio_stub":
        x = batch["embeds"].to(cfg.compute_dtype)
    else:
        x = F.embedding(batch["tokens"], table).to(cfg.compute_dtype)
        if cfg.modality == "vision_stub" and "visual_embeds" in batch:
            vis = batch["visual_embeds"].to(cfg.compute_dtype)
            x = torch.cat([vis, x[:, vis.shape[1]:]], dim=1)
    if cfg.emb_scale:
        # The scale is rounded to the compute dtype before the multiply, as
        # in JAX: in bf16, sqrt(2048) = 45.2548 becomes 45.25.
        x = x * L.rounded(math.sqrt(cfg.d_model), cfg.compute_dtype)
    return x


def _positions(cfg: ModelConfig, batch, B: int, S: int, offset: int = 0,
               device=None) -> torch.Tensor:
    """(B, S) positions, or M-RoPE's (3, B, S): the batch's ``pos3`` where
    it has one, else t = h = w."""
    if cfg.pos == "mrope":
        if "pos3" in batch:
            return batch["pos3"]
        return L.mrope_text_positions(B, S, offset, device=device)
    return L.text_positions(B, S, offset, device=device)


def _rope_cos_sin(cfg: ModelConfig, positions: torch.Tensor):
    """The RoPE table (M-RoPE's, YaRN's or plain) over the qk dim, or over
    MLA's rope half where it has frequencies of its own (``mla_rope_freqs``)."""
    dim = cfg.qk_rope_dim if cfg.mla_rope_freqs == "rope" else cfg.qk_dim
    if cfg.pos == "mrope":
        return L.mrope_cos_sin(positions, dim, cfg.mrope_sections, cfg.rope_theta)
    if cfg.pos == "none":
        return None, None
    if cfg.yarn_factor:
        return L.yarn_cos_sin(positions, dim, cfg.rope_theta, cfg.yarn_factor,
                              cfg.yarn_original_max_pos)
    return L.rope_cos_sin(positions, dim, cfg.rope_theta)


def unembed(cfg: ModelConfig, params, x: torch.Tensor) -> torch.Tensor:
    """-> float32 logits over the padded vocab, padding columns at -1e30."""
    params = _gathered_top(params)
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
    change it).  A placed tree's leaves are cast block by block.
    """
    out = {k: compute_leaf(cfg, k, v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: compute_leaf(cfg, k, v) for k, v in p.items()} for p in params["layers"]]
    return out


def compute_leaf(cfg: ModelConfig, key: str, t: torch.Tensor) -> torch.Tensor:
    """One leaf (named ``key``) as :func:`compute_params` casts it."""
    return t if key in _F32_KEYS or key == "final_ln" else t.to(cfg.compute_dtype)


def _serving_layers(cfg: ModelConfig, params, ctx: ShardCtx):
    """(period, layout position, spec, weights) of every layer in order,
    as prefill and decode compute with them: a placed layer's leaves
    gathered when its turn comes (:func:`_block_params`), so one layer's
    whole weights are live at a time; compute weights as given."""
    for period, layers in enumerate(_unstacked(params)):
        for i, (spec, p) in enumerate(zip(cfg.layout, layers)):
            if any(isinstance(v, DTensor) for v in p.values()):
                p = _block_params(cfg, spec, p, ctx)
            yield period, i, spec, p


def _qkv(cfg, p, h, cos, sin):
    B, S, _ = h.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (h @ p["wq"]).reshape(B, S, H, hd)
    k = (h @ p["wk"]).reshape(B, S, KV, hd)
    v = (h @ p["wv"]).reshape(B, S, KV, hd)
    if cos is not None:
        q, k = L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin)
    return q, k, v


def _chunk(n: int, c: int) -> int:
    """``attention_chunked``'s block along a length n: min(c, n), or where
    that does not divide n (JAX asserts there) the largest power-of-two
    divisor of n below c: 512 keys at gemma2-2b's 4608-token prompt."""
    b = min(c, n)
    return b if n % b == 0 else math.gcd(n, c)


def seq_attention_local(q, k_blocks, v_blocks, rank: int, *, causal, window, cap, scale=None,
                        unroll: bool = False):
    """One rank's context-parallel attention: its query block (B, S/tp, H,
    hd) against every rank's K and V blocks, in rank order, with the global
    query offset rank·S/tp.  -> (out, K, V) with K and V whole.  Plain
    chunked attention, as JAX's body (the flash kernel has no query offset)."""
    S_loc = q.shape[1]
    k, v = torch.cat(k_blocks, dim=1), torch.cat(v_blocks, dim=1)
    S = k.shape[1]
    # probe mode: single-block chunks, as JAX's
    cq, ck = (S_loc, S) if unroll else (_chunk(S_loc, 512), _chunk(S, 1024))
    out = L.attention_chunked(q, k, v, causal=causal, window=window, cap=cap, scale=scale,
                              q_offset=rank * S_loc, chunk_q=cq, chunk_k=ck)
    return out, k, v


def _attention_seq_parallel(q, k, v, ctx: ShardCtx, *, causal, window, cap, scale=None):
    """Context-parallel attention (JAX ``model.py:128``): the queries stay
    sequence-sharded over the model axis, K and V are all-gathered, and
    each rank computes its causal slice with a global query offset.
    -> (out, K, V), K and V gathered whole (prefill caches them)."""
    return seq_attention_local(q, ctx.all_gather(k), ctx.all_gather(v), ctx.model_rank,
                               causal=causal, window=window, cap=cap, scale=scale,
                               unroll=ctx.unroll)


def _attn_seq(cfg, spec, p, h, cos, sin, ctx: ShardCtx) -> torch.Tensor:
    B, S, _ = h.shape
    q, k, v = _qkv(cfg, p, h, cos, sin)
    window = cfg.window if spec.mixer == SWA else 0
    if ctx.seq_shard:
        out, _, _ = _attention_seq_parallel(q, k, v, ctx, causal=cfg.causal, window=window,
                                            cap=cfg.attn_softcap)
    else:
        out = L.attention(q, k, v, causal=cfg.causal, window=window, cap=cfg.attn_softcap,
                          direct_threshold=ctx.direct_threshold())
    return out.reshape(B, S, -1) @ p["wo"]


def _prefill_attention(ctx: ShardCtx, q, k, v, **kw):
    """Prefill's attention -> (out, K, V): sequence-parallel where the
    hidden state is sequence-sharded (K and V gathered whole); else the
    flash kernel (its plain version for CPU tensors), or with ``ctx.plain``
    or ``ctx.unroll`` ``layers.attention``."""
    if ctx.seq_shard:
        return _attention_seq_parallel(q, k, v, ctx, **kw)
    if ctx.kernels:
        return ops.flash_attention(q, k, v, **kw), k, v
    return L.attention(q, k, v, direct_threshold=ctx.direct_threshold(), **kw), k, v


def _attn_seq_with_cache(cfg, spec, p, h, cos, sin, ctx: ShardCtx):
    """Prefill: returns (attn_out, (k_full, v_full)), K and V over the
    whole sequence."""
    B, S, _ = h.shape
    q, k, v = _qkv(cfg, p, h, cos, sin)
    window = cfg.window if spec.mixer == SWA else 0
    out, k, v = _prefill_attention(ctx, q, k, v, causal=cfg.causal, window=window,
                                   cap=cfg.attn_softcap)
    return out.reshape(B, S, -1) @ p["wo"], (k, v)


def _mla_project(cfg, p, h, cos, sin):
    """MLA's per-head queries, split into q_nope (B,S,H,nope) and the
    rotated q_rope (B,S,H,rope), the normed latent ckv (B,S,kv_lora_rank)
    and the rotated rope key k_rope (B,S,1,rope), shared by every head.
    The queries come through the normed query latent, or straight from
    ``wq`` where ``q_lora_rank`` is 0.  The rope halves take the first
    rope/2 columns of cos/sin: with ``mla_rope_freqs`` "qk" a table built
    for the qk dim, as JAX does (the frequencies of a qk-dim-wide RoPE),
    with "rope" the whole of a rope-dim table."""
    B, S, _ = h.shape
    H, kvr = cfg.n_heads, cfg.kv_lora_rank
    nope, rope = cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = L.rms_norm(h @ p["wdq"], p["q_ln"], cfg.norm_eps) @ p["wuq"]
    else:
        q = h @ p["wq"]
    q = q.reshape(B, S, H, nope + rope)
    q_nope, q_rope = q[..., :nope], q[..., nope:]
    dkv = h @ p["wdkv"]  # (B,S,kvr+rope)
    ckv = L.rms_norm(dkv[..., :kvr], p["kv_ln"], cfg.norm_eps)
    k_rope = dkv[..., kvr:].reshape(B, S, 1, rope)
    if cos is not None:
        cr, sr = cos[..., : rope // 2], sin[..., : rope // 2]
        q_rope, k_rope = L.apply_rope(q_rope, cr, sr), L.apply_rope(k_rope, cr, sr)
    return q_nope, q_rope, ckv, k_rope


def _mla_qkv(cfg, p, h, cos, sin):
    """MLA's q, k (B,S,H,nope+rope) and v (B,S,H,v_head_dim) for sequence
    attention, and the latent cache's ckv and k_rope."""
    B, S, _ = h.shape
    H = cfg.n_heads
    q_nope, q_rope, ckv, k_rope = _mla_project(cfg, p, h, cos, sin)
    k_nope = (ckv @ p["wuk"]).reshape(B, S, H, cfg.qk_nope_dim)
    v = (ckv @ p["wuv"]).reshape(B, S, H, cfg.v_head_dim)
    k = torch.cat([k_nope, k_rope.expand(B, S, H, cfg.qk_rope_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    return q, k, v, ckv, k_rope


def _mla_scale(cfg) -> float:
    """1/sqrt(nope + rope), times YaRN's mscale(mscale_all_dim)² where the
    configuration sets both (DeepSeek-V2's ``softmax_scale``)."""
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        scale *= L.yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim) ** 2
    return scale


def _mla_seq(cfg, p, h, cos, sin, ctx: ShardCtx) -> torch.Tensor:
    B, S, _ = h.shape
    q, k, v, _, _ = _mla_qkv(cfg, p, h, cos, sin)
    kw = dict(causal=cfg.causal, window=0, cap=cfg.attn_softcap, scale=_mla_scale(cfg))
    if ctx.seq_shard:
        out, _, _ = _attention_seq_parallel(q, k, v, ctx, **kw)
    else:
        out = L.attention(q, k, v, direct_threshold=ctx.direct_threshold(), **kw)
    return out.reshape(B, S, -1) @ p["wo"]


def _mla_seq_with_cache(cfg, p, h, cos, sin, ctx: ShardCtx):
    """Prefill: returns (attn_out, (ckv, k_rope)), the latent cache over the
    whole sequence (gathered where the hidden state is sequence-sharded);
    the flash kernel pads v's head dim with q's.  Span ``mla/prefill``."""
    with _TRACER.span("mla/prefill"):
        B, S, _ = h.shape
        q, k, v, ckv, k_rope = _mla_qkv(cfg, p, h, cos, sin)
        out, _, _ = _prefill_attention(ctx, q, k, v, causal=cfg.causal, window=0,
                                       cap=cfg.attn_softcap, scale=_mla_scale(cfg))
        k_rope = k_rope[:, :, 0]
        if ctx.seq_shard:
            ckv, k_rope = (torch.cat(ctx.all_gather(t), dim=1) for t in (ckv, k_rope))
        return out.reshape(B, S, -1) @ p["wo"], (ckv, k_rope)


def _gather_global(ctx: ShardCtx, h: torch.Tensor, batch: bool) -> torch.Tensor:
    """The whole of a block-split (B, S, D) tensor on every rank: the
    sequence gathered over the model axis where it is sharded, and with
    ``batch`` the rows over the batch axes, innermost first."""
    if ctx.seq_shard:
        h = torch.cat(ctx.all_gather(h), dim=1)
    if batch and ctx.batch_split:
        for a in reversed(ctx.batch_axes):
            h = torch.cat(ctx.all_gather(h, a), dim=0)
    return h


def _mlp_apply(cfg, spec, p, h, ctx: ShardCtx = ShardCtx()):
    if spec.mlp != MOE:
        return L.mlp(p, h, cfg.activation)
    out = _routed(cfg, p, h, ctx)
    if cfg.shared_dff:  # on every token, outside the routed layer's all-reduce
        with _TRACER.span("moe/shared"):
            out = out + shared_experts(p, h, cfg)
    return out


def _routed(cfg, p, h, ctx: ShardCtx):
    """The routed experts' output for the rank's block ``h``."""
    if ctx.mesh is None:
        return moe_block(p, h, cfg)
    # On a mesh JAX routes the tokens of its shard_map block (sequence
    # whole, batch split) with ``ep``, else the global batch (XLA keeps
    # moe_block's global semantics): the capacity comes from that N, so the
    # port gathers the same tokens, routes them alike, and keeps its block.
    ep = ctx.ep_info(cfg)
    full = _gather_global(ctx, h, batch=ep is None)
    out = moe_block(p, full, cfg, ep)
    if ep is None:
        out = out[ctx.batch_rows(out.shape[0])]
    if ctx.seq_shard:
        S_loc = h.shape[1]
        out = out[:, ctx.model_rank * S_loc:(ctx.model_rank + 1) * S_loc]
    return out


def _mlp_residual(cfg, spec, p, x, ctx: ShardCtx = ShardCtx()):
    if spec.mlp == NONE:
        return x
    h = _mlp_apply(cfg, spec, p, L.rms_norm(x, p["ln2"], cfg.norm_eps), ctx)
    if cfg.sandwich_norm:
        h = L.rms_norm(h, p["post_ln2"], cfg.norm_eps)
    return x + h


def _mixer_residual(cfg, x, h, p):
    if cfg.sandwich_norm:
        h = L.rms_norm(h, p["post_ln1"], cfg.norm_eps)
    return x + h


def _mamba_seq(p, h, cfg, ctx: ShardCtx) -> torch.Tensor:
    if ctx.seq_shard:
        return MB.mamba_mixer_seq_parallel(p, h, cfg, ctx, chunk=ctx.mamba_chunk(h.shape[1]))
    return MB.mamba_sequence(p, h, cfg, chunk=ctx.mamba_chunk(h.shape[1]))


def apply_block(cfg, spec: LayerSpec, p, x, cos, sin, ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == MAMBA:
        h = _mamba_seq(p, h, cfg, ctx)
    elif spec.mixer == MLA:
        h = _mla_seq(cfg, p, h, cos, sin, ctx)
    else:
        h = _attn_seq(cfg, spec, p, h, cos, sin, ctx)
    x = _mixer_residual(cfg, x, h, p)
    return _mlp_residual(cfg, spec, p, x, ctx)


# ----------------------------------------------------------------- forward
def _block_params(cfg, spec: LayerSpec, p, ctx: ShardCtx) -> Dict[str, torch.Tensor]:
    """The block's weights as it computes with them: compute-dtype casts
    (no-ops for compute weights), and a placed leaf gathered whole after
    its cast, the expert leaves under expert parallelism to the rank's
    experts (:func:`collectives.gathered`)."""
    keep = ctx.model_dim if spec.mlp == MOE and ctx.ep_info(cfg) is not None else None
    return {k: C.gathered(v, keep if k in EXPERT_KEYS else None,
                          None if k in _F32_KEYS else cfg.compute_dtype) for k, v in p.items()}


def _cast_block(cfg, spec: LayerSpec, p, x, cos, sin, ctx: ShardCtx) -> torch.Tensor:
    """apply_block on :func:`_block_params`: inside the block's checkpoint,
    so the recompute gathers again and one layer's weights are live."""
    return apply_block(cfg, spec, _block_params(cfg, spec, p, ctx), x, cos, sin, ctx)


def _unstacked(params) -> List[List[Dict[str, torch.Tensor]]]:
    """Each period's weights, ``[period][layout position]``, as views made by
    one ``unbind`` per stacked leaf.  Autograd then stacks each leaf's
    gradient once; indexing the stacked tensor once per period instead
    gives every period a full-size zero gradient to add up (at gemma-2b's
    width 18 × 7.9 GB of fills and adds per step).  A placed leaf unbinds
    its local block (:func:`collectives.unbind`)."""
    per_pos = [{k: C.unbind(v) for k, v in layer.items()} for layer in params["layers"]]
    n_periods = len(next(iter(per_pos[0].values())))
    return [[{k: t[period] for k, t in pos.items()} for pos in per_pos]
            for period in range(n_periods)]


def _period(cfg: ModelConfig, layers: List[Dict[str, torch.Tensor]], x, cos, sin,
            ctx: ShardCtx) -> torch.Tensor:
    for spec, p in zip(cfg.layout, layers):
        if ctx.remat == "block" and cfg.period > 1:
            # nested remat, as JAX: a multi-layer period would otherwise hold
            # all its layers' intermediates in the backward working set
            x = checkpoint(_cast_block, cfg, spec, p, x, cos, sin, ctx, use_reentrant=False)
        else:
            x = _cast_block(cfg, spec, p, x, cos, sin, ctx)
    return x


def _inputs(cfg: ModelConfig, table: torch.Tensor, batch, ctx: ShardCtx):
    """-> (x, cos, sin, ctx): the embedded input, its RoPE cos/sin and the
    pass's context (:meth:`ShardCtx.for_pass`).  On a mesh, the rank's
    block: its batch rows and, sequence-sharded, its S/tp positions from
    the global offset rank·S/tp (``pos3`` sliced alike)."""
    lead = batch["embeds"] if cfg.modality == "audio_stub" else batch["tokens"]
    B, S = lead.shape[:2]
    ctx = ctx.for_pass(B, S)
    off, S_loc = 0, S
    if ctx.mesh is not None:
        batch = {k: _rank_rows(ctx, k, v, B) for k, v in batch.items()}
        if ctx.seq_shard:
            S_loc = S // ctx.tp
            off = ctx.model_rank * S_loc
            if "pos3" in batch:
                batch["pos3"] = batch["pos3"][:, :, off:off + S_loc]
    x = _embed(cfg, table, batch)[:, off:off + S_loc]
    positions = _positions(cfg, batch, x.shape[0], S_loc, off, device=x.device)
    cos, sin = _rope_cos_sin(cfg, positions)
    return x, cos, sin, ctx


def _layers(cfg: ModelConfig, params, x: torch.Tensor, cos, sin, ctx: ShardCtx) -> torch.Tensor:
    if ctx.remat not in ("none", "block"):
        raise ValueError(f"remat must be 'none' or 'block', got {ctx.remat!r}")
    for layers in _unstacked(params):
        if ctx.remat == "block":  # each period's activations recomputed in backward
            x = checkpoint(_period, cfg, layers, x, cos, sin, ctx, use_reentrant=False)
        else:
            x = _period(cfg, layers, x, cos, sin, ctx)
    return x


def hidden_states(cfg: ModelConfig, params, batch, ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """The final hidden states; on a mesh the rank's block of them."""
    _check_compute(cfg, params)
    x, cos, sin, ctx = _inputs(cfg, params["embed"], batch, ctx)
    return _layers(cfg, params, x, cos, sin, ctx)


def forward(cfg: ModelConfig, params, batch, ctx: ShardCtx = ShardCtx()) -> torch.Tensor:
    """Logits over the vocab; on a mesh the rank's block of them."""
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

    On a mesh every rank passes the global batch and computes its block of
    tokens (:func:`_inputs`); the embedding, the final norm and the
    unembedding are gathered once, outside the chunks.  The metrics are
    JAX's global ones: the sums over the ranks that hold different tokens
    (``ShardCtx.token_dims``), divided as JAX divides them.  The returned
    loss has that value, and the gradient of the rank's share: its masked
    CE sum over the global mask count, divided by the ranks that compute
    the same tokens (``ShardCtx.replicas``).  The shares add up to the
    loss over the ranks, so each leaf's gradient is the sum of the ranks'
    (the gathers' backwards reduce it to the leaf's placement).
    """
    # a placed leaf is gathered in the compute dtype where that is wider:
    # the embedding lookup and the unembedding compute in it either way
    top = {k: C.gathered(v, dtype=torch.promote_types(v.dtype, cfg.compute_dtype)
                         if isinstance(v, DTensor) else None)
           for k, v in params.items() if k != "layers"}
    x, cos, sin, ctx = _inputs(cfg, top["embed"], batch, ctx)
    x = _layers(cfg, params, x, cos, sin, ctx)
    B, S, _ = x.shape
    labels = _local_labels(ctx, batch["labels"])
    cs = min(ce_chunk, S)
    if S % cs != 0:
        cs = S  # fall back to unchunked
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    lsum, msum, hits = zero, zero, zero
    for c in range(S // cs):
        sl = slice(c * cs, (c + 1) * cs)
        l, m, h = checkpoint(_ce_chunk, cfg, top, x[:, sl], labels[:, sl],
                             use_reentrant=False)
        lsum, msum, hits = lsum + l, msum + m, hits + h
    if ctx.mesh is not None:
        return _meshed_loss(ctx, lsum, msum, hits)
    loss = lsum / torch.clamp(msum, min=1.0)
    return loss, {"loss": loss, "accuracy": hits / torch.clamp(msum, min=1.0), "tokens": msum}


def _local_labels(ctx: ShardCtx, labels: torch.Tensor) -> torch.Tensor:
    """The labels of the rank's tokens, cut as :func:`_inputs` cuts the batch."""
    if ctx.mesh is None:
        return labels
    labels = _rank_rows(ctx, "labels", labels, labels.shape[0])
    if ctx.seq_shard:
        n = labels.shape[1] // ctx.tp
        labels = labels[:, ctx.model_rank * n:(ctx.model_rank + 1) * n]
    return labels


def _meshed_loss(ctx: ShardCtx, lsum, msum, hits):
    """The rank's local sums -> (loss, metrics) as :func:`loss_and_metrics`
    returns them on a mesh."""
    sums = torch.stack([lsum, msum, hits]).detach()
    for axis in ctx.token_dims():
        dist.all_reduce(sums, group=ctx.mesh.get_group(axis))
    lsum_g, msum_g, hits_g = sums.unbind(0)
    denom = torch.clamp(msum_g, min=1.0)
    share = lsum / denom / ctx.replicas
    loss = lsum_g / denom
    return loss + (share - share.detach()), {"loss": loss, "accuracy": hits_g / denom,
                                             "tokens": msum_g}


# ------------------------------------------------------------------- cache
def _cache_len(cfg: ModelConfig, spec: LayerSpec, max_seq: int) -> int:
    """A layer's cache slots: the window for SWA, else max_seq."""
    return min(max_seq, cfg.window) if spec.mixer == SWA else max_seq


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device=None,
               ctx: ShardCtx = ShardCtx()) -> Dict[str, Any]:
    """Zeroed decode cache, stacked over periods per layout position;
    ``device=None`` is the port's default device.  On a mesh only the
    rank's blocks of a global batch of ``batch`` (:func:`_cache_block`'s
    rule: Mamba's h and conv cut to the rank's d_inner channels too), and
    ``max_seq``, which decode reads."""
    device = resolve(device)
    if ctx.mesh is not None:
        batch = len(range(batch)[ctx.for_pass(batch, 0).batch_rows(batch)])

    def slots(n: int) -> int:  # the rank's share of n sequence slots
        return n // ctx.tp if _seq_sharded(ctx, n) else n

    NP, dt = cfg.n_periods, cfg.compute_dtype
    per_pos: List[Dict[str, torch.Tensor]] = []
    for spec in cfg.layout:
        if spec.mixer == MAMBA:
            di = slots(cfg.d_inner)
            per_pos.append({
                "h": torch.zeros((NP, batch, di, cfg.ssm_d_state), dtype=torch.float32,
                                 device=device),
                "conv": torch.zeros((NP, batch, cfg.ssm_d_conv - 1, di), dtype=dt, device=device),
            })
            continue
        if spec.mixer == MLA:
            per_pos.append({
                "ckv": torch.zeros((NP, batch, slots(max_seq), cfg.kv_lora_rank), dtype=dt,
                                   device=device),
                "krope": torch.zeros((NP, batch, slots(max_seq), cfg.qk_rope_dim), dtype=dt,
                                     device=device),
            })
            continue
        Sc = slots(_cache_len(cfg, spec, max_seq))
        shape = (NP, batch, Sc, cfg.n_kv_heads, cfg.head_dim)
        per_pos.append({
            "k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "kpos": torch.full((NP, Sc), -1, dtype=torch.int32, device=device),
        })
    cache = {"pos": 0, "layers": per_pos}
    return cache if ctx.mesh is None else {**cache, "max_seq": max_seq}


def _cache_block(ctx: ShardCtx, name: str, t: torch.Tensor) -> torch.Tensor:
    """A cache leaf stacked over periods, cut to the rank's block by
    ``cache_pspec``'s rule: the sequence of ``k``, ``v``, ``kpos``, ``ckv``
    and ``krope`` and Mamba's d_inner channels of ``h`` and ``conv`` over
    the model axis where it splits them (:func:`_seq_sharded`).  A cut
    block is a copy, so the whole leaf can be freed."""
    # kpos (NP, Sc); h (NP, B, di, st); conv (NP, B, K-1, di); the rest (NP, B, Sc, ...)
    dim = {"kpos": 1, "conv": 3}.get(name, 2)
    n = t.shape[dim]
    if ctx.tp == 1 or not _seq_sharded(ctx, n):
        return t
    return t.narrow(dim, ctx.model_rank * n // ctx.tp, n // ctx.tp).clone()


def _attn_decode(cfg, spec, p, h, cache, pos, cos, sin):
    """One-token attention against the (possibly ring-buffered) cache; the
    new key and value are written into ``cache`` in place."""
    q, k, v = _qkv(cfg, p, h, cos, sin)
    acc, m, l = attn_decode_partial(cfg, spec, q, k, v, cache, pos, 0, 1)
    out = acc / l.clamp(min=1e-30)[..., None]  # (B,KV,G,1,hd)
    return _heads_out(out, h.dtype) @ p["wo"]


def _heads_out(out: torch.Tensor, dtype) -> torch.Tensor:
    """(B, KV, G, 1, hd) attention output -> (B, 1, H·hd) in ``dtype``."""
    return out.permute(0, 3, 1, 2, 4).reshape(out.shape[0], 1, -1).to(dtype)


# ------------------------------------------------------- sharded decodes
def merge_partials(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, pmax, psum) -> torch.Tensor:
    """Partial softmaxes over cache blocks merged into attention: the global
    max ``m_g = pmax(m)``, ``r = exp(m − m_g)``, ``l_g = psum(l·r)``,
    ``acc_g = psum(acc·r)``, -> acc_g / l_g.  With the model axis's
    collectives (one max, two sums: the Chimbuko PS merge's pattern), or
    with reductions over a stacked rank axis (four ranks in one process)."""
    m_g = pmax(m.clone())
    r = torch.exp(m - m_g)
    l_g = psum(l * r)
    acc_g = psum(acc * r[..., None])
    return acc_g / l_g.clamp(min=1e-30)[..., None]


def attn_decode_partial(cfg, spec, q, k_new, v_new, cache, pos, rank: int, tp: int):
    """One rank's share of a decode step's attention over its block of a
    sequence-sharded cache (``cache``'s k, v (B, Sc/tp, KV, hd) and kpos;
    the whole cache at rank 0 of 1): the new key and value are written
    where the rank owns slot ``pos % Sc`` (the ring's slot for SWA; ``pos``
    itself otherwise, pos < Sc), in place.  ``pos`` a 0-d device tensor
    (rank 0 of 1 only): the same writes, indexed on the device.  -> (acc,
    m, l) of ``layers.attention_partial`` over the block."""
    Sc_loc = cache["k"].shape[1]
    if isinstance(pos, torch.Tensor):
        slot = (pos % Sc_loc).view(1)
        cache["k"].index_copy_(1, slot, k_new)
        cache["v"].index_copy_(1, slot, v_new)
        cache["kpos"].index_copy_(0, slot, pos.view(1).to(cache["kpos"].dtype))
        qpos = pos.view(1, 1)
    else:
        rel = pos % (Sc_loc * tp) - rank * Sc_loc
        if 0 <= rel < Sc_loc:
            cache["k"][:, rel] = k_new[:, 0]
            cache["v"][:, rel] = v_new[:, 0]
            # fill_, not ``= pos``: item assignment copies a CPU scalar tensor to
            # the card, a pageable copy that makes the host wait once per layer
            cache["kpos"][rel].fill_(pos)
        qpos = torch.full((1, 1), pos, device=q.device)
    return L.attention_partial(
        q, cache["k"], cache["v"], causal=True, window=cfg.window if spec.mixer == SWA else 0,
        cap=cfg.attn_softcap, scale=1.0 / math.sqrt(cfg.head_dim),
        qpos=qpos, kpos=cache["kpos"][None, :])


def _attn_decode_sharded(cfg, spec, p, q, k_new, v_new, cache, pos: int, ctx: ShardCtx):
    """Flash-decode over a sequence-sharded KV cache (JAX ``model.py:451``):
    every model rank attends to its cache block and the partial softmaxes
    merge with one max and two sums over the model axis.  -> (B, 1, H·hd)
    in q's dtype; the cache block is updated in place."""
    acc, m, l = attn_decode_partial(cfg, spec, q, k_new, v_new, cache, pos, ctx.model_rank,
                                    ctx.tp)
    return _heads_out(merge_partials(acc, m, l, ctx.pmax, ctx.psum), q.dtype)


def mla_decode_partial(cfg, q_eff, q_rope, ckv_new, krope_new, cache, pos, rank: int):
    """One rank's share of the absorbed-MLA decode over its block of the
    sequence-sharded latent cache (slots = positions: no ring); the new
    latent and rope key are written where the rank owns ``pos``, in place.
    ``pos`` a 0-d device tensor (rank 0 of 1 only, pos < the cache's
    slots): the same writes, indexed on the device.  -> (acc (B,H,1,kvr),
    m, l), float32."""
    Sc_loc = cache["ckv"].shape[1]
    if isinstance(pos, torch.Tensor):
        slot = pos.view(1)
        cache["ckv"].index_copy_(1, slot, ckv_new)
        cache["krope"].index_copy_(1, slot, krope_new[:, :, 0])
    else:
        rel = pos - rank * Sc_loc
        if 0 <= rel < Sc_loc:
            cache["ckv"][:, rel] = ckv_new[:, 0]
            cache["krope"][:, rel] = krope_new[:, 0, 0]
    cc, kc = cache["ckv"].float(), cache["krope"].float()
    s = torch.einsum("bqhk,bsk->bhqs", q_eff.float(), cc)
    s = s + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kc)
    s = L.softcap(s * _mla_scale(cfg), cfg.attn_softcap)
    valid = rank * Sc_loc + torch.arange(Sc_loc, device=cc.device) <= pos
    s = torch.where(valid, s, L.NEG_INF)
    m = s.amax(-1)
    pv = torch.where((m <= L.NEG_INF / 2)[..., None], 0.0, torch.exp(s - m[..., None]))
    return torch.einsum("bhqs,bsk->bhqk", pv, cc), m, pv.sum(-1)


def _mla_decode_sharded(cfg, p, q_eff, q_rope, ckv_new, krope_new, cache, pos: int,
                        ctx: ShardCtx) -> torch.Tensor:
    """Absorbed-MLA flash-decode over the sequence-sharded latent cache
    (JAX ``model.py:515``).  -> the latent (B, 1, H, kvr), float32."""
    acc, m, l = mla_decode_partial(cfg, q_eff, q_rope, ckv_new, krope_new, cache, pos,
                                   ctx.model_rank)
    return merge_partials(acc, m, l, ctx.pmax, ctx.psum).transpose(1, 2)


def _mla_decode(cfg, p, h, cache, pos, cos, sin):
    """Absorbed-matrix MLA decode on the compressed latent cache: W_uk is
    folded into the query and W_uv applied after the softmax, so no per-head
    key or value is built.  The new latent and rope key are written into
    ``cache`` at ``pos`` in place.  The casts follow JAX's: q_eff in the
    compute dtype, scores, softmax and the latent sum in float32, then W_uv
    in float32 (JAX promotes bf16 x float32 to float32)."""
    q_eff, q_rope, ckv_new, krope_new = mla_decode_query(cfg, p, h, cos, sin)
    acc, m, l = mla_decode_partial(cfg, q_eff, q_rope, ckv_new, krope_new, cache, pos, 0)
    lat = (acc / l.clamp(min=1e-30)[..., None]).transpose(1, 2)  # (B,1,H,kvr)
    return mla_latent_out(cfg, p, lat, h.dtype)


def mla_decode_query(cfg, p, h, cos, sin):
    """The decode token's absorbed query q_eff (B,1,H,kvr) = q_nope·W_uk,
    its rotated q_rope, and the new latent and rope key for the cache."""
    H, kvr, nope = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_nope_dim
    q_nope, q_rope, ckv_new, krope_new = _mla_project(cfg, p, h, cos, sin)
    q_eff = torch.einsum("bqhn,khn->bqhk", q_nope, p["wuk"].reshape(kvr, H, nope))
    return q_eff, q_rope, ckv_new, krope_new


def mla_latent_out(cfg, p, lat: torch.Tensor, dtype) -> torch.Tensor:
    """The attended latent (B, 1, H, kvr), float32, through W_uv (float32)
    and W_o: the decode's output (B, 1, D)."""
    B, H, kvr, vh = lat.shape[0], cfg.n_heads, cfg.kv_lora_rank, cfg.v_head_dim
    out = torch.einsum("bqhk,khv->bqhv", lat, p["wuv"].reshape(kvr, H, vh).float())
    return out.reshape(B, 1, H * vh).to(dtype) @ p["wo"]


def decode_block(cfg, spec, p, x, cache, pos, cos, sin, ctx: ShardCtx = ShardCtx(),
                 max_seq: Optional[int] = None):
    """One layer of a decode step; ``cache`` (this layer's slice) is
    updated in place.  On a mesh, attention runs the sharded decodes
    wherever the layer's cache is sequence-sharded (:func:`_seq_sharded`
    of its global slots, from ``max_seq``), and Mamba the tensor-parallel
    decode wherever its state is split over d_inner (:func:`_state_split`)."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == MAMBA:
        with _TRACER.span("mamba/decode"):
            if _state_split(cfg, ctx):
                h = MB.mamba_decode_tp(p, h, cache, cfg, ctx.model_rank, ctx.tp, ctx.psum)
            else:
                h, _ = MB.mamba_decode(p, h, cache, cfg)
    else:
        with _TRACER.span("attention/decode"):
            h = _attention_decode(cfg, spec, p, h, cache, pos, cos, sin, ctx, max_seq)
    x = _mixer_residual(cfg, x, h, p)
    return _mlp_residual(cfg, spec, p, x, ctx)


def _attention_decode(cfg, spec, p, h, cache, pos, cos, sin, ctx: ShardCtx,
                      max_seq: Optional[int]):
    """decode_block's attention mixer (MLA or not, sharded or not)."""
    sharded = ctx.mesh is not None and _seq_sharded(ctx, _cache_len(cfg, spec, max_seq))
    if spec.mixer == MLA and sharded:
        q_eff, q_rope, ckv_new, krope_new = mla_decode_query(cfg, p, h, cos, sin)
        lat = _mla_decode_sharded(cfg, p, q_eff, q_rope, ckv_new, krope_new, cache, pos, ctx)
        return mla_latent_out(cfg, p, lat, h.dtype)
    if spec.mixer == MLA:
        return _mla_decode(cfg, p, h, cache, pos, cos, sin)
    if sharded:
        q, k, v = _qkv(cfg, p, h, cos, sin)
        return _attn_decode_sharded(cfg, spec, p, q, k, v, cache, pos, ctx) @ p["wo"]
    return _attn_decode(cfg, spec, p, h, cache, pos, cos, sin)


def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                ctx: ShardCtx = ShardCtx()):
    """One decode step: tokens (B, 1) -> (logits (B, 1, V), cache).

    The cache's tensors are updated in place and returned with ``pos``
    advanced; the cache passed in is not to be stepped again.  On a mesh
    ``tokens`` is the global batch (or placed by ``batch_shardings``), the
    cache the rank's blocks (:func:`init_cache`, :func:`prefill`), and the
    logits the rank's rows; ``params`` may be placed.  Without a mesh
    ``cache["pos"]`` may be a 0-d integer tensor on the cache's device (a
    CUDA graph's position, filled before each replay): every read of it is
    then a device op, with the numbers of the host int's path bit for bit.
    The span ``model/decode_step`` carries ``graphed`` 0: this step runs
    eagerly (``launch.steps.build_decode_step``'s replay carries 1).
    """
    with _TRACER.span("model/decode_step") as span:
        if span:
            span.set(graphed=0)
        pos = cache["pos"]
        if not isinstance(pos, torch.Tensor):
            pos = int(pos)
        elif ctx.mesh is not None:
            raise ValueError("a decode step on a mesh takes the position as a host int")
        max_seq = cache.get("max_seq")
        if ctx.mesh is not None:
            if max_seq is None:
                raise ValueError("a decode step on a mesh takes the rank's cache blocks "
                                 "(init_cache or prefill with the mesh's ShardCtx)")
            ctx = ctx.for_pass(tokens.shape[0], 1)
            tokens = _rank_rows(ctx, "tokens", tokens, tokens.shape[0])
        top = _gathered_top(params)
        x = embed_tokens(cfg, top, {"tokens": tokens})
        B = x.shape[0]
        # M-RoPE: t = h = w = pos, as JAX decodes, also after a prefill whose
        # pos3 continued the text from the visual grid's rows
        shape = (3, B, 1) if cfg.pos == "mrope" else (B, 1)
        positions = pos.to(torch.int32).expand(shape) if isinstance(pos, torch.Tensor) else \
            torch.full(shape, pos, dtype=torch.int32, device=x.device)
        cos, sin = _rope_cos_sin(cfg, positions)
        for period, i, spec, p in _serving_layers(cfg, params, ctx):
            c = {name: t[period] for name, t in cache["layers"][i].items()}
            x = decode_block(cfg, spec, p, x, c, pos, cos, sin, ctx, max_seq)
        logits = unembed(cfg, top, x)
        return logits, {**cache, "pos": pos + 1}


def _expand_layer_cache(cfg: ModelConfig, spec: LayerSpec, c, S: int, max_seq: int):
    """Grow one layout position's prefill cache (stacked over periods) to
    max_seq decode slots, ring-aligned for SWA; a Mamba state passes
    through, MLA latents are zero-padded."""
    if spec.mixer == MAMBA:
        return c
    if spec.mixer == MLA:  # slots == positions: zero-pad to max_seq
        pad = max_seq - c["ckv"].shape[2]
        return {name: F.pad(t, (0, 0, 0, pad)) for name, t in c.items()} if pad > 0 else c
    w = c["k"].shape[2]  # stored length after prefill
    Sc = _cache_len(cfg, spec, max_seq)
    if Sc == w:
        if S > w:  # ring-align: position p must live in slot p % w
            sh = S % w
            c = {
                "k": torch.roll(c["k"], sh, dims=2),
                "v": torch.roll(c["v"], sh, dims=2),
                "kpos": torch.roll(c["kpos"], sh, dims=1),
            }
        return c
    assert Sc > w, (Sc, w)
    NP, B, _, KV, hd = c["k"].shape
    off = S - w  # slots == positions (no wrap: S <= Sc here)
    k = c["k"].new_zeros((NP, B, Sc, KV, hd))
    v = c["v"].new_zeros((NP, B, Sc, KV, hd))
    kpos = torch.full((NP, Sc), -1, dtype=torch.int32, device=c["kpos"].device)
    k[:, :, off:off + w] = c["k"]
    v[:, :, off:off + w] = c["v"]
    kpos[:, off:off + w] = c["kpos"]
    return {"k": k, "v": v, "kpos": kpos}


def prefill(cfg: ModelConfig, params, batch, ctx: ShardCtx = ShardCtx(),
            max_seq: Optional[int] = None):
    """Sequence pass returning (last-position logits, populated cache).

    A Mamba layer runs ``mamba.mamba_prefill``: one scan-kernel launch
    gives its output and its decode state, where JAX computes the state in
    a second pass (``_mamba_prefill_state``).  With ``ctx.plain`` or
    ``ctx.unroll`` (the dry run) attention and the scan take their plain
    versions instead of the kernels.

    On a mesh every rank passes the global batch (or its leaves placed by
    ``batch_shardings``) and gets its rows of the last position's logits
    and its cache blocks (:func:`_cache_block`), each layer's cut as soon
    as it is built, so no rank holds the whole cache; placed weights are
    gathered a layer at a time.  Sequence-sharded, attention is the
    context-parallel body, its cache built from the gathered K and V (MLA:
    the gathered latents), and a Mamba layer the sequence-parallel mixer,
    whose prefix combine carried one rank further gives the state.
    """
    with _TRACER.span("model/prefill", timed_on=params["embed"]):
        _check_compute(cfg, params)
        top = _gathered_top(params)
        x, cos, sin, ctx = _inputs(cfg, top["embed"], batch, ctx)
        S = x.shape[1] * (ctx.tp if ctx.seq_shard else 1)
        per_pos: List[Dict[str, List[torch.Tensor]]] = [{} for _ in cfg.layout]
        for _, i, spec, p in _serving_layers(cfg, params, ctx):
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            if spec.mixer == MAMBA and ctx.seq_shard:
                h, cch = MB.mamba_mixer_seq_parallel(
                    p, h, cfg, ctx, chunk=ctx.mamba_chunk(S // ctx.tp), with_state=True)
            elif spec.mixer == MAMBA:
                h, cch = MB.mamba_prefill(p, h, cfg, chunk=None if ctx.kernels
                                          else ctx.mamba_chunk(S))
            elif spec.mixer == MLA:
                h, (ckv, krope) = _mla_seq_with_cache(cfg, p, h, cos, sin, ctx)
                cch = {"ckv": ckv, "krope": krope}
            else:
                h, (k, v) = _attn_seq_with_cache(cfg, spec, p, h, cos, sin, ctx)
                if spec.mixer == SWA:
                    w = min(cfg.window, S)
                    k, v = k[:, -w:], v[:, -w:]
                    kpos = torch.arange(S - w, S, dtype=torch.int32, device=x.device)
                else:
                    kpos = torch.arange(S, dtype=torch.int32, device=x.device)
                cch = {"k": k, "v": v, "kpos": kpos}
            x = _mixer_residual(cfg, x, h, p)
            x = _mlp_residual(cfg, spec, p, x, ctx)
            cch = {name: t[None] for name, t in cch.items()}  # a period axis of 1
            if max_seq is not None and max_seq != S:
                cch = _expand_layer_cache(cfg, spec, cch, S, max_seq)
            for name, t in cch.items():
                per_pos[i].setdefault(name, []).append(_cache_block(ctx, name, t)[0])
        # stacked a leaf at a time, each leaf's layers freed as it goes
        layer_caches = [{name: torch.stack(c.pop(name)) for name in list(c)} for c in per_pos]
        last = x[:, -1:]
        if ctx.seq_shard:  # the last position lives on the last model rank
            last = ctx.all_gather(last)[-1]
        logits = unembed(cfg, top, last)
        cache = {"pos": S, "layers": layer_caches}
        if ctx.mesh is None:
            return logits, cache
        return logits, {**cache, "max_seq": S if max_seq is None else max_seq}
