"""Mamba-1 selective SSM block (port of ``repro.models.mamba``): falcon-mamba.

Two sequence paths, as in the JAX package:

  * ``mamba_sequence`` (forward) — the chunked parallel scan of
    ``_ssm_scan_fused``: within a chunk the linear recurrence
    h_t = a_t h_{t-1} + b_t is a log-depth associative scan (the same
    odd/even recursion as ``lax.associative_scan``), chunks threaded in
    order with only the boundary state carried.
  * ``mamba_prefill`` (prefill) — one launch of the hand-written staging
    kernel (``kernels.ops.mamba_stage``) builds the scan's a and b, and one
    of the scan kernel (``kernels.ops.mamba_scan``) per layer gives both the
    output and the final state the decode cache needs, where JAX runs the
    projections and the scan a second time (``model._mamba_prefill_state``).

Decode is the O(1) single-step state update, ``mamba_decode``, with the
cache updated in place; ``mamba_decode_tp`` runs it tensor-parallel over a
mesh's model axis on a state split over d_inner.  ``mamba_mixer_seq_parallel`` runs the forward and
prefill of a sequence sharded over a mesh's model axis: local pieces
(:func:`seq_shard_scan`, :func:`prefix_state`, :func:`seq_shard_output`)
around two all-gathers.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from ..kernels.ref import mamba_stage_ref
from ..telemetry.selftrace import get_self_tracer
from . import layers as L
from .common import ModelConfig

_TRACER = get_self_tracer()  # spans mamba/prefill and mamba/stage


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  left: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,di), w (K,di), b (di,); one tap at a
    time, rounded as JAX's unrolled taps round.  ``left`` (B,K−1,di) are
    the inputs before x's first row (a sequence shard's halo), else zeros."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0)) if left is None else torch.cat([left, x], dim=1)
    out = torch.zeros_like(x)
    for j in range(K):  # K is tiny (4): unrolled taps
        out = out + pad[:, j:j + S] * w[j]
    return out + b


def _slice(t: torch.Tensor, dim: int, start, stop, step=1) -> torch.Tensor:
    return t[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    shape = list(even.shape)
    shape[dim] = even.shape[dim] + odd.shape[dim]
    out = even.new_empty(shape)
    out[(slice(None),) * dim + (slice(0, None, 2),)] = even
    out[(slice(None),) * dim + (slice(1, None, 2),)] = odd
    return out


def associative_scan(fn: Callable, elems: List[torch.Tensor], dim: int) -> List[torch.Tensor]:
    """Inclusive scan of ``elems`` along ``dim`` under the associative ``fn``,
    by ``lax.associative_scan``'s recursion (pairs combined, the half-length
    scan recursed, the even elements filled in), so that every element is
    combined in the same order as JAX combines it."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = fn([_slice(e, dim, 0, -1, 2) for e in elems],
                 [_slice(e, dim, 1, None, 2) for e in elems])
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn([_slice(e, dim, 0, -1) for e in odd], [_slice(e, dim, 2, None, 2) for e in elems])
    else:
        even = fn(odd, [_slice(e, dim, 2, None, 2) for e in elems])
    even = [torch.cat([_slice(e, dim, 0, 1), r], dim=dim) for e, r in zip(elems, even)]
    return [_interleave(e, o, dim) for e, o in zip(even, odd)]


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return [a1 * a2, a2 * b1 + b2]


def _chunk_scan(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
    """One chunk: a/b (B,Lc,di,st), c (B,Lc,st) float32, h (B,di,st) ->
    (last state, y (B,Lc,di))."""
    A_cum, B_cum = associative_scan(_combine, [a, b], dim=1)
    hs = A_cum * h[:, None] + B_cum
    return hs[:, -1], torch.einsum("blds,bls->bld", hs, c)


def _ssm_scan_chunked(
    a: torch.Tensor,  # (B, S, di, st)  decay  exp(dt*A)
    b: torch.Tensor,  # (B, S, di, st)  input  dt*B*x
    C: torch.Tensor,  # (B, S, st)
    h0: Optional[torch.Tensor] = None,  # (B, di, st)
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y (B,S,di), h_last (B,di,st)). y_t = C_t · h_t."""
    B, S, di, st = a.shape
    Lc = min(chunk, S)
    assert S % Lc == 0, (S, Lc)
    h = torch.zeros((B, di, st), dtype=a.dtype, device=a.device) if h0 is None else h0
    ys = []
    for i in range(0, S, Lc):
        h, y = _chunk_scan(a[:, i:i + Lc], b[:, i:i + Lc], C[:, i:i + Lc], h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _ssm_scan_fused(
    dt: torch.Tensor,  # (B, S, di)
    x: torch.Tensor,  # (B, S, di)  post-conv activations
    Bm: torch.Tensor,  # (B, S, st)
    Cm: torch.Tensor,  # (B, S, st)
    A: torch.Tensor,  # (di, st)
    h0: Optional[torch.Tensor] = None,
    chunk: int = 128,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked scan with the (B,Lc,di,st) decay/drive tensors built per
    chunk, never for the whole sequence; float32 state and output."""
    B, S, di = dt.shape
    st = Bm.shape[-1]
    Lc = min(chunk, S)
    assert S % Lc == 0, (S, Lc)
    h = torch.zeros((B, di, st), dtype=torch.float32, device=dt.device) if h0 is None else h0
    ys = []
    for i in range(0, S, Lc):
        dtc, xc, bc, cc = (t[:, i:i + Lc] for t in (dt, x, Bm, Cm))
        a, b = mamba_stage_ref(dtc, xc, bc, A)
        h, y = _chunk_scan(a, b, cc.float(), h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _h0_correction(
    dt: torch.Tensor,  # (B, L, di)
    Cm: torch.Tensor,  # (B, L, st)
    A: torch.Tensor,  # (di, st)
    h_in: torch.Tensor,  # (B, di, st)
    chunk: int = 128,
) -> torch.Tensor:
    """y contribution of an incoming state: C_t · (A_cum_t · h_in), where
    A_cum_t = exp(A · cumsum(Δt)) — closed form because a_t = exp(Δt_t·A).
    Covers the first (L // Lc) · Lc positions, as JAX's chunk loop does."""
    L_ = dt.shape[1]
    csum = torch.cumsum(dt.float(), dim=1)  # (B, L, di)
    Lc = min(chunk, L_)
    ys = []
    for i in range(0, (L_ // Lc) * Lc, Lc):
        acum = torch.exp(csum[:, i:i + Lc, :, None] * A)  # (B, Lc, di, st)
        ys.append(torch.einsum("blds,bds,bls->bld", acum, h_in, Cm[:, i:i + Lc].float()))
    return torch.cat(ys, dim=1)


def prefix_state(pairs: List[torch.Tensor], i: int) -> torch.Tensor:
    """The state entering sequence shard ``i`` from every shard's (2, B,
    di, st) pair (exp(A·ΣΔt), h_last) of a scan from h₀ = 0, combined from
    the oldest shard to the newest in a fixed order:
    h_in(i) = Σ_{j<i} (Π_{j<k<i} a_prod_k) · h_last_j.  ``i`` = the number
    of shards gives the state after the last: the whole sequence's."""
    h = torch.zeros_like(pairs[0][1])
    for j in range(i):
        h = h * pairs[j][0] + pairs[j][1]
    return h


def seq_shard_scan(p: Dict[str, torch.Tensor], x: torch.Tensor, left: torch.Tensor,
                   cfg: ModelConfig, chunk: int, kernel: bool):
    """One sequence shard's local work before the exchange of states: the
    causal conv from the halo ``left`` (the K−1 pre-conv inputs before the
    shard, zeros on the first), the projections, and the scan from h₀ = 0,
    through ``ops.mamba_stage`` and ``ops.mamba_scan`` where ``kernel``, else
    the chunked plain scan.  -> (conv output, Δt, C, A, y₀, the shard's
    (2, B, di, st) pair (exp(A·ΣΔt), h_last))."""
    x = L.silu(causal_conv1d(x, p["conv_w"], p["conv_b"], left))
    dt, Bm, Cm, A = _project(p, x, cfg)
    if kernel:
        a, b = ops.mamba_stage(dt, x, Bm, A)
        y0, h_last = ops.mamba_scan(a, b, Cm.float())
        del a, b
    else:
        y0, h_last = _ssm_scan_fused(dt, x, Bm, Cm, A, chunk=chunk)
    a_prod = torch.exp(dt.float().sum(dim=1)[..., None] * A)
    return x, dt, Cm, A, y0, torch.stack([a_prod, h_last])


def seq_shard_output(p: Dict[str, torch.Tensor], x, z, dt, Cm, A, y0, h_in: torch.Tensor,
                     chunk: int, dtype) -> torch.Tensor:
    """One shard's mixer output once its incoming state is known: y₀ plus
    the closed-form C_t·(A_cum_t·h_in) of ``_h0_correction``, then the
    skip, the gate and the output projection."""
    return _output(p, y0 + _h0_correction(dt, Cm, A, h_in, chunk=chunk), x, z, dtype)


def mamba_mixer_seq_parallel(p, u, cfg: ModelConfig, ctx, chunk: int = 128,
                             with_state: bool = False):
    """Sequence-parallel Mamba (JAX ``mamba.py:141``): each model rank scans
    its S/tp rows of u (B, S/tp, D); the handoff between ranks is exact
    because a shard's decay product has the closed form
    Π_t exp(Δt_t·A) = exp(A·ΣΔt):

      1. the halo for the causal conv: JAX ``ppermute``s the last K−1
         pre-conv rows from rank i to i+1 (rank 0 gets zeros); the port
         all-gathers them, which also gives prefill the conv state;
      2. the local scan from h₀ = 0 (:func:`seq_shard_scan`): the scan
         kernel where ``ctx.kernels`` holds and no gradient is taken, else
         ``_ssm_scan_fused``;
      3. an all-gather of every rank's (exp(A·ΣΔt), h_last);
         both gathers carry autograd where a gradient is taken;
      4. the prefix combine (:func:`prefix_state`) and
         C_t·A_cum_t·h_in (:func:`seq_shard_output`).

    With ``with_state`` -> (output, decode state {"h", "conv"}): the prefix
    combine carried past the last rank, and the last rank's K−1 rows, as
    :func:`mamba_prefill` gives them for the whole sequence."""
    K, r = cfg.ssm_d_conv, ctx.model_rank
    xz = u @ p["in_proj"]
    x, z = xz.chunk(2, dim=-1)
    tails = ctx.all_gather(x[:, -(K - 1):])
    # rank 0 reads no other rank's rows: its zeros are tied to the gathers,
    # so that under autograd every rank runs their backward (a collective)
    left = tails[r - 1] if r > 0 else tails[0] * 0
    kernel = ctx.kernels and not torch.is_grad_enabled()
    x, dt, Cm, A, y0, pair = seq_shard_scan(p, x, left, cfg, chunk, kernel)
    pairs = ctx.all_gather(pair)
    h_in = prefix_state(pairs, r) if r > 0 else pairs[0][1] * 0
    out = seq_shard_output(p, x, z, dt, Cm, A, y0, h_in, chunk, u.dtype)
    if not with_state:
        return out
    return out, {"h": prefix_state(pairs, len(pairs)), "conv": tails[-1]}


def _project(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig):
    """Post-conv x -> (softplus Δt (B,S,di), B (B,S,st), C (B,S,st), A (di,st))."""
    dr, st = cfg.dt_rank, cfg.ssm_d_state
    dbl = x @ p["x_proj"]  # (B,S,dr+2st)
    dt, Bm, Cm = torch.split(dbl, [dr, st, st], dim=-1)
    dt = L.softplus(dt @ p["dt_proj"] + p["dt_bias"])  # (B,S,di)
    A = -torch.exp(p["A_log"].float())  # (di, st)
    return dt, Bm, Cm, A


def _output(p: Dict[str, torch.Tensor], y: torch.Tensor, x: torch.Tensor, z: torch.Tensor,
            dtype) -> torch.Tensor:
    y = y.to(dtype) + x * p["D"]
    y = y * L.silu(z)
    return y @ p["out_proj"]


def mamba_sequence(
    p: Dict[str, torch.Tensor],
    u: torch.Tensor,  # (B, S, d_model)
    cfg: ModelConfig,
    chunk: int = 128,
) -> torch.Tensor:
    """Full-sequence mamba mixer (forward)."""
    xz = u @ p["in_proj"]  # (B,S,2di)
    x, z = xz.chunk(2, dim=-1)
    x = L.silu(causal_conv1d(x, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm, A = _project(p, x, cfg)
    y, _ = _ssm_scan_fused(dt, x, Bm, Cm, A, chunk=chunk)
    return _output(p, y, x, z, u.dtype)


def mamba_prefill(
    p: Dict[str, torch.Tensor],
    u: torch.Tensor,  # (B, S, d_model)
    cfg: ModelConfig,
    chunk: Optional[int] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill mixer: (output (B,S,d_model), decode state {"h", "conv"}).

    One ``ops.mamba_stage`` launch builds the scan elements a and b, one
    ``ops.mamba_scan`` launch gives y and the final state; the conv
    tail is the last K−1 pre-conv inputs, as JAX's ``_mamba_prefill_state``
    takes them (left-padded with the conv's zeros when S < K−1, where JAX
    keeps fewer rows and its decode cannot run).  Any S ≥ 1.  a and b are
    (B,S,di,st) float32 (17.2 GB each at falcon-mamba-7b's serving wave of
    32 × 1024) and are freed before the layer returns.  With ``chunk``
    the scan is ``mamba_sequence``'s chunked plain scan instead (the dry
    run: no kernel takes meta tensors), which gives y and the state too.
    """
    with _TRACER.span("mamba/prefill"):
        K = cfg.ssm_d_conv
        xz = u @ p["in_proj"]
        x, z = xz.chunk(2, dim=-1)
        tail = x[:, -(K - 1):]  # copied: a view would keep all of xz alive
        conv = F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0)) if tail.shape[1] < K - 1 \
            else tail.clone()
        x = L.silu(causal_conv1d(x, p["conv_w"], p["conv_b"]))
        dt, Bm, Cm, A = _project(p, x, cfg)
        if chunk is not None:
            y, h = _ssm_scan_fused(dt, x, Bm, Cm, A, chunk=chunk)
            # copied: h is a view of the last chunk's (B,Lc,di,st) states, which
            # the cache would otherwise keep alive (268 MB a layer at 4 x 1024)
            return _output(p, y, x, z, u.dtype), {"h": h.clone(), "conv": conv}
        with _TRACER.span("mamba/stage"):
            a, b = ops.mamba_stage(dt, x, Bm, A)
        y, h = ops.mamba_scan(a, b, Cm.float())
        del a, b
        return _output(p, y, x, z, u.dtype), {"h": h, "conv": conv}


def mamba_decode(
    p: Dict[str, torch.Tensor],
    u: torch.Tensor,  # (B, 1, d_model)
    state: Dict[str, torch.Tensor],  # {"h": (B,di,st), "conv": (B,K-1,di)}
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token state update — O(1) in context length.

    ``state``'s tensors are updated in place (JAX returns new ones) and
    returned; the values are JAX's.
    """
    xz = u[:, 0] @ p["in_proj"]  # (B, 2di)
    x, z = xz.chunk(2, dim=-1)
    conv_in = torch.cat([state["conv"], x[:, None]], dim=1)  # (B,K,di)
    x = L.silu(torch.einsum("bkd,kd->bd", conv_in, p["conv_w"]) + p["conv_b"])
    dt, Bm, Cm, A = _project(p, x, cfg)  # dt (B,di), Bm/Cm (B,st)
    a = torch.exp(dt.float()[..., None] * A)  # (B,di,st)
    b = (dt * x).float()[..., None] * Bm.float()[:, None, :]
    h = a * state["h"] + b
    y = torch.einsum("bds,bs->bd", h, Cm.float())
    out = _output(p, y, x, z, u.dtype)[:, None]
    state["h"].copy_(h)
    state["conv"].copy_(conv_in[:, 1:])
    return out, state


def channel_block(cfg: ModelConfig, rank: int, tp: int) -> slice:
    """Model rank ``rank``'s d_inner channels of ``tp``: its block of the
    decode state as ``cache_pspec`` splits it."""
    n = cfg.d_inner // tp
    return slice(rank * n, (rank + 1) * n)


def mamba_decode_tp_in(p: Dict[str, torch.Tensor], u: torch.Tensor, state: Dict[str, torch.Tensor],
                       cfg: ModelConfig, rank: int, tp: int):
    """The tensor-parallel decode's first part on model rank ``rank`` of
    ``tp``, whose state block (``h`` (B, di/tp, st), ``conv`` (B, K−1,
    di/tp)) holds its channels (:func:`channel_block`): its x and z
    channels of ``in_proj`` (columns c and di + c: ``in_proj``'s placement
    splits the 2·di columns, not x and z alike), the conv on them, and its
    partial product with ``x_proj``'s rows, which the ranks sum.  ``p``
    holds whole weights.  -> (x, z, conv_in, the partial of x @ x_proj
    (B, dr+2st) taken in float32: summed over the ranks and rounded once,
    as one device's GEMM accumulates and rounds once)."""
    c = channel_block(cfg, rank, tp)
    di = cfg.d_inner
    w = p["in_proj"]
    x, z = u[:, 0] @ w[:, c], u[:, 0] @ w[:, di + c.start:di + c.stop]
    conv_in = torch.cat([state["conv"], x[:, None]], dim=1)  # (B,K,di/tp)
    x = L.silu(torch.einsum("bkd,kd->bd", conv_in, p["conv_w"][:, c]) + p["conv_b"][c])
    return x, z, conv_in, x.float() @ p["x_proj"][c].float()


def mamba_decode_tp_out(p: Dict[str, torch.Tensor], x, z, conv_in, dbl: torch.Tensor,
                        state: Dict[str, torch.Tensor], cfg: ModelConfig, rank: int,
                        tp: int) -> torch.Tensor:
    """The second part, once ``dbl`` is the ranks' sum (in x's dtype): Δt
    of the rank's channels (``dt_proj``'s columns, ``dt_bias``), the state
    update of its block in place, and its partial output through its rows
    of ``out_proj``, float32 (B, d_model), which the ranks sum."""
    c = channel_block(cfg, rank, tp)
    dr, st = cfg.dt_rank, cfg.ssm_d_state
    dt, Bm, Cm = torch.split(dbl, [dr, st, st], dim=-1)
    dt = L.softplus(dt @ p["dt_proj"][:, c] + p["dt_bias"][c])  # (B,di/tp)
    A = -torch.exp(p["A_log"][c].float())
    a = torch.exp(dt.float()[..., None] * A)
    b = (dt * x).float()[..., None] * Bm.float()[:, None, :]
    h = a * state["h"] + b
    y = torch.einsum("bds,bs->bd", h, Cm.float())
    y = (y.to(x.dtype) + x * p["D"][c]) * L.silu(z)
    state["h"].copy_(h)
    state["conv"].copy_(conv_in[:, 1:])
    return y.float() @ p["out_proj"][c].float()


def mamba_decode_tp(p: Dict[str, torch.Tensor], u: torch.Tensor, state: Dict[str, torch.Tensor],
                    cfg: ModelConfig, rank: int, tp: int, psum: Callable) -> torch.Tensor:
    """Tensor-parallel single-token Mamba over the model axis (XLA's
    partition of JAX's ``mamba_decode`` when the state is split over
    d_inner): each rank updates its channels' state in place, and two
    sums over the ranks (``psum``: the model axis's all-reduce) complete
    x @ x_proj and the output projection; the partials are taken and
    summed in float32 and rounded once.  ``p`` holds whole weights (gathered placed
    ones).  -> (B, 1, d_model) in u's dtype."""
    x, z, conv_in, dbl = mamba_decode_tp_in(p, u, state, cfg, rank, tp)
    dbl = psum(dbl).to(u.dtype)
    out = mamba_decode_tp_out(p, x, z, conv_in, dbl, state, cfg, rank, tp)
    return psum(out).to(u.dtype)[:, None]
