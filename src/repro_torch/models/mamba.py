"""Mamba-1 selective SSM block (port of ``repro.models.mamba``): falcon-mamba.

Two sequence paths, as in the JAX package:

  * ``mamba_sequence`` (forward) — the chunked parallel scan of
    ``_ssm_scan_fused``: within a chunk the linear recurrence
    h_t = a_t h_{t-1} + b_t is a log-depth associative scan (the same
    odd/even recursion as ``lax.associative_scan``), chunks threaded in
    order with only the boundary state carried.
  * ``mamba_prefill`` (prefill) — one launch of the hand-written scan
    kernel (``kernels.ops.mamba_scan``) per layer gives both the output and
    the final state the decode cache needs, where JAX runs the projections
    and the scan a second time (``model._mamba_prefill_state``).

Decode is the O(1) single-step state update, ``mamba_decode``, with the
cache updated in place.  The sequence-parallel mixer waits for the
multi-GPU work (ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from .._unported import unported
from ..device import resolve
from ..kernels import ops
from . import layers as L
from .common import ModelConfig


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. x (B,S,di), w (K,di), b (di,); one tap at a
    time, rounded as JAX's unrolled taps round."""
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
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
        a, b = _scan_elements(dtc, xc, bc, A)
        h, y = _chunk_scan(a, b, cc.float(), h)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _scan_elements(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor, A: torch.Tensor):
    """The scan's decay a = exp(dt·A) and drive b = (dt·x)·B, (B,L,di,st)
    float32.  dt·x is taken in the compute dtype before the cast, as JAX
    takes it: in bf16 that rounding point decides parity."""
    a = (dt.float()[..., None] * A).exp_()
    b = (dt * x).float()[..., None] * Bm.float()[:, :, None, :]
    return a, b


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


def mamba_mixer_seq_parallel(p, u, cfg: ModelConfig, ctx, chunk: int = 128):
    """The sequence-parallel mixer runs across devices: not ported yet."""
    raise unported("the sequence-parallel Mamba mixer", 11)


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
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill mixer: (output (B,S,d_model), decode state {"h", "conv"}).

    One ``ops.mamba_scan`` launch gives y and the final state; the conv
    tail is the last K−1 pre-conv inputs, as JAX's ``_mamba_prefill_state``
    takes them (left-padded with the conv's zeros when S < K−1, where JAX
    keeps fewer rows and its decode cannot run).  Any S ≥ 1.  The scan elements a and b
    are (B,S,di,st) float32 (2.15 GB each at falcon-mamba-7b's serving wave
    of 4 × 1024) and are freed before the layer returns.
    """
    K = cfg.ssm_d_conv
    xz = u @ p["in_proj"]
    x, z = xz.chunk(2, dim=-1)
    tail = x[:, -(K - 1):]  # copied: a view would keep all of xz alive
    conv = F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0)) if tail.shape[1] < K - 1 \
        else tail.clone()
    x = L.silu(causal_conv1d(x, p["conv_w"], p["conv_b"]))
    dt, Bm, Cm, A = _project(p, x, cfg)
    a, b = _scan_elements(dt, x, Bm, A)
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


def init_mamba_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                     device=None) -> Dict[str, torch.Tensor]:
    device = resolve(device)
    return {
        "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_d_state), dtype=torch.float32,
                         device=device),
        "conv": torch.zeros((batch, cfg.ssm_d_conv - 1, cfg.d_inner), dtype=dtype,
                            device=device),
    }
