"""Plain PyTorch versions of the port's kernels (the allclose ground truth).

Each function computes what its kernel computes, with ordinary tensor
operations.  The kernel wrappers call it for tensors that lie on the CPU,
and ``chip_smoke.py`` holds each kernel against it on the card.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG = -1e30
POS = 1e30


def moments_and_labels_ref(
    fids: torch.Tensor,
    durs: torch.Tensor,
    table_sums: torch.Tensor,
    alpha: float = 6.0,
    min_count: float = 10.0,
    fid_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (delta (F,5) [n, Σx, Σx², min, max] float32, labels (N,) int8).

    Follows the kernel (``kernels/moments.py``): events whose
    ``fid - fid_offset`` lies outside ``[0, F)`` drop out like padding, and
    rows no event reached keep the ±1e30 sentinels.  (``repro.kernels.ref``
    instead clips fids ≥ F into row F−1; the two agree on fids in [−1, F).)
    Labels compare each valid event with the previous raw-sums table's
    μ ± ασ, in float32, where that row has ``n ≥ min_count``.
    """
    F = table_sums.shape[0]
    dev = durs.device
    f = fids.long() - fid_offset
    valid = (f >= 0) & (f < F)
    x = durs.to(torch.float32)

    seg, xv = f[valid], x[valid]
    zeros = torch.zeros(F, dtype=torch.float32, device=dev)
    n = zeros.index_add(0, seg, torch.ones_like(xv))
    s = zeros.index_add(0, seg, xv)
    q = zeros.index_add(0, seg, xv * xv)
    mn = torch.full((F,), POS, dtype=torch.float32, device=dev).scatter_reduce(0, seg, xv, "amin")
    mx = torch.full((F,), NEG, dtype=torch.float32, device=dev).scatter_reduce(0, seg, xv, "amax")
    delta = torch.stack([n, s, q, mn, mx], dim=-1)

    tbl = table_sums.to(torch.float32)
    row = f.clamp(0, F - 1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    n_p = torch.where(valid, tbl[row, 0], zero)
    n_safe = n_p.clamp(min=1.0)
    mu = torch.where(n_p > 0, tbl[row, 1] / n_safe, zero)
    var = torch.where(n_p > 1, tbl[row, 2] / n_safe - mu * mu, zero).clamp(min=0.0)
    a_sd = torch.tensor(alpha, dtype=torch.float32, device=dev) * torch.sqrt(var)
    out = (x > mu + a_sd) | (x < mu - a_sd)
    out &= n_p >= torch.tensor(min_count, dtype=torch.float32, device=dev)
    out &= valid
    return delta, out.to(torch.int8)


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    cap: float = 0.0,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Materialised-score GQA attention.  q (B,Sq,H,hd), k/v (B,Sk,KV,hd).

    The twin of ``repro.kernels.ref.flash_attention_ref`` in float32, except
    that it follows the kernel (``kernels/flash_attention.py``) on a row
    with no live key: the kernel gives 0 there, where a softmax over
    all-masked scores gives the mean of v.  The two agree on every row that
    has at least one live key.
    """
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * scale
    if cap > 0:
        s = torch.tanh(s / cap) * cap
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    ok = kpos < (Sk if kv_len is None else kv_len)
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & ((qpos - kpos) < window)
    s = torch.where(ok, s, NEG)
    p = torch.where(ok, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True).clamp(min=1e-30)
    out = torch.einsum("bkgqs,bskd->bkgqd", p, v.float()) / l
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def mamba_scan_ref(
    a: torch.Tensor, b: torch.Tensor, C: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential Mamba-1 recurrence: h_t = a_t·h_{t−1} + b_t, y_t = Σ_s h_t·C_t.

    a/b (B,S,di,st), C (B,S,st) -> (y (B,S,di), h_last (B,di,st)), float32
    from h_0 = 0.  The twin of ``repro.kernels.ref.mamba_scan_ref``; each
    step rounds the product and the sum apart, as the kernel does, so the
    two carry bitwise-equal states and differ in y only by the order of the
    sum over st.
    """
    a, b, C = a.float(), b.float(), C.float()
    B, S, di, st = a.shape
    h = torch.zeros((B, di, st), dtype=torch.float32, device=a.device)
    y = torch.empty((B, S, di), dtype=torch.float32, device=a.device)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        y[:, t] = torch.einsum("bds,bs->bd", h, C[:, t])
    return y, h


def mamba_stage_ref(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor, A: torch.Tensor):
    """The scan's decay a = exp(dt·A) and drive b = (dt·x)·B, (B,L,di,st)
    float32, from dt/x (B,L,di), Bm (B,L,st) and A (di,st).  dt·x is taken
    in the compute dtype before the cast, as JAX takes it: in bf16 that
    rounding point decides parity."""
    a = (dt.float()[..., None] * A).exp_()
    b = (dt * x).float()[..., None] * Bm.float()[:, :, None, :]
    return a, b
