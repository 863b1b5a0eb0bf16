"""Public wrappers for the port's kernels.

``ops`` does the shape hygiene (dtype and contiguity of the event stream,
head-dim padding for attention, float32 scan elements) and the format
conversion between the moments kernel's raw-sums table (n, Σx, Σx², min,
max) and the torch_ad (n, mean, M2, min, max) layout.  Each wrapper runs
the kernel for CUDA tensors and its plain version for CPU tensors (see
``moments.moments_and_labels``, ``flash_attention.flash_attention`` and
``mamba_scan.mamba_scan``).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..core.torch_ad import merge_tables
from . import flash_attention as _fa
from . import mamba_scan as _ms
from . import moments as _mo


def sums_to_stats(sums: torch.Tensor) -> torch.Tensor:
    """(n, Σx, Σx², min, max) -> (n, mean, M2, min, max) (torch_ad layout)."""
    n = sums[:, 0]
    mean = torch.where(n > 0, sums[:, 1] / n.clamp(min=1.0), 0.0)
    m2 = (sums[:, 2] - n * mean * mean).clamp(min=0.0)
    return torch.stack([n, mean, m2, sums[:, 3], sums[:, 4]], dim=-1)


def stats_to_sums(table: torch.Tensor) -> torch.Tensor:
    n, mean, m2 = table[:, 0], table[:, 1], table[:, 2]
    return torch.stack(
        [n, n * mean, m2 + n * mean * mean, table[:, 3], table[:, 4]], dim=-1
    )


def _events(fids: torch.Tensor, durs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return (fids.reshape(-1).to(torch.int32).contiguous(),
            durs.reshape(-1).to(torch.float32).contiguous())


def moments_update(
    table: torch.Tensor,  # (F, 5) torch_ad stats layout
    fids: torch.Tensor,
    durs: torch.Tensor,
    alpha: float = 6.0,
    min_count: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel-backed ad_step: label against ``table``, then fold events in."""
    f, d = _events(fids, durs)
    sums = stats_to_sums(table).contiguous()
    delta, labels = _mo.moments_and_labels(f, d, sums, alpha=alpha, min_count=min_count)
    return merge_tables(table, sums_to_stats(delta)), labels


def moments_table(
    fids: torch.Tensor, durs: torch.Tensor, F: int, fid_offset: int = 0
) -> torch.Tensor:
    """Kernel-backed batch_table (distributed AD's local reduction).

    With ``fid_offset``, computes the delta for the contiguous PS-shard
    block [fid_offset, fid_offset + F) only — the federated per-shard
    segment reduction (events outside the block are masked in-kernel).
    """
    f, d = _events(fids, durs)
    zero = torch.zeros((F, 5), dtype=torch.float32, device=f.device)
    delta, _ = _mo.moments_and_labels(f, d, zero, fid_offset=fid_offset)
    return sums_to_stats(delta)


# ----------------------------------------------------------- flash attention
def padded_head_dim(hd: int) -> int:
    """The smallest head dim the kernel is built for that holds ``hd``."""
    for width in _fa.HEAD_DIMS:
        if hd <= width:
            return width
    raise ValueError(f"head_dim {hd} exceeds the kernel's largest, {_fa.HEAD_DIMS[-1]}")


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    causal: bool = True, window: int = 0, cap: float = 0.0,
    scale: Optional[float] = None, kv_len: Optional[int] = None,
) -> torch.Tensor:
    """Kernel-backed attention; q (B,Sq,H,hd), k/v (B,Sk,KV,hd) -> (B,Sq,H,hd).

    The head dim is zero-padded up to one the kernel is built for (the
    JAX wrapper pads to the TPU's 128 lanes): padded q/k columns leave the
    scores unchanged and padded v columns are cropped from the output.
    """
    hd = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    pad = padded_head_dim(hd) - hd
    if pad:
        q, k, v = (F.pad(t, (0, pad)) for t in (q, k, v))
    out = _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
                              window=window, cap=cap, scale=scale, kv_len=kv_len)
    return out[..., :hd] if pad else out


# ----------------------------------------------------------------- mamba scan
def mamba_scan(
    a: torch.Tensor, b: torch.Tensor, C: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel-backed selective scan; a/b (B,S,di,st), C (B,S,st) ->
    (y (B,S,di), h_last (B,di,st)), float32.

    The inputs are taken in float32 and contiguous, as the JAX wrapper casts
    them; its ``block_d``/``chunk`` are TPU tiles with no counterpart here.
    """
    return _ms.mamba_scan(a.float().contiguous(), b.float().contiguous(),
                          C.float().contiguous())
