"""Forward flash attention (causal / GQA / sliding window / softcap) as a Hopper kernel.

The CUDA kernels in ``csrc/flash_attention.cu`` replace the Pallas TPU
kernel ``repro/kernels/flash_attention.py:_flash_kernel``; its source note
gives the bound and the design of each instance: bfloat16 on the tensor
cores (wgmma on TMA-fed shared-memory tiles), float32 on the CUDA cores.
:func:`plan` mirrors each instance's launch.  ``ref.flash_attention_ref``
is their plain PyTorch version.

:func:`flash_attention` dispatches on the device of its inputs: CPU tensors
take the plain version, CUDA tensors launch the kernel or raise.  It takes
the head dims the kernel is built for (:data:`HEAD_DIMS`);
``ops.flash_attention`` pads any other head dim up to one of them.  Unlike
the Pallas wrapper it needs no sequence length to divide a tile: the kernel
masks the ragged edges itself.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from . import _build
from .ref import flash_attention_ref

# Launches of the CUDA kernel made by flash_attention (never counts the
# plain version).  chip_smoke.py zeroes it before a path and reads it after.
launches = 0

HEAD_DIMS = (64, 128, 256)  # the kernel's instances; ops pads up to one
SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
SM_SMEM = 233472  # an SM's shared memory; each resident block also holds 1 KB of it
MAX_Q_TILES = 65535  # the grid's y extent: query tiles per (batch, head)
TMA_BOX_BYTES = 128  # a TMA box's inner extent under the 128-byte swizzle
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ENCODE_FAILED = 10000  # the C entry's code for a tensor map it could not encode


def plan(dtype: torch.dtype, head_dim: int) -> dict:
    """The launch of the instance for ``dtype`` and ``head_dim``, as
    ``csrc/flash_attention.cu`` makes it: threads and query rows per CTA,
    key rows per kv tile, K/V stages and dynamic shared memory in bytes;
    for bfloat16 also the TMA boxes (hd, heads, S, B) of q and of k/v."""
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head_dim {head_dim} is not one the kernel is built for {HEAD_DIMS}")
    if dtype == torch.float32:  # flash_fwd_simt_f32: Q, K, V (+4 pad) and P tiles
        bq = bk = 64
        return {"threads": 256, "block_q": bq, "block_k": bk, "stages": 1,
                "smem": 4 * (3 * bq * (head_dim + 4) + bq * (bk + 4))}
    if dtype == torch.bfloat16:  # flash_fwd_wgmma_bf16: Q, a ring of K and V, mbarriers
        bq, bk, box = 128, 64, TMA_BOX_BYTES // 2
        stages = {256: 2, 128: 4, 64: 8}[head_dim]
        smem = 1024 + 2 * bq * head_dim + 2 * stages * 2 * bk * head_dim + 8 * (1 + 3 * stages)
        return {"threads": 384, "block_q": bq, "block_k": bk, "stages": stages, "smem": smem,
                "q_box": (box, 1, bq, 1), "kv_box": (box, 1, bk, 1)}
    raise TypeError(f"no flash attention instance for {dtype}")


def smem_bytes(head_dim: int, dtype: torch.dtype = torch.float32) -> int:
    """Dynamic shared memory of one CTA (see csrc/flash_attention.cu)."""
    return plan(dtype, head_dim)["smem"]


def check_tma(t: torch.Tensor) -> None:
    """Raise ValueError where TMA cannot load ``t`` as the bf16 instance's
    (hd, heads, S, B) tensor map: the head dim not contiguous, the stride of
    a dimension it steps (extent > 1) or the start not a multiple of 16 B."""
    strides, item = t.stride(), t.element_size()
    if strides[-1] != 1:
        raise ValueError(f"TMA needs the head dim contiguous, got strides {strides}")
    if any(s * item % 16 for s, n in zip(strides[:-1], t.shape[:-1]) if n > 1):
        raise ValueError(f"TMA needs strides that are multiples of 16 bytes, got "
                         f"{tuple(s * item for s in strides[:-1])} B")
    if t.data_ptr() % 16:
        raise ValueError("TMA needs q, k and v to start on a 16-byte boundary")


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("flash_attention").flash_attention_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i, f, f, i, p]
    fn.restype = i
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise TypeError(f"q, k, v must be 4-D (B, S, heads, head_dim), got "
                        f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k, v must share one dtype of float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, _, H, hd = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != hd:
        raise ValueError(f"k and v must be (B, Sk, KV, {hd}) with B={B}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    KV = k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"query heads {H} must be a multiple of kv heads {KV}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head_dim {hd} is not one the kernel is built for {HEAD_DIMS}; "
                         f"ops.flash_attention pads to one")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must lie on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if -(-q.shape[1] // plan(q.dtype, hd)["block_q"]) > MAX_Q_TILES:
        raise ValueError(f"Sq {q.shape[1]} needs more than {MAX_Q_TILES} query tiles")


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, hd)
    k: torch.Tensor,  # (B, Sk, KV, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    cap: float = 0.0,
    scale: Optional[float] = None,
    kv_len: Optional[int] = None,
) -> torch.Tensor:
    """-> (B, Sq, H, hd) in q's dtype; running (m, l, acc) in float32."""
    _check(q, k, v)
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kv_len = Sk if kv_len is None else int(kv_len)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap,
                                   scale=scale, kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    if q.dtype == torch.bfloat16:  # the tensor-core instance loads through TMA
        for t in (q, k, v):
            check_tma(t)
    elif any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k and v must start on a 16-byte boundary")

    global launches
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk, H, KV, hd,
            _DTYPES[q.dtype], int(bool(causal)), int(window), float(cap), float(scale),
            max(kv_len, 0))
    with torch.cuda.device(q.device):
        err = _launcher()(*args, torch.cuda.current_stream().cuda_stream)
    if err >= _ENCODE_FAILED:
        raise RuntimeError(f"flash attention: cuTensorMapEncodeTiled failed with CUresult "
                           f"{err - _ENCODE_FAILED}")
    if err:
        raise RuntimeError(f"flash attention kernel launch failed with CUDA error {err}")
    launches += 1
    return out
