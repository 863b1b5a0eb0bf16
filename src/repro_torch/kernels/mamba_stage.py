"""Mamba-1 scan elements a = exp(Δt·A) and b = (Δt·x)·B, staged in one pass on Hopper.

The CUDA kernel in ``csrc/mamba_stage.cu`` writes the float32 (B, S, di, st)
tensors that ``ops.mamba_scan`` reads; its source note gives the bound and
the design.  It replaces no Pallas kernel: the JAX package builds a and b op
by op.  ``ref.mamba_stage_ref`` is its plain PyTorch version, bit for bit.

Inputs:
    dt (B, S, di)   softplus Δt, compute dtype (bf16 or float32)
    x  (B, S, di)   post-conv activations, compute dtype
    Bm (B, S, st)   input projection, compute dtype
    A  (di, st)     float32
Outputs: a and b (B, S, di, st) float32, contiguous.

:func:`mamba_stage` dispatches on the device of its inputs: CPU tensors take
the plain version, CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from .ref import mamba_stage_ref

# Launches of the CUDA kernel made by mamba_stage (never counts the plain
# version).  chip_smoke.py zeroes it before a path and reads it after.
launches = 0

MAX_STATE = 32  # d_state the scan that reads a and b takes
DTYPES = (torch.bfloat16, torch.float32)  # compute dtypes: dt·x is rounded to them
MAX_SLAB = 2**30  # di·st: the kernel indexes one token's slab in 32 bits, with headroom


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("mamba_stage").mamba_stage_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, p]
    fn.restype = i
    return fn


def _check(dt: torch.Tensor, x: torch.Tensor, Bm: torch.Tensor, A: torch.Tensor) -> None:
    if dt.dim() != 3 or x.dim() != 3 or Bm.dim() != 3 or A.dim() != 2:
        raise TypeError(f"dt and x must be 3-D (B, S, di), Bm 3-D (B, S, st) and A 2-D "
                        f"(di, st), got {tuple(dt.shape)}, {tuple(x.shape)}, "
                        f"{tuple(Bm.shape)}, {tuple(A.shape)}")
    if not (dt.dtype == x.dtype == Bm.dtype and dt.dtype in DTYPES) or A.dtype != torch.float32:
        raise TypeError(f"dt, x and Bm must share bfloat16 or float32 and A must be float32, "
                        f"got {dt.dtype}, {x.dtype}, {Bm.dtype}, {A.dtype}")
    B, S, di = dt.shape
    st = A.shape[1]
    if x.shape != dt.shape or tuple(Bm.shape) != (B, S, st) or A.shape[0] != di:
        raise ValueError(f"x must be {tuple(dt.shape)}, Bm {(B, S, st)} and A ({di}, {st}), "
                         f"got {tuple(x.shape)}, {tuple(Bm.shape)} and {tuple(A.shape)}")
    if not 1 <= st <= MAX_STATE:
        raise ValueError(f"d_state {st} is outside the kernel's 1..{MAX_STATE}")
    if di * st > MAX_SLAB:
        raise ValueError(f"d_inner x d_state {di * st} exceeds the kernel's {MAX_SLAB}")
    if not (dt.device == x.device == Bm.device == A.device):
        raise ValueError("dt, x, Bm and A must lie on one device")
    if not all(t.is_contiguous() for t in (dt, x, Bm, A)):
        raise ValueError("dt, x, Bm and A must be contiguous")


def mamba_stage(
    dt: torch.Tensor,  # (B, S, di) compute dtype
    x: torch.Tensor,  # (B, S, di) compute dtype
    Bm: torch.Tensor,  # (B, S, st) compute dtype
    A: torch.Tensor,  # (di, st) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (a, b), each (B, S, di, st) float32."""
    _check(dt, x, Bm, A)
    if dt.device.type == "cpu":
        return mamba_stage_ref(dt, x, Bm, A)
    if dt.device.type != "cuda":
        raise ValueError(f"mamba_stage runs on cuda or cpu, not {dt.device}")

    global launches
    B, S, di = dt.shape
    st = A.shape[1]
    a = torch.empty((B, S, di, st), dtype=torch.float32, device=dt.device)
    b = torch.empty_like(a)
    if a.numel() == 0:
        return a, b
    args = (dt.data_ptr(), x.data_ptr(), Bm.data_ptr(), A.data_ptr(), a.data_ptr(), b.data_ptr(),
            B * S, di, st, int(dt.dtype == torch.bfloat16))
    with torch.cuda.device(dt.device):
        err = _launcher()(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mamba stage kernel launch failed with CUDA error {err}")
    launches += 1
    return a, b
