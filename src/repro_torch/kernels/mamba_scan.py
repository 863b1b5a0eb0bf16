"""Mamba-1 selective scan (the sequential hot loop of the SSM mixer) as a Hopper kernel.

The CUDA kernel in ``csrc/mamba_scan.cu`` replaces the Pallas TPU kernel
``repro/kernels/mamba_scan.py:_scan_kernel``; its source note gives the
bound and the design.  ``ref.mamba_scan_ref`` is its plain PyTorch version.

Inputs are the precomputed scan elements (``models.mamba.mamba_prefill``
builds them from the conv and projection outputs):
    a (B, S, di, st)   decay   exp(Δt·A)
    b (B, S, di, st)   drive   Δt·B_t·x_t
    C (B, S, st)       readout
Outputs: y (B, S, di) with y_t = C_t·h_t, and h_last (B, di, st).

:func:`mamba_scan` dispatches on the device of its inputs: CPU tensors take
the plain version, CUDA tensors launch the kernel or raise.  Unlike the
Pallas wrapper it needs neither di nor S to divide a tile: the kernel masks
the ragged edges itself.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from .ref import mamba_scan_ref

# Launches of the CUDA kernel made by mamba_scan (never counts the plain
# version).  chip_smoke.py zeroes it before a path and reads it after.
launches = 0

MAX_STATE = 32  # d_state the kernel takes: its state lanes are one warp at most
MAX_BATCH = 65535  # the grid's y extent


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("mamba_scan").mamba_scan_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, i, i, i, i, p]
    fn.restype = i
    return fn


def _check(a: torch.Tensor, b: torch.Tensor, C: torch.Tensor) -> None:
    if a.dim() != 4 or C.dim() != 3:
        raise TypeError(f"a and b must be 4-D (B, S, di, st) and C 3-D (B, S, st), got "
                        f"{tuple(a.shape)}, {tuple(b.shape)}, {tuple(C.shape)}")
    if not (a.dtype == b.dtype == C.dtype == torch.float32):
        raise TypeError(f"a, b and C must be float32, got {a.dtype}, {b.dtype}, {C.dtype}")
    B, S, _, st = a.shape
    if b.shape != a.shape or tuple(C.shape) != (B, S, st):
        raise ValueError(f"b must be {tuple(a.shape)} and C {(B, S, st)}, got "
                         f"{tuple(b.shape)} and {tuple(C.shape)}")
    if not 1 <= st <= MAX_STATE:
        raise ValueError(f"d_state {st} is outside the kernel's 1..{MAX_STATE}")
    if B > MAX_BATCH:
        raise ValueError(f"batch {B} exceeds the kernel's grid, {MAX_BATCH}")
    if not (a.device == b.device == C.device):
        raise ValueError("a, b and C must lie on one device")
    if not (a.is_contiguous() and b.is_contiguous() and C.is_contiguous()):
        raise ValueError("a, b and C must be contiguous")


def mamba_scan(
    a: torch.Tensor,  # (B, S, di, st) float32
    b: torch.Tensor,
    C: torch.Tensor,  # (B, S, st) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (y (B, S, di), h_last (B, di, st)), float32, from h_0 = 0."""
    _check(a, b, C)
    if a.device.type == "cpu":
        return mamba_scan_ref(a, b, C)
    if a.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on cuda or cpu, not {a.device}")

    global launches
    B, S, di, st = a.shape
    y = torch.empty((B, S, di), dtype=torch.float32, device=a.device)
    h_last = torch.empty((B, di, st), dtype=torch.float32, device=a.device)
    if B == 0 or di == 0:
        return y, h_last
    args = (a.data_ptr(), b.data_ptr(), C.data_ptr(), y.data_ptr(), h_last.data_ptr(),
            B, S, di, st)
    with torch.cuda.device(a.device):
        err = _launcher()(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"mamba scan kernel launch failed with CUDA error {err}")
    launches += 1
    return y, h_last
