"""Chimbuko's AD hot loop (per-function moments + labels) as a Hopper kernel.

The paper's on-node AD module folds each trace frame into per-function
runtime statistics and labels events against μ±ασ (§III-B1).  The CUDA
kernel in ``csrc/moments.cu`` replaces the Pallas TPU kernel
``repro/kernels/moments.py:_moments_kernel``; its source note gives the
bound and the design.  ``ref.moments_and_labels_ref`` is its plain PyTorch
version.

:func:`moments_and_labels` dispatches on the device of its inputs: CPU
tensors take the plain version, CUDA tensors launch the kernel or raise.
The kernel's sums are taken in a fixed order, so repeated launches on the
same input give bitwise-equal deltas.

Padding: fid < 0 marks padding (weight 0, label 0).  Events past the end of
the stream are handled the same way inside the kernel, so no padded copy of
the inputs is made.

Federation: PS shards own contiguous fid blocks [offset, offset + F).
``fid_offset`` rebases global fids into shard-local rows inside the kernel;
events outside the block are masked out like padding, so a shard's delta
covers only the rows it owns.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from .ref import moments_and_labels_ref

# Launches of the CUDA kernel made by moments_and_labels (never counts the
# plain version).  chip_smoke.py zeroes it before a path and reads it after.
launches = 0

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
MAX_PARTIALS = 256  # CTAs of pass 1: fixed, so the sum order depends on N alone


def smem_bytes(num_funcs: int, block_events: int) -> int:
    """Dynamic shared memory of pass 1 (see csrc/moments.cu)."""
    return num_funcs * 20 + block_events * 24 + 8 * 32 * 4


def grid(n: int, block_events: int) -> Tuple[int, int, int]:
    """(events per chunk, chunks, pass-1 CTAs) for a stream of ``n`` events."""
    eb = min(block_events, max(n, 1))
    chunks = max(1, -(-n // eb))
    return eb, chunks, min(chunks, MAX_PARTIALS)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("moments").moments_and_labels_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i,
                   ctypes.c_float, ctypes.c_float, p]
    fn.restype = i
    return fn


def _check(fids: torch.Tensor, durs: torch.Tensor, table_sums: torch.Tensor,
           block_events: int) -> None:
    if fids.dim() != 1 or fids.dtype != torch.int32:
        raise TypeError(f"fids must be a 1-D int32 tensor, got {fids.dtype} {tuple(fids.shape)}")
    if durs.dtype != torch.float32 or durs.shape != fids.shape:
        raise TypeError(f"durs must be float32 of shape {tuple(fids.shape)}, "
                        f"got {durs.dtype} {tuple(durs.shape)}")
    if table_sums.dtype != torch.float32 or table_sums.dim() != 2 or table_sums.shape[1] != 5:
        raise TypeError(f"table_sums must be (F, 5) float32, got {table_sums.dtype} "
                        f"{tuple(table_sums.shape)}")
    if not (fids.device == durs.device == table_sums.device):
        raise ValueError("fids, durs and table_sums must lie on one device")
    if not (fids.is_contiguous() and durs.is_contiguous() and table_sums.is_contiguous()):
        raise ValueError("fids, durs and table_sums must be contiguous")
    F = table_sums.shape[0]
    if F < 1:
        raise ValueError("table_sums needs at least one row")
    if block_events < 1:
        raise ValueError("block_events must be positive")
    if smem_bytes(F, min(block_events, max(fids.shape[0], 1))) > SMEM_LIMIT:
        raise ValueError(f"F={F} with block_events={block_events} exceeds a block's "
                         f"{SMEM_LIMIT} bytes of shared memory")


def moments_and_labels(
    fids: torch.Tensor,
    durs: torch.Tensor,
    table_sums: torch.Tensor,
    *,
    alpha: float = 6.0,
    min_count: float = 10.0,
    block_events: int = 512,
    fid_offset: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (delta table (F,5) [n,Σx,Σx²,min,max], labels (N,) int8).

    ``table_sums`` is the previous global table in raw-sums format.
    ``fid_offset`` rebases global fids: the delta covers the contiguous
    shard block [fid_offset, fid_offset + F); other events are masked.
    """
    _check(fids, durs, table_sums, block_events)
    if fids.device.type == "cpu":
        return moments_and_labels_ref(fids, durs, table_sums, alpha, min_count, fid_offset)
    if fids.device.type != "cuda":
        raise ValueError(f"moments_and_labels runs on cuda or cpu, not {fids.device}")

    global launches
    n, F = fids.shape[0], table_sums.shape[0]
    eb, chunks, ctas = grid(n, block_events)
    dev = fids.device
    delta = torch.empty((F, 5), dtype=torch.float32, device=dev)
    labels = torch.empty((n,), dtype=torch.int8, device=dev)
    partials = torch.empty((ctas, 5, F), dtype=torch.float32, device=dev)
    args = (fids.data_ptr(), durs.data_ptr(), table_sums.data_ptr(),
            delta.data_ptr(), labels.data_ptr(), partials.data_ptr(),
            n, F, fid_offset, eb, chunks, ctas, alpha, min_count)
    with torch.cuda.device(dev):
        err = _launcher()(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"moments kernel launch failed with CUDA error {err}")
    launches += 1
    return delta, labels
