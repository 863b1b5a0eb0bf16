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
from typing import Dict, Tuple

import torch

from . import _build
from .ref import moments_and_labels_ref

# Launches of the CUDA kernel made by moments_and_labels (never counts the
# plain version).  chip_smoke.py zeroes it before a path and reads it after.
launches = 0

SMEM_LIMIT = 232448  # bytes of shared memory one block may use on sm_90
CLUSTER = 8  # CTAs per cluster (csrc/moments.cu kCluster)
MAX_CTAS = 128  # fixed, so the sum order depends on N alone (csrc/moments.cu kMaxCtas)

# {(device index, raw stream): (tickets (CLUSTER,) int32, cluster partials
# float32)}: the kernel's scratch, made once per stream (the tickets by
# torch.zeros; the kernel leaves them 0) and grown when a call needs more
# partials.  A stream captured into a CUDA graph takes its scratch from a
# call made before the capture.
_workspaces: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def smem_bytes(num_funcs: int, block_events: int) -> int:
    """Dynamic shared memory of one CTA (see csrc/moments.cu)."""
    return num_funcs * 20 + block_events * 24 + 8 * 32 * 4


def grid(n: int, block_events: int) -> Tuple[int, int, int, int]:
    """(events per chunk, chunks, CTAs, cluster partials) for a stream of
    ``n`` events: CTAs is a multiple of CLUSTER of at most MAX_CTAS, and each
    cluster of CLUSTER CTAs leaves one partial table."""
    eb = min(block_events, max(n, 1))
    chunks = max(1, -(-n // eb))
    ctas = min(-(-chunks // CLUSTER) * CLUSTER, MAX_CTAS)
    return eb, chunks, ctas, ctas // CLUSTER


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("moments").moments_and_labels_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_longlong, i, i, i, i, i,
                   ctypes.c_float, ctypes.c_float, p]
    fn.restype = i
    return fn


def _workspace(index: int, stream: int, device, floats: int):
    """This stream's (tickets, partials), the partials at least ``floats`` long."""
    ws = _workspaces.get((index, stream))
    if ws is None or ws[1].numel() < floats:
        tickets = (torch.zeros(CLUSTER, dtype=torch.int32, device=device) if ws is None
                   else ws[0])
        ws = _workspaces[(index, stream)] = (
            tickets, torch.empty(floats, dtype=torch.float32, device=device))
    return ws


def _check(fids: torch.Tensor, durs: torch.Tensor, table_sums: torch.Tensor,
           block_events: int):
    """-> (device, N, F) of valid inputs; raises on what the kernel does not take."""
    fshape, dshape, tshape = fids.shape, durs.shape, table_sums.shape
    if fids.dtype != torch.int32 or len(fshape) != 1:
        raise TypeError(f"fids must be a 1-D int32 tensor, got {fids.dtype} {tuple(fshape)}")
    if durs.dtype != torch.float32 or dshape != fshape:
        raise TypeError(f"durs must be float32 of shape {tuple(fshape)}, "
                        f"got {durs.dtype} {tuple(dshape)}")
    if table_sums.dtype != torch.float32 or len(tshape) != 2 or tshape[1] != 5:
        raise TypeError(f"table_sums must be (F, 5) float32, got {table_sums.dtype} "
                        f"{tuple(tshape)}")
    dev = fids.device
    if durs.device != dev or table_sums.device != dev:
        raise ValueError("fids, durs and table_sums must lie on one device")
    if not (fids.is_contiguous() and durs.is_contiguous() and table_sums.is_contiguous()):
        raise ValueError("fids, durs and table_sums must be contiguous")
    n, F = fshape[0], tshape[0]
    if F < 1:
        raise ValueError("table_sums needs at least one row")
    if block_events < 1:
        raise ValueError("block_events must be positive")
    return dev, n, F


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
    dev, n, F = _check(fids, durs, table_sums, block_events)
    if dev.type != "cuda":
        if dev.type == "cpu":
            return moments_and_labels_ref(fids, durs, table_sums, alpha, min_count, fid_offset)
        raise ValueError(f"moments_and_labels runs on cuda or cpu, not {dev}")
    if smem_bytes(F, min(block_events, max(n, 1))) > SMEM_LIMIT:  # the card's limit only
        raise ValueError(f"F={F} with block_events={block_events} exceeds a block's "
                         f"{SMEM_LIMIT} bytes of shared memory")
    if dev.index != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return _launch(fids, durs, table_sums, dev, n, F, alpha, min_count,
                           block_events, fid_offset)
    return _launch(fids, durs, table_sums, dev, n, F, alpha, min_count, block_events,
                   fid_offset)


def _launch(fids, durs, table_sums, dev, n, F, alpha, min_count, block_events, fid_offset):
    """One launch on the current stream of ``dev``, the current device."""
    global launches
    eb, chunks, ctas, clusters = grid(n, block_events)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    tickets, partials = _workspace(dev.index, stream, dev, clusters * 5 * F)
    delta = torch.empty((F, 5), dtype=torch.float32, device=dev)
    labels = torch.empty((n,), dtype=torch.int8, device=dev)
    err = _launcher()(fids.data_ptr(), durs.data_ptr(), table_sums.data_ptr(),
                      delta.data_ptr(), labels.data_ptr(), partials.data_ptr(),
                      tickets.data_ptr(), n, F, fid_offset, eb, chunks, ctas, alpha,
                      min_count, stream)
    if err:
        raise RuntimeError(f"moments kernel launch failed with CUDA error {err}")
    launches += 1
    return delta, labels
