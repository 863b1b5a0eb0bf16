"""Gradient compression: int8 block quantisation with error feedback
(port of ``repro.optim.compression``).

Gradients are quantised to int8 with a float32 scale per block of
``BLOCK`` elements; the quantisation error is fed back into the next
step's gradient (error feedback keeps convergence, Karimireddy et al.
2019).  :func:`compressed_psum` all-reduces the dequantised float32
values, exactly as JAX's ``psum`` of ``local`` does
(``repro/optim/compression.py:56-59``): the values are those of an int8
exchange, the bytes on the wire are float32.

Used by the data-parallel step (``launch.steps.make_dp_train_step``).
``torch.round`` rounds half to even, as ``jnp.round`` does, and a
subnormal scale is flushed to zero, as XLA flushes it, so codes and scales
equal JAX's bit for bit.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .. import tree as T

BLOCK = 256


def _blockify(x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    pad = (-n) % BLOCK
    flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), n, pad


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 codes (nb, BLOCK), float32 scales (nb, 1)). Symmetric per block."""
    blocks, _, _ = _blockify(x)
    # divided by a tensor on the blocks' device: CUDA divides by a Python
    # scalar as a multiply by its reciprocal, an ulp off the true quotient
    # that JAX and the CPU compute
    scale = blocks.abs().amax(dim=1, keepdim=True) / torch.full((), 127.0,
                                                                device=blocks.device)
    # XLA (CPU and TPU) flushes float32 subnormals to zero; a scale that
    # small codes every element of its block as 0 either way
    scale = torch.where(scale < torch.finfo(torch.float32).tiny, 0.0, scale)
    codes = torch.clamp(torch.round(blocks / torch.clamp(scale, min=1e-12)), -127, 127)
    return codes.to(torch.int8), scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    flat = (codes.to(torch.float32) * scale).reshape(-1)[:n]
    return flat.reshape(shape)


def compressed_psum(g: torch.Tensor, group, error: torch.Tensor):
    """Mean over ``group`` of int8(g + error), dequantised; -> (mean_g, new_error).

    ``error`` is this rank's residual from the last step and stays on this
    rank.  One all-reduce of the float32 dequantised gradient (JAX psums
    the same values), divided by the group's size.
    """
    target = g.to(torch.float32) + error
    codes, scale = quantize(target)
    local = dequantize(codes, scale, tuple(g.shape))
    new_error = target - local  # residual stays on this rank (error feedback)
    dist.all_reduce(local, group=group)
    n = torch.full((), float(dist.get_world_size(group)), device=local.device)
    return local / n, new_error  # a tensor divisor: a true quotient on CUDA too


def init_error_state(params) -> Any:
    return T.map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
