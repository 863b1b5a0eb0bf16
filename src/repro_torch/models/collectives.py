"""The model's collectives over one mesh dim, with and without autograd.

JAX differentiates through ``shard_map``'s collectives by their
transposes; the port writes them down.  Where a gradient is taken (grad
mode on and the input requires one) each call returns a new tensor whose
backward is the transpose:

  * :func:`all_gather`: every rank's tensor in rank order; the backward
    sums each output's gradient over the ranks and keeps the rank's own
    (a reduce-scatter: NCCL's, or an all-reduce and a slice where the
    backend has none, as gloo);
  * :func:`all_reduce` (a sum): the backward all-reduces the gradient.

Without a gradient they are the forward-only calls the serving path has
always made: ``dist.all_gather`` into a list, and ``dist.all_reduce`` in
place.  Both run the same collectives on every rank in the same order,
as SPMD needs: whether a gradient is taken depends on the graph, which
every rank builds alike.

Placed parameters (DTensors, ``launch.sharding.place``) are gathered where
they are used (:func:`gathered`): DTensor's ``redistribute`` to the whole
leaf, then ``to_local`` with ``Partial`` gradient placements, so that the
backward sums every rank's gradient and reduces it to the leaf's own
placement: a reduce-scatter over the mesh dims that shard it, an
all-reduce over those that replicate it.  That sum is the leaf's gradient
when each rank's loss is its share of the global loss
(``model.loss_and_metrics``).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def _wants_grad(t: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and t.requires_grad


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return tuple(_gather(t, group))

    @staticmethod
    def backward(ctx, *grads):
        stacked = torch.stack(grads)  # contiguous, whatever the grads' strides
        if dist.get_backend(ctx.group) == dist.Backend.NCCL:
            own = torch.empty(grads[0].shape, dtype=stacked.dtype, device=stacked.device)
            dist.reduce_scatter_tensor(own, stacked, group=ctx.group)
            return own, None
        dist.all_reduce(stacked, group=ctx.group)
        return stacked[dist.get_rank(ctx.group)].clone(), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    # contiguous buffers: a collective writes them in order, and empty_like
    # would keep a permuted tensor's strides
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return out


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's ``t`` over ``group``, in rank order."""
    if _wants_grad(t):
        return list(_AllGather.apply(t, group))
    return _gather(t, group)


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``: in place without a gradient, a new
    tensor with one."""
    if _wants_grad(t):
        return _AllReduce.apply(t, group)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def gathered(p: torch.Tensor, keep: Optional[int] = None, dtype=None) -> torch.Tensor:
    """A plain tensor to compute with in ``dtype`` (None: ``p``'s own).
    A DTensor is gathered to the whole leaf, except that the mesh dim
    ``keep`` keeps its shard (the expert leaves under expert parallelism
    keep the rank's experts); it moves, and its gradient is summed, in the
    wider of its dtype and ``dtype``, and is cast to ``dtype`` after: a
    bf16 leaf computed in float32 has its gradient summed over the ranks
    in float32 and rounded once, as one device rounds it."""
    if not isinstance(p, DTensor):
        return p if dtype is None else p.to(dtype)
    dtype = p.dtype if dtype is None else dtype
    p = p.to(torch.promote_types(p.dtype, dtype))
    kept = [d == keep and pl.is_shard() for d, pl in enumerate(p.placements)]
    target = [pl if k else Replicate() for pl, k in zip(p.placements, kept)]
    grads = [pl if k else Partial() for pl, k in zip(p.placements, kept)]
    return p.redistribute(p.device_mesh, target).to_local(grad_placements=grads).to(dtype)


def _shifted(placements: Sequence) -> tuple:
    """Placements of a slice along dim 0 (which no placement shards)."""
    if any(pl.is_shard(0) for pl in placements):
        raise ValueError(f"placements {tuple(placements)} shard the stacked (periods) dim")
    return tuple(Shard(pl.dim - 1) if pl.is_shard() else pl for pl in placements)


def unbind(p: torch.Tensor) -> Sequence[torch.Tensor]:
    """``p.unbind(0)``: for a DTensor, its local block unbound and each
    slice a DTensor again (no collective), so autograd stacks the leaf's
    gradient once."""
    if not isinstance(p, DTensor):
        return p.unbind(0)
    pl = _shifted(p.placements)
    return [DTensor.from_local(t, p.device_mesh, pl, run_check=False)
            for t in p.to_local().unbind(0)]
