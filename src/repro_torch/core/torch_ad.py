"""On-device distributed anomaly detection — Chimbuko's PS as collectives.

The PyTorch twin of ``repro.core.jax_ad``.  Each process is an on-node AD
module, and the parameter-server merge of per-function moments is a few
all-reduces over a ``torch.distributed`` process group — Pébay's
parallel-moment formulas are exactly an all-reduce of sufficient statistics:

    n      = Σ_k n_k                              (all-reduce SUM 1)
    μ      = Σ_k n_k μ_k / n                      (all-reduce SUM 1)
    M2     = Σ_k [ M2_k + n_k (μ_k − μ)² ]        (all-reduce SUM 2, needs μ)
    min, max                                      (all-reduce MAX of −min, max)

Per-process event batches never leave the card; only (F, 5) statistic
tables cross the interconnect.

Device tables are (F, 5) float32: [n, mean, M2, min, max].  Events are
(fids int32, durations float32); fid < 0 marks padding.  Functions that take
tensors run where those tensors lie; :func:`init_table` runs on ``cuda:0``
unless the caller names a device.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.distributed as dist

from ..device import resolve

N, MEAN, M2, MIN, MAX = range(5)
NCOLS = 5
DEFAULT_ALPHA = 6.0

Step = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def init_table(num_funcs: int, *, device=None, dtype=torch.float32) -> torch.Tensor:
    t = torch.zeros((num_funcs, NCOLS), dtype=dtype, device=resolve(device))
    t[:, MIN] = float("inf")
    t[:, MAX] = float("-inf")
    return t


def batch_table(fids: torch.Tensor, durs: torch.Tensor, num_funcs: int) -> torch.Tensor:
    """Exact per-fid batch moments via segment reductions (ref for the kernel)."""
    valid = fids >= 0
    w = valid.to(torch.float32)
    seg = fids.long().clamp(0, num_funcs - 1)
    x = durs.to(torch.float32)
    zeros = torch.zeros(num_funcs, dtype=torch.float32, device=x.device)
    n = zeros.index_add(0, seg, w)
    s = zeros.index_add(0, seg, w * x)
    mean = torch.where(n > 0, s / n.clamp(min=1.0), 0.0)
    d = x - mean[seg]
    m2 = zeros.index_add(0, seg, w * d * d)
    inf = float("inf")
    mn = torch.full_like(zeros, inf).scatter_reduce(0, seg, torch.where(valid, x, inf), "amin")
    mx = torch.full_like(zeros, -inf).scatter_reduce(0, seg, torch.where(valid, x, -inf), "amax")
    return torch.stack([n, mean, m2, mn, mx], dim=-1)


def merge_tables(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise Pébay merge of two (F, 5) tables (exact, assoc/comm)."""
    na, nb = a[:, N], b[:, N]
    n = na + nb
    safe = n.clamp(min=1.0)
    delta = b[:, MEAN] - a[:, MEAN]
    mean = a[:, MEAN] + delta * nb / safe
    m2 = a[:, M2] + b[:, M2] + delta * delta * na * nb / safe
    mn = torch.minimum(a[:, MIN], b[:, MIN])
    mx = torch.maximum(a[:, MAX], b[:, MAX])
    seen = n > 0
    return torch.stack(
        [n, torch.where(seen, mean, 0.0), torch.where(seen, m2, 0.0), mn, mx], dim=-1
    )


def label_events(
    table: torch.Tensor,
    fids: torch.Tensor,
    durs: torch.Tensor,
    alpha: float = DEFAULT_ALPHA,
    min_count: float = 10.0,
) -> torch.Tensor:
    """SSTD labels (int8) for events against a stats table."""
    seg = fids.long().clamp(0, table.shape[0] - 1)
    n = table[seg, N]
    mu = table[seg, MEAN]
    var = torch.where(n > 1, table[seg, M2] / n.clamp(min=1.0), 0.0)
    sd = torch.sqrt(var.clamp(min=0.0))
    x = durs.to(torch.float32)
    out = ((x > mu + alpha * sd) | (x < mu - alpha * sd)) & (n >= min_count) & (fids >= 0)
    return out.to(torch.int8)


def ad_step(
    table: torch.Tensor,
    fids: torch.Tensor,
    durs: torch.Tensor,
    alpha: float = DEFAULT_ALPHA,
    min_count: float = 10.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-instance AD step: label against current table, then update."""
    labels = label_events(table, fids, durs, alpha, min_count)
    new_table = merge_tables(table, batch_table(fids, durs, table.shape[0]))
    return new_table, labels


def _merge_across(local: torch.Tensor, group) -> torch.Tensor:
    """Multi-way Pébay merge across ``group``: 2 SUM all-reduces + 1 MAX."""
    n_l, mu_l, m2_l = local[:, N], local[:, MEAN], local[:, M2]
    sums = torch.stack([n_l, n_l * mu_l])
    dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=group)
    n_g, s_g = sums[0], sums[1]
    mu_g = torch.where(n_g > 0, s_g / n_g.clamp(min=1.0), 0.0)
    m2_g = m2_l + n_l * (mu_l - mu_g) ** 2
    dist.all_reduce(m2_g, op=dist.ReduceOp.SUM, group=group)
    # min = −max(−min): one MAX all-reduce carries both extremes exactly.
    ext = torch.stack([-local[:, MIN], local[:, MAX]])
    dist.all_reduce(ext, op=dist.ReduceOp.MAX, group=group)
    return torch.stack([n_g, mu_g, m2_g, -ext[0], ext[1]], dim=-1)


def make_distributed_ad_step(
    rank_group,
    func_group=None,
    *,
    alpha: float = DEFAULT_ALPHA,
    min_count: float = 10.0,
    use_kernel: bool = False,
) -> Step:
    """Build the cluster-wide AD step: events spread over ``rank_group``.

    Args to the returned fn, on this process:
      table: (F, 5) global table — a full replica when ``func_group`` is
             None, else this member's block of Fs rows (F divisible by the
             ``func_group`` size; see :func:`padded_num_funcs`)
      fids:  (R_local, E) int32, this process's share of the events
      durs:  (R_local, E) float32, likewise
    Returns (new_table, labels shaped like fids).

    ``func_group`` mirrors the host-side PS federation (core/ps.py): member
    ``i`` of ``func_group`` owns the contiguous fid block [i·Fs, (i+1)·Fs),
    merges only its own rows across ``rank_group``, and labels only the
    events it owns; an int32 SUM over ``func_group`` reassembles complete
    labels.  Every member of one ``func_group`` must hold the same events.
    ``use_kernel`` runs the local reduction through the moments kernel
    (``kernels.ops.moments_table``).
    """
    if use_kernel:
        from ..kernels import ops as _kops

        _batch = _kops.moments_table
    else:
        _batch = batch_table

    if func_group is None:

        def step(table, fids, durs):
            f = fids.reshape(-1)
            d = durs.reshape(-1)
            labels = label_events(table, f, d, alpha, min_count).reshape(fids.shape)
            local = _batch(f, d, table.shape[0])
            return merge_tables(table, _merge_across(local, rank_group)), labels

        return step

    shard = dist.get_rank(func_group)
    if shard < 0:
        raise ValueError("this process is not a member of func_group")

    def step(table, fids, durs):
        Fs = table.shape[0]  # this member's contiguous block of fids
        base = shard * Fs
        f = fids.reshape(-1)
        d = durs.reshape(-1)
        # Rebase into block-local rows; events owned elsewhere become padding.
        f_local = torch.where((f >= base) & (f < base + Fs), f - base, -1)
        owned = label_events(table, f_local, d, alpha, min_count).to(torch.int32)
        # Each event is owned by exactly one member — summing the per-member
        # label vectors reassembles the full labeling.
        dist.all_reduce(owned, op=dist.ReduceOp.SUM, group=func_group)
        labels = owned.to(torch.int8).reshape(fids.shape)
        local = _batch(f_local, d, Fs)
        return merge_tables(table, _merge_across(local, rank_group)), labels

    return step


def padded_num_funcs(num_funcs: int, num_shards: int) -> int:
    """Smallest F' >= num_funcs divisible by the func_group size."""
    return -(-num_funcs // num_shards) * num_shards


def straggler_scores(step_times: torch.Tensor, alpha: float = 3.0) -> torch.Tensor:
    """Per-rank straggler z-scores from one step's (R,) phase times.

    Used by the training monitor: ranks whose step time exceeds μ + ασ are
    flagged for mitigation (the workflow-level use of the paper's detector).
    """
    mu = step_times.mean()
    sd = step_times.std(correction=0).clamp(min=1e-9)
    return (step_times - mu) / sd
