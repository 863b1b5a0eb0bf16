"""One-pass parallel statistical moments (Pébay 2008, paper ref [14]).

A copy of ``repro.core.stats``: the port keeps its own so that it imports
nothing of ``repro``.  Its float64 ``StatsTable`` is the independent host
oracle that the device path is held against.

The on-node AD modules maintain per-function runtime statistics locally and
merge them with the parameter server's global view *without* replaying data.
Pébay's pairwise update formulas make the merge exact, associative, and
commutative — which is what lets the paper run with "no synchronization
barriers": any interleaving of merges yields the same global moments.

Two implementations:
  * ``RunningStats``  — scalar, readable, used for bookkeeping and as the
    oracle in property tests.
  * ``StatsTable``    — vectorized over function ids (the production path of
    the on-node AD module); one row per fid, columns (n, mean, M2, M3, M4,
    min, max).

``merge_moments`` is the vectorized pairwise merge; it is also the exact
computation that ``repro_torch.core.torch_ad`` expresses with all-reduces
over a process group, and that ``repro_torch.kernels.moments`` partially
evaluates in raw-sums form on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

# Column indices of a stats table.
N, MEAN, M2, M3, M4, MIN, MAX = range(7)
NCOLS = 7


def empty_table(num_funcs: int) -> np.ndarray:
    t = np.zeros((num_funcs, NCOLS), dtype=np.float64)
    t[:, MIN] = np.inf
    t[:, MAX] = -np.inf
    return t


def pad_table(table: np.ndarray, num_funcs: int) -> np.ndarray:
    """Return ``table`` extended with empty rows up to ``num_funcs``.

    Returns the input unchanged (no copy) when it is already big enough.
    """
    if table.shape[0] >= num_funcs:
        return table
    t = empty_table(num_funcs)
    t[: table.shape[0]] = table
    return t


def batch_moments(values: np.ndarray) -> np.ndarray:
    """Exact (1, 7) moment row for a batch of values."""
    row = empty_table(1)[0]
    if values.size == 0:
        return row
    x = values.astype(np.float64)
    mean = x.mean()
    d = x - mean
    row[N] = x.size
    row[MEAN] = mean
    row[M2] = float((d**2).sum())
    row[M3] = float((d**3).sum())
    row[M4] = float((d**4).sum())
    row[MIN] = float(x.min())
    row[MAX] = float(x.max())
    return row


def merge_moments(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise Pébay merge of two (..., 7) moment tables. Exact, assoc/comm.

    Formulas (Pébay 2008, eqs. 2.1/3.1): with δ = μ_b − μ_a, n = n_a + n_b:
      μ  = μ_a + δ n_b / n
      M2 = M2a + M2b + δ² n_a n_b / n
      M3 = M3a + M3b + δ³ n_a n_b (n_a − n_b) / n² + 3δ (n_a M2b − n_b M2a)/n
      M4 = M4a + M4b + δ⁴ n_a n_b (n_a² − n_a n_b + n_b²)/n³
           + 6δ² (n_a² M2b + n_b² M2a)/n² + 4δ (n_a M3b − n_b M3a)/n
    """
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    out = np.empty(np.broadcast_shapes(a.shape, b.shape), dtype=np.float64)
    na, nb = a[..., N], b[..., N]
    n = na + nb
    # Avoid 0/0 for empty rows; where n == 0 the row stays empty.
    safe_n = np.where(n > 0, n, 1.0)
    delta = b[..., MEAN] - a[..., MEAN]
    out[..., N] = n
    out[..., MEAN] = a[..., MEAN] + delta * nb / safe_n
    out[..., M2] = a[..., M2] + b[..., M2] + delta**2 * na * nb / safe_n
    out[..., M3] = (
        a[..., M3]
        + b[..., M3]
        + delta**3 * na * nb * (na - nb) / safe_n**2
        + 3.0 * delta * (na * b[..., M2] - nb * a[..., M2]) / safe_n
    )
    out[..., M4] = (
        a[..., M4]
        + b[..., M4]
        + delta**4 * na * nb * (na**2 - na * nb + nb**2) / safe_n**3
        + 6.0 * delta**2 * (na**2 * b[..., M2] + nb**2 * a[..., M2]) / safe_n**2
        + 4.0 * delta * (na * b[..., M3] - nb * a[..., M3]) / safe_n
    )
    out[..., MIN] = np.minimum(a[..., MIN], b[..., MIN])
    out[..., MAX] = np.maximum(a[..., MAX], b[..., MAX])
    # A merge with an empty operand is a bitwise copy of the other side —
    # the formulas above would round MEAN twice via (μ n)/n.  Exactness here
    # is what lets a sharded/federated merge bit-match the single-table path.
    empty_a = np.broadcast_to((na == 0)[..., None], out.shape)
    out = np.where(empty_a, np.broadcast_to(b, out.shape), out)
    empty_b = np.broadcast_to((nb == 0)[..., None], out.shape)
    out = np.where(empty_b & ~empty_a, np.broadcast_to(a, out.shape), out)
    # Empty + empty stays a proper empty row.
    zero = n == 0
    if np.any(zero):
        out[zero] = empty_table(1)[0]
    return out


# --------------------------------------------------------------- federation
# Function-id space is partitioned over PS shards *cyclically*: shard ``s``
# of ``S`` owns global fids {s, s+S, s+2S, ...}.  Cyclic slicing is stable
# under table growth (a new fid maps to a shard without repartitioning any
# existing row) and maps to numpy strided views, so routing a delta to its
# shards is ``delta[s::S]`` — no copies, no index arrays.


def shard_rows(num_funcs: int, shard: int, num_shards: int) -> int:
    """Number of global fids < ``num_funcs`` owned by ``shard``."""
    return len(range(shard, num_funcs, num_shards))


def partition_table(table: np.ndarray, num_shards: int) -> list:
    """Split a (F, 7) table into per-shard row blocks (cyclic slicing)."""
    return [table[s::num_shards] for s in range(num_shards)]


def assemble_shards(shards, num_funcs: int) -> np.ndarray:
    """Inverse of :func:`partition_table`: interleave shard blocks back into
    a global (F, 7) table.

    Because shards own disjoint fid rows, the conceptual per-shard merge
    folds each shard's rows into still-empty destination rows — and an
    empty-row merge is a bitwise copy of the non-empty operand
    (:func:`merge_moments`).  So the assembly *is* the interleave: a strided
    assignment per shard, bit-identical to the merge formulation at a
    fraction of its cost (this runs on every federation aggregate refresh).
    """
    num_shards = len(shards)
    out = empty_table(num_funcs)
    for s, block in enumerate(shards):
        rows = min(block.shape[0], shard_rows(num_funcs, s, num_shards))
        out[s::num_shards][:rows] = block[:rows]
    return out


def coalesce_deltas(deltas) -> np.ndarray:
    """Fold several (F, 7) frame deltas into one with pairwise merges.

    This is what a batching PS client sends instead of per-frame pushes:
    one merged delta amortizes routing + lock acquisition on the server.
    Exact up to float associativity (Pébay merges are assoc/comm).
    """
    deltas = list(deltas)
    if not deltas:
        raise ValueError("coalesce_deltas needs at least one delta")
    F = max(d.shape[0] for d in deltas)
    out = pad_table(deltas[0], F)
    for d in deltas[1:]:
        out = merge_moments(out, pad_table(d, F))
    return out if len(deltas) > 1 else out.copy()


@dataclasses.dataclass
class RunningStats:
    """Scalar streaming moments — readable reference implementation."""

    n: float = 0.0
    mean: float = 0.0
    m2: float = 0.0
    m3: float = 0.0
    m4: float = 0.0
    vmin: float = np.inf
    vmax: float = -np.inf

    def push(self, x: float) -> None:
        self.merge_row(batch_moments(np.asarray([x])))

    def push_batch(self, xs: np.ndarray) -> None:
        self.merge_row(batch_moments(np.asarray(xs)))

    def merge(self, other: "RunningStats") -> None:
        self.merge_row(other.as_row())

    def merge_row(self, row: np.ndarray) -> None:
        merged = merge_moments(self.as_row(), row)
        (self.n, self.mean, self.m2, self.m3, self.m4, self.vmin, self.vmax) = (
            float(v) for v in merged
        )

    def as_row(self) -> np.ndarray:
        return np.array(
            [self.n, self.mean, self.m2, self.m3, self.m4, self.vmin, self.vmax],
            dtype=np.float64,
        )

    @property
    def var(self) -> float:
        return self.m2 / self.n if self.n > 1 else 0.0

    @property
    def std(self) -> float:
        return float(np.sqrt(self.var))

    @property
    def skewness(self) -> float:
        if self.n < 2 or self.m2 <= 0:
            return 0.0
        return float(np.sqrt(self.n) * self.m3 / self.m2**1.5)

    @property
    def kurtosis(self) -> float:
        if self.n < 2 or self.m2 <= 0:
            return 0.0
        return float(self.n * self.m4 / self.m2**2 - 3.0)

    def to_dict(self) -> Dict[str, float]:
        return {
            "count": self.n,
            "mean": self.mean,
            "std": self.std,
            "skewness": self.skewness,
            "kurtosis": self.kurtosis,
            "min": self.vmin if np.isfinite(self.vmin) else 0.0,
            "max": self.vmax if np.isfinite(self.vmax) else 0.0,
        }


class StatsTable:
    """Vectorized per-function moments — the on-node AD module's hot state.

    Rows are function ids. ``update_batch`` folds one frame of completed
    calls in O(sort); ``merge`` folds another table (local -> PS exchange).
    """

    def __init__(self, num_funcs: int, table: Optional[np.ndarray] = None):
        self.table = empty_table(num_funcs) if table is None else table
        assert self.table.shape == (num_funcs, NCOLS)

    @property
    def num_funcs(self) -> int:
        return self.table.shape[0]

    def copy(self) -> "StatsTable":
        return StatsTable(self.num_funcs, self.table.copy())

    def grow(self, num_funcs: int) -> None:
        if num_funcs > self.num_funcs:
            t = empty_table(num_funcs)
            t[: self.num_funcs] = self.table
            self.table = t

    def batch_table(self, fids: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Exact per-fid moment table for one batch (no state update)."""
        delta = empty_table(self.num_funcs)
        if fids.size == 0:
            return delta
        fids = np.asarray(fids, dtype=np.int64)
        x = np.asarray(values, dtype=np.float64)
        order = np.argsort(fids, kind="stable")
        sf, sx = fids[order], x[order]
        uniq, starts = np.unique(sf, return_index=True)
        ends = np.append(starts[1:], sf.size)
        # Per-fid counts / sums via reduceat — one pass, no Python loop on events.
        cnt = (ends - starts).astype(np.float64)
        ssum = np.add.reduceat(sx, starts)
        mean = ssum / cnt
        d = sx - np.repeat(mean, (ends - starts))
        d2 = np.add.reduceat(d * d, starts)
        d3 = np.add.reduceat(d * d * d, starts)
        d4 = np.add.reduceat(d * d * d * d, starts)
        vmin = np.minimum.reduceat(sx, starts)
        vmax = np.maximum.reduceat(sx, starts)
        delta[uniq, N] = cnt
        delta[uniq, MEAN] = mean
        delta[uniq, M2] = d2
        delta[uniq, M3] = d3
        delta[uniq, M4] = d4
        delta[uniq, MIN] = vmin
        delta[uniq, MAX] = vmax
        return delta

    def update_batch(self, fids: np.ndarray, values: np.ndarray) -> np.ndarray:
        """Fold a frame of (fid, runtime) pairs in; returns the delta table."""
        delta = self.batch_table(fids, values)
        self.table = merge_moments(self.table, delta)
        return delta

    def merge(self, other: "StatsTable") -> None:
        if other.num_funcs > self.num_funcs:
            self.grow(other.num_funcs)
        o = other.table
        if other.num_funcs < self.num_funcs:
            t = empty_table(self.num_funcs)
            t[: other.num_funcs] = o
            o = t
        self.table = merge_moments(self.table, o)

    def merge_array(self, delta: np.ndarray) -> None:
        self.table = merge_moments(self.table, delta)

    # ---- derived quantities used by the detector -------------------------
    def counts(self) -> np.ndarray:
        return self.table[:, N]

    def means(self) -> np.ndarray:
        return self.table[:, MEAN]

    def stds(self) -> np.ndarray:
        n = self.table[:, N]
        var = np.where(n > 1, self.table[:, M2] / np.maximum(n, 1), 0.0)
        return np.sqrt(np.maximum(var, 0.0))

    def row(self, fid: int) -> RunningStats:
        r = self.table[fid]
        return RunningStats(r[N], r[MEAN], r[M2], r[M3], r[M4], r[MIN], r[MAX])

    def nbytes(self) -> int:
        return int(self.table.nbytes)
