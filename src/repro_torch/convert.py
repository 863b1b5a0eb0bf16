"""Stats tables carried across: the JAX package, the host oracle, the port.

All three keep per-function (n, mean, M2, min, max) moments; only the
containers differ:

  * ``repro.core.jax_ad`` tables: (F, 5) float32 arrays, which a caller
    hands over as numpy (``np.asarray(table)``);
  * ``core.stats.StatsTable.table``: (F, 7) float64 with M3 and M4 between
    M2 and min (columns N, MEAN, M2, M3, M4, MIN, MAX);
  * the port's :mod:`core.torch_ad` tables: (F, 5) float32 tensors.

So a table built by the JAX package, or by the host AD modules, resumes in
the port, and :func:`table_to_numpy` hands a port table back.
"""
from __future__ import annotations

import numpy as np
import torch

from .core import stats as _host
from .core.torch_ad import NCOLS
from .device import resolve

HOST_COLUMNS = [_host.N, _host.MEAN, _host.M2, _host.MIN, _host.MAX]


def table_from_jax(table, *, device=None) -> torch.Tensor:
    """(F, 5) jax_ad table as numpy -> (F, 5) float32 tensor on ``device``."""
    arr = np.asarray(table)
    if arr.ndim != 2 or arr.shape[1] != NCOLS:
        raise ValueError(f"expected an (F, {NCOLS}) table, got shape {arr.shape}")
    return torch.from_numpy(arr.astype(np.float32)).to(resolve(device))


def table_from_host(table, *, device=None) -> torch.Tensor:
    """``StatsTable.table`` (F, 7) float64 -> (F, 5) float32 tensor on ``device``."""
    arr = np.asarray(table)
    if arr.ndim != 2 or arr.shape[1] != _host.NCOLS:
        raise ValueError(f"expected an (F, {_host.NCOLS}) host table, got shape {arr.shape}")
    return torch.from_numpy(arr[:, HOST_COLUMNS].astype(np.float32)).to(resolve(device))


def table_to_numpy(table: torch.Tensor) -> np.ndarray:
    """(F, 5) port table -> float32 numpy, ready for ``jnp.asarray``."""
    if table.dim() != 2 or table.shape[1] != NCOLS:
        raise ValueError(f"expected an (F, {NCOLS}) table, got shape {tuple(table.shape)}")
    return table.detach().to("cpu", torch.float32).numpy().copy()
