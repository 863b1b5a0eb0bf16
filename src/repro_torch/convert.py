"""Stats tables and model parameters carried across: the JAX package, the port.

Model parameters (:func:`params_from_jax`, :func:`params_to_numpy`) keep
the JAX tree's shape: ``{"embed", "final_ln", ["unembed"], "layers": [...]}``
with layer leaves stacked over periods, so each port leaf has the flat name
of its JAX tree path (:func:`flat_names`, ``jax.tree_util.keystr``).

Stats tables:

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

from typing import Any, Dict, List, Tuple

from .core import stats as _host
from .core.torch_ad import NCOLS
from .device import resolve
from .models.common import ModelConfig, param_shapes

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


# ----------------------------------------------------------------- parameters
def _paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(keystr path, leaf) pairs in jax.tree_util's order: dict keys sorted.
    Dicts and lists are the tree's nodes; anything else (a shape tuple too)
    is a leaf."""
    if isinstance(tree, dict):
        return [pair for key in sorted(tree) for pair in _paths(tree[key], f"{prefix}['{key}']")]
    if isinstance(tree, list):
        return [pair for i, sub in enumerate(tree) for pair in _paths(sub, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def flat_names(params) -> List[str]:
    """The flat leaf names of a parameter tree, as ``jax.tree_util.keystr``
    prints the JAX tree's paths (``['layers'][0]['wq']``), in its order."""
    return [path for path, _ in _paths(params)]


def params_from_jax(tree, cfg: ModelConfig, *, device=None) -> Dict[str, Any]:
    """A JAX ``init_params`` tree (leaves as numpy) -> the port's parameters
    in ``cfg.param_dtype`` on ``device``; the tree must hold exactly the
    leaves and shapes ``cfg`` implies."""
    device = resolve(device)
    want = dict(_paths(param_shapes(cfg)))
    got = dict(_paths(tree))
    if set(got) != set(want):
        raise ValueError(f"parameter names differ: missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}")

    def leaf(path: str, arr) -> torch.Tensor:
        arr = np.array(arr, dtype=np.float32)  # a copy; bf16 leaves widen exactly
        if tuple(arr.shape) != tuple(want[path]):
            raise ValueError(f"{path}: shape {arr.shape}, expected {want[path]}")
        return torch.from_numpy(arr).to(device, cfg.param_dtype)

    out: Dict[str, Any] = {k: leaf(f"['{k}']", tree[k]) for k in tree if k != "layers"}
    out["layers"] = [{name: leaf(f"['layers'][{i}]['{name}']", arr) for name, arr in layer.items()}
                     for i, layer in enumerate(tree["layers"])]
    return out


def params_to_numpy(params) -> Dict[str, Any]:
    """The port's parameters -> a tree of float32 numpy arrays with the JAX
    tree's shape, ready for ``jax.tree.map(jnp.asarray, ...)``."""

    def leaf(t: torch.Tensor) -> np.ndarray:
        return t.detach().to("cpu", torch.float32).numpy().copy()

    out: Dict[str, Any] = {k: leaf(v) for k, v in params.items() if k != "layers"}
    out["layers"] = [{k: leaf(v) for k, v in layer.items()} for layer in params["layers"]]
    return out
