"""Stats tables, model parameters and train states carried across: the JAX
package, the port.

Model parameters (:func:`params_from_jax`, :func:`params_to_numpy`) keep
the JAX tree's shape: ``{"embed", "final_ln", ["unembed"], "layers": [...]}``
with layer leaves stacked over periods, so each port leaf has the flat name
of its JAX tree path (:func:`flat_names`, ``jax.tree_util.keystr``).  A
train state (:func:`train_state_from_jax`, :func:`train_state_to_numpy`)
is ``{"params", "m", "v", "step"}`` and, with a float32 master beside bf16
params, ``"master"``, as ``launch.steps.make_train_state`` makes it in
both packages.  The data-parallel step's error-feedback state
(:func:`error_state_from_jax`) is stacked over devices in JAX and held per
rank in the port.  A global array and its spec under ``launch.sharding``'s
rules give any rank's block on a mesh (:func:`block_from_jax`): the expert
leaves and the caches each rank holds.

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

from typing import Any, Dict, List, Sequence

from .core import stats as _host
from .core.torch_ad import NCOLS
from .device import resolve
from .launch.sharding import block_index, placements
from .models.common import ModelConfig, param_shapes
from .tree import map as _tree_map, paths as _paths

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
def flat_names(params) -> List[str]:
    """The flat leaf names of a parameter tree, as ``jax.tree_util.keystr``
    prints the JAX tree's paths (``['layers'][0]['wq']``), in its order."""
    return [path for path, _ in _paths(params)]


def params_from_jax(tree, cfg: ModelConfig, *, device=None, dtype=None) -> Dict[str, Any]:
    """A JAX ``init_params`` tree (leaves as numpy) -> the port's parameters
    in ``dtype`` (default ``cfg.param_dtype``) on ``device``; the tree must
    hold exactly the leaves and shapes ``cfg`` implies.  bf16 leaves
    (``ml_dtypes``) widen to float32 exactly on the way."""
    device = resolve(device)
    dtype = cfg.param_dtype if dtype is None else dtype
    want = dict(_paths(param_shapes(cfg)))
    got = dict(_paths(tree))
    if set(got) != set(want):
        raise ValueError(f"parameter names differ: missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}")

    def leaf(path: str, arr) -> torch.Tensor:
        arr = np.array(arr, dtype=np.float32)  # a copy; bf16 leaves widen exactly
        if tuple(arr.shape) != tuple(want[path]):
            raise ValueError(f"{path}: shape {arr.shape}, expected {want[path]}")
        return torch.from_numpy(arr).to(device, dtype)

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


# ----------------------------------------------------------------- train state
def train_state_from_jax(state, cfg: ModelConfig, *, device=None) -> Dict[str, Any]:
    """A JAX ``make_train_state`` tree (leaves as numpy) -> the port's train
    state on ``device``: m, v and a master in float32, params in float32 or,
    beside a master, bf16 (each bit as JAX holds it), step an int32 scalar."""
    device = resolve(device)
    master = "master" in state
    out = {
        "params": params_from_jax(state["params"], cfg, device=device,
                                  dtype=torch.bfloat16 if master else torch.float32),
        "m": params_from_jax(state["m"], cfg, device=device, dtype=torch.float32),
        "v": params_from_jax(state["v"], cfg, device=device, dtype=torch.float32),
        "step": torch.tensor(int(np.asarray(state["step"])), dtype=torch.int32, device=device),
    }
    if master:
        out["master"] = params_from_jax(state["master"], cfg, device=device,
                                        dtype=torch.float32)
    return out


def train_state_to_numpy(state) -> Dict[str, Any]:
    """The port's train state -> numpy trees of the JAX state's shape: float32
    leaves (bf16 params widen exactly; ``jnp.asarray(x, jnp.bfloat16)`` gives
    them back) and an int32 step."""
    out = {k: params_to_numpy(state[k]) for k in ("params", "m", "v", "master") if k in state}
    out["step"] = np.asarray(int(state["step"]), dtype=np.int32)
    return out


# ----------------------------------------------------------------- error feedback
def error_state_from_jax(err, rank: int, *, device=None) -> Any:
    """JAX's data-parallel error-feedback state (``make_dp_train_step``'s
    ``init_err`` tree: each leaf stacked over a leading (ndev,) axis, as
    numpy) -> rank ``rank``'s float32 tensors on ``device``, the tree
    ``launch.steps.make_dp_train_step`` keeps on that rank."""
    device = resolve(device)

    def leaf(arr) -> torch.Tensor:
        arr = np.asarray(arr)
        if arr.ndim < 1 or not 0 <= rank < arr.shape[0]:
            raise ValueError(f"rank {rank} outside a stacked leaf of shape {arr.shape}")
        return torch.from_numpy(np.array(arr[rank], dtype=np.float32)).to(device)

    return _tree_map(leaf, err)


# ----------------------------------------------------------------- mesh blocks
def block_from_jax(arr, spec, mesh_shape: Sequence[int], axis_names: Sequence[str],
                   rank: int) -> np.ndarray:
    """Rank ``rank``'s block of a global array (numpy) on a mesh of
    ``mesh_shape`` with dims ``axis_names``, ranks laid out row-major over
    the dims as ``init_device_mesh`` lays them.  ``spec`` is a
    ``PartitionSpec`` as ``launch.sharding``'s rules give it, one entry per
    leading dim: None, an axis name, or a tuple of names split major to
    minor.  A copy."""
    arr = np.asarray(arr)
    if len(spec) > arr.ndim:
        raise ValueError(f"spec {spec} has more entries than the array's {arr.ndim} dims")
    coord = np.unravel_index(rank, tuple(mesh_shape))
    index = block_index(arr.shape, placements(spec, axis_names), tuple(mesh_shape), coord)
    return arr[index].copy()
