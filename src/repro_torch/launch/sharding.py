"""Sharding rules: params (TP + FSDP), batches, caches (port of
``repro.launch.sharding``, the rules alone).

Per-key Megatron-style roles decide the tensor-parallel dim; the FSDP rule
additionally shards one remaining dim over the batch axes.  All choices
degrade gracefully: a dim is only sharded when divisible by the axis size,
so odd vocabularies (49155, 73448) and odd head counts (40, 12, 8) fall
back to the next-best dim.

Each rule is a pure function returning the per-dim spec that JAX's
``PartitionSpec`` holds, as a tuple: an entry is None (replicated), an axis
name, or a tuple of axis names.  :class:`Sharding` is JAX's
``NamedSharding``: a spec on a ``DeviceMesh`` and the DTensor placements it
describes (an axis on tensor dim i is ``Shard(i)`` on that mesh dim, a
tuple of axes ``Shard(i)`` on each of them in the tuple's order, every
other mesh dim ``Replicate()``).  ``param_shardings`` and
``batch_shardings`` give one per leaf, and :func:`place` turns a tree that
every rank holds whole into DTensors of each rank's own blocks, with no
collective.  ``cache_shardings`` gives the decode cache's (Mamba's state
split over d_inner), and :func:`placed_compute_params` builds a rank's
placed serving weights leaf by leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from .. import tree as T
from ..models.common import ModelConfig, init_leaves, param_shapes
from ..models.model import compute_leaf
from .mesh import batch_axes as mesh_batch_axes, batch_shards, tp_size

Spec = Tuple


def _spec(*entries) -> Spec:
    """The entries as ``PartitionSpec`` holds them: a tuple of one axis
    name is that name, an empty tuple None."""
    return tuple((e[0] if len(e) == 1 else (e or None)) if isinstance(e, tuple) else e
                 for e in entries)

# Megatron role per parameter name: which dim of the (in, out) 2-D view the
# model axis shards. 'col' -> output dim, 'row' -> input dim, 'rep' -> none.
_COL = frozenset(
    {"wq", "wk", "wv", "wuq", "wuk", "wuv", "wdq", "in_proj", "dt_proj",
     "w_gate", "w_up", "conv_w", "unembed", "shared_gate", "shared_up"}
)
_ROW = frozenset({"wo", "out_proj", "x_proj", "w_down", "A_log", "shared_down"})
_VEC_MODEL = frozenset({"conv_b", "dt_bias", "D"})  # d_inner-length vectors
_EXPERT = frozenset({"moe_gate", "moe_up", "moe_down"})
_REP = frozenset(
    {"ln1", "ln2", "post_ln1", "post_ln2", "q_ln", "kv_ln", "final_ln",
     "router", "wdkv"}
)


def _fsdp_dim(shape: Tuple[int, ...], taken: int, dp: int) -> Optional[int]:
    """Largest not-yet-sharded dim divisible by the data-parallel size."""
    best, best_size = None, 0
    for i, s in enumerate(shape):
        if i == taken:
            continue
        if s % dp == 0 and s > best_size and s >= dp:
            best, best_size = i, s
    return best


_MAMBA_KEYS = frozenset(
    {"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log",
     "D", "out_proj"}
)


def param_pspec(
    key: str,
    shape: Tuple[int, ...],
    tp: int,
    dp_axes: Tuple[str, ...],
    dp: int,
    stacked: bool,
    fsdp: bool = True,
    mamba_tp: bool = True,
) -> Spec:
    """PartitionSpec for one parameter tensor."""
    off = 1 if stacked else 0  # leading n_periods dim is never sharded
    spec: list = [None] * len(shape)
    model_dim = None
    if not mamba_tp and key in _MAMBA_KEYS:
        # mamba layers as pure FSDP: kills the 2 fwd + ~4 bwd row-parallel
        # activation psums per layer (EXPERIMENTS.md §Perf falcon-mamba)
        fd = _fsdp_dim(tuple(0 if i < off else s2 for i, s2 in enumerate(shape)), -1, dp)
        if fsdp and fd is not None and fd >= off:
            spec[fd] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
        # give the model axis a secondary dim if one divides (pure sharding,
        # gathered at use like FSDP — no activation psums introduced)
        for i in range(len(shape) - 1, off - 1, -1):
            if i != fd and shape[i] % tp == 0:
                spec[i] = "model"
                break
        return _spec(*spec)
    if key in _EXPERT:
        if shape[off] % tp == 0:
            model_dim = off  # experts over the model axis (EP)
    elif key in _COL:
        cand = len(shape) - 1
        if shape[cand] % tp == 0:
            model_dim = cand
    elif key in _ROW:
        cand = off  # input dim of the 2-D view
        if shape[cand] % tp == 0:
            model_dim = cand
    elif key in _VEC_MODEL:
        if shape[-1] % tp == 0:
            model_dim = len(shape) - 1
    elif key == "embed":
        if shape[0] % tp == 0:
            model_dim = 0  # vocab-sharded
        elif shape[1] % tp == 0:
            model_dim = 1
    if key in _REP or (model_dim is None and key not in ("embed",)):
        # fall back: try to give the model axis SOMETHING divisible
        if key not in _REP:
            for i in range(len(shape) - 1, off - 1, -1):
                if shape[i] % tp == 0:
                    model_dim = i
                    break
    if model_dim is not None:
        spec[model_dim] = "model"
    if fsdp and dp > 1:
        fd = _fsdp_dim(tuple(0 if i < off else s for i, s in enumerate(shape)),
                       model_dim if model_dim is not None else -1, dp)
        if fd is not None and fd >= off:
            spec[fd] = dp_axes if len(dp_axes) > 1 else dp_axes[0]
    return _spec(*spec)


# ----------------------------------------------------------------- batches
def batch_pspec(cfg: ModelConfig, name: str, shape, mesh) -> Spec:
    dpa = mesh_batch_axes(mesh)
    dp = batch_shards(mesh)
    b = dpa if (len(dpa) > 0 and shape[0] % dp == 0 and shape[0] > 1) else None
    if name == "pos3":  # (3, B, S)
        b3 = dpa if shape[1] % dp == 0 and shape[1] > 1 else None
        return _spec(None, b3, None)
    rest = [None] * (len(shape) - 1)
    return _spec(b, *rest)


# ------------------------------------------------------------------- cache
def cache_pspec(path_keys, shape, cfg: ModelConfig, mesh) -> Spec:
    """Decode caches: batch over batch-axes, sequence over the model axis
    (uniform across archs — scales to 500k contexts regardless of head
    count; attention over the seq-sharded cache is a shard_map flash-decode
    merge, see models/model.py)."""
    tp = tp_size(mesh)
    dpa = mesh_batch_axes(mesh)
    dp = batch_shards(mesh)
    key = path_keys[-1]
    if key == "pos":
        return ()
    if key == "kpos":  # (NP, Sc)
        return (None, "model" if shape[1] % tp == 0 else None)
    b = dpa if shape[1] % dp == 0 and shape[1] > 1 else None
    if key in ("k", "v", "ckv", "krope"):  # (NP, B, Sc, ...)
        s = "model" if shape[2] % tp == 0 else None
        rest = [None] * (len(shape) - 3)
        return _spec(None, b, s, *rest)
    if key == "h":  # (NP, B, di, st)
        s = "model" if shape[2] % tp == 0 else None
        return _spec(None, b, s, None)
    if key == "conv":  # (NP, B, K-1, di)
        s = "model" if shape[3] % tp == 0 else None
        return _spec(None, b, None, s)
    return ()


# -------------------------------------------------------------- placements
def _axes(entry) -> Tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, dim_names: Sequence[str]) -> Tuple[Any, ...]:
    """The DTensor placements over mesh dims ``dim_names`` that ``spec``
    describes.  DTensor splits a tensor dim sharded over several mesh dims
    major to minor in mesh-dim order, so a tuple entry must name them in
    that order (the rules name the batch axes so)."""
    names = tuple(dim_names)
    out: list = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: the axes of dim {dim} are not in mesh order {names}")
        for i in idx:
            if isinstance(out[i], Shard):
                raise ValueError(f"spec {spec} uses mesh axis {names[i]!r} twice")
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """JAX's ``NamedSharding``: ``spec`` on ``mesh`` (a ``DeviceMesh``, or
    anything with ``mesh_dim_names`` and ``shape``)."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return placements(self.spec, self.mesh.mesh_dim_names)


def block_index(shape: Sequence[int], placements_: Sequence[Any], mesh_shape: Sequence[int],
                coord: Sequence[int]) -> Tuple[slice, ...]:
    """The index of the block a rank at mesh coordinate ``coord`` holds of
    a global tensor of ``shape`` under ``placements_`` (even splits)."""
    n, i = [1] * len(shape), [0] * len(shape)
    for d, p in enumerate(placements_):
        if isinstance(p, Shard):
            n[p.dim], i[p.dim] = n[p.dim] * mesh_shape[d], i[p.dim] * mesh_shape[d] + coord[d]
    index = []
    for dim, size in enumerate(shape):
        if size % n[dim]:
            raise ValueError(f"dim {dim} of {tuple(shape)} does not split {n[dim]} ways "
                             f"({tuple(placements_)})")
        step = size // n[dim]
        index.append(slice(i[dim] * step, (i[dim] + 1) * step))
    return tuple(index)


def local_block(t: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's block of ``t`` (whole on every rank) under ``sharding``:
    a copy where it is cut, ``t`` itself where it is not."""
    mesh = sharding.mesh
    index = block_index(t.shape, sharding.placements, tuple(mesh.shape), mesh.get_coordinate())
    if all(s.stop - s.start == n for s, n in zip(index, t.shape)):
        return t
    return t[index].clone()


def place(tree, shardings):
    """``tree``'s leaves, which every rank holds whole, as DTensors of the
    rank's blocks (``DTensor.from_local``: no collective; ``distribute_tensor``
    would scatter from one rank what every rank already holds).  A leaf
    whose sharding is None stays as it is."""

    def one(t, sharding):
        if sharding is None:
            return t
        return DTensor.from_local(local_block(t, sharding), sharding.mesh, sharding.placements,
                                  run_check=False)

    return T.map(one, tree, shardings)


def _map_keyed(fn, tree, key=None, stacked: bool = False):
    """``fn(key, stacked, leaf)`` over a parameter tree: ``key`` is the
    leaf's last dict key, ``stacked`` whether a list lies on its path (the
    leaves of ``params["layers"][pos]``), as JAX reads ``DictKey`` and
    ``SequenceKey``."""
    if isinstance(tree, dict):
        return {k: _map_keyed(fn, v, k, stacked) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_keyed(fn, v, key, True) for v in tree]
    return fn(key, stacked, tree)


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def param_shardings(cfg: ModelConfig, params_tree, mesh, fsdp: bool = True,
                    mamba_tp: bool = True):
    """Tree of :class:`Sharding` matching ``params_tree`` (tensors, or
    shape tuples as ``models.common.param_shapes`` gives them)."""
    tp, dpa, dp = tp_size(mesh), mesh_batch_axes(mesh), batch_shards(mesh)
    return _map_keyed(lambda key, stacked, leaf: Sharding(
        mesh, param_pspec(key, _shape(leaf), tp, dpa, dp, stacked, fsdp, mamba_tp)), params_tree)


def batch_shardings(cfg: ModelConfig, spec, mesh):
    """{name: :class:`Sharding`} of a batch (tensors or shape tuples)."""
    return {k: Sharding(mesh, batch_pspec(cfg, k, _shape(v), mesh)) for k, v in spec.items()}


def cache_shardings(cfg: ModelConfig, cache_tree, mesh):
    """Tree of :class:`Sharding` matching a decode cache (``init_cache``'s
    tree of tensors or shape tuples) by :func:`cache_pspec`, which reads
    the leaf's dict keys; a host int (``pos``, ``max_seq``) None: every
    rank holds it.  The port's meshed cache holds each rank's blocks of it
    as plain tensors (``models.model.init_cache`` and ``prefill`` on a
    mesh)."""

    def walk(tree, keys):
        if isinstance(tree, dict):
            return {k: walk(v, keys + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, keys) for v in tree]
        if isinstance(tree, int):
            return None
        return Sharding(mesh, cache_pspec(list(keys), _shape(tree), cfg, mesh))

    return walk(cache_tree, ())


def placed_compute_params(cfg: ModelConfig, seed: int, mesh=None, fsdp: bool = True,
                          mamba_tp: bool = True, device=None):
    """The serving weights ``compute_params(cfg, init_params(cfg, seed,
    device))`` placed by :func:`param_shardings` on ``mesh`` (None: whole),
    built leaf by leaf: each leaf drawn whole in ``init_params``'s order,
    cast, cut to the rank's block and freed before the next, so a rank
    holds its blocks and one whole float32 leaf at most (jamba-v0.1-52b's
    stacked experts, 15 GB), never the float32 tree.  Its blocks equal
    :func:`local_block` of the whole tree's, bitwise, on one device type."""
    shardings = None if mesh is None else param_shardings(cfg, param_shapes(cfg), mesh, fsdp,
                                                          mamba_tp)
    top: dict = {}
    layers: list = [{} for _ in cfg.layout]
    for path, leaf in init_leaves(cfg, seed, device):
        t = compute_leaf(cfg, path[-1], leaf)
        del leaf
        if shardings is not None:
            sharding = shardings[path[0]] if len(path) == 1 else \
                shardings["layers"][path[1]][path[2]]
            t = DTensor.from_local(local_block(t, sharding), sharding.mesh, sharding.placements,
                                   run_check=False)
        if len(path) == 1:
            top[path[0]] = t
        else:
            layers[path[1]][path[2]] = t
    return {**top, "layers": layers}
