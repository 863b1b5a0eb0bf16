"""Cost accounting and mesh construction (port of ``repro.compat``).

JAX reads a step's costs from its compiled executable
(``compiled.cost_analysis()``) and its memory from ``memory_analysis()``.
Eager PyTorch has no executable, so the port counts while the step runs:
:class:`CostCounter` is a ``TorchDispatchMode`` that sees every aten
operation of one step (autograd's backward and checkpoint recomputes
included) and adds up

  * ``flops``: matmul and convolution FLOPs by ``torch.utils.flop_counter``'s
    per-op formulas, plus one per output element of elementwise arithmetic
    (ops tagged ``pointwise``); reductions, copies and casts count none;
  * ``bytes accessed``: the bytes each op reads and writes (its tensor
    inputs and outputs at their logical sizes; a view moves none).  This is
    unfused traffic, op by op, so it is an upper bound where XLA's count
    is taken after fusion;
  * ``transcendentals``: output elements of ``exp``, ``log``, ``tanh``,
    ``sin``, ``cos``, ``rsqrt``, ``erf`` and the like (a softmax counts
    one per element);
  * live bytes: every storage the step creates, from its first output until
    Python and autograd let it go (a saved tensor stays live until the
    backward frees it), and the peak of their sum with the arguments';
  * the collectives the step runs (``c10d`` ops, and the
    ``_c10d_functional`` ops DTensor's redistributions run), as
    :class:`CollectiveRecorder` alone records them; neither kind counts as
    an aten op or as bytes accessed (their bytes cross the wire).

A DTensor counts as its local block, the rank's own bytes: the costs are
per device, as JAX's ``cost_analysis`` of a partitioned executable.

On the meta device nothing is allocated or computed, so a full-width step
is counted in seconds of host time (the dry run).  Eager counting counts
every loop iteration, where XLA counts a while-loop body once.

``shard_map`` has no counterpart: the port's data-parallel step
(``launch.steps.make_dp_train_step``) writes its collectives explicitly
with ``torch.distributed``.  :func:`make_mesh` wraps
``init_device_mesh`` with named dims.
"""
from __future__ import annotations

import weakref
from typing import Dict, List, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map_only
from torch.utils.flop_counter import flop_registry

from .device import resolve

__all__ = ["CollectiveRecorder", "CostCounter", "cost_analysis", "make_mesh", "storage_bytes"]

# c10d operation -> the HLO collective JAX's roofline names it by
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute",
}
# _c10d_functional operation (DTensor's collectives) -> its HLO name; the
# op's output holds the result
_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NAMESPACES = frozenset({"c10d", "_c10d_functional"})

# aten ops whose every output element is one transcendental (XLA's count)
TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh", "sigmoid",
    "sin", "cos", "tan", "asin", "acos", "atan", "atan2", "sinh", "cosh", "rsqrt",
    "sqrt", "erf", "erfc", "erfinv", "pow", "silu", "gelu", "softplus", "logit",
    "_softmax", "_log_softmax",
})


def _tensors(tree) -> List[torch.Tensor]:
    """Every tensor in nested lists, tuples and dicts; a DTensor as its
    local block."""
    if isinstance(tree, DTensor):
        return [tree._local_tensor]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensors(sub)]
    if isinstance(tree, dict):
        return [t for sub in tree.values() for t in _tensors(sub)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def storage_bytes(tree) -> Dict[int, int]:
    """{storage id: bytes} of the distinct storages under ``tree``'s tensors."""
    return {id(st): st.nbytes() for st in (t.untyped_storage() for t in _tensors(tree))}


class CollectiveRecorder(TorchDispatchMode):
    """Records each collective run under it as (op, result bytes), op by
    JAX's HLO name; ``roofline.collective_bytes`` sums them.  It sees
    ``torch.distributed``'s collectives (c10d ops) on any backend (gloo,
    NCCL, a fake group), as they pass the dispatcher, and the functional
    collectives (``_c10d_functional`` ops) of DTensor's redistributions;
    ``wait_tensor`` and the like are no collective."""

    def __init__(self):
        super().__init__()
        self.collectives: List[Tuple[str, int]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            op = _C10D.get(func._opname)
            if op is not None:  # the first argument holds the result (sent) tensors
                self.collectives.append((op, sum(_nbytes(t) for t in _tensors(args[0]))))
        elif func.namespace == "_c10d_functional":
            op = _FUNCTIONAL.get(func._opname)
            if op is not None:  # the output holds the result
                self.collectives.append((op, sum(_nbytes(t) for t in _tensors(out))))
        return out


class CostCounter(CollectiveRecorder):
    """Counts FLOPs, bytes accessed, transcendentals and live bytes of the
    aten ops run under it (see the module docstring).

    ``hold(tree)`` registers tensors that exist before the step (its
    arguments) as live; ``peak_bytes`` is the largest sum of live storage
    bytes seen after any op.
    """

    def __init__(self):
        super().__init__()
        self.ops = 0  # aten ops counted
        self.flops = 0
        self.bytes_accessed = 0
        self.transcendentals = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, weakref.ref] = {}
        self._info: Dict[object, tuple] = {}  # per op: (mutates, pointwise, transcendental, formula)

    # ----------------------------------------------------------- lifetimes
    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        nbytes = st.nbytes()

        def freed(_ref, key=key, nbytes=nbytes, live=self._live, counter=weakref.ref(self)):
            live.pop(key, None)
            c = counter()
            if c is not None:
                c.live_bytes -= nbytes

        self._live[key] = weakref.ref(st, freed)
        self.live_bytes += nbytes

    def hold(self, tree) -> int:
        """Register ``tree``'s tensors as live; returns their distinct
        storage bytes."""
        before = self.live_bytes
        for t in _tensors(tree):
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return self.live_bytes - before

    # ----------------------------------------------------------- counting
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            return out
        self.ops += 1
        info = self._info.get(func)
        if info is None:
            packet = func.overloadpacket
            info = self._info[func] = (
                any(a.alias_info is not None and a.alias_info.is_write
                    for a in func._schema.arguments),  # in place or out=
                torch.Tag.pointwise in func.tags,
                packet.__name__.rstrip("_") in TRANSCENDENTAL,
                flop_registry.get(packet))
        mutates, pointwise, transcendental, formula = info
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        in_storages = {id(t.untyped_storage()) for t in ins}
        if outs and not mutates and all(id(t.untyped_storage()) in in_storages for t in outs):
            return out  # a view: no bytes move
        self.bytes_accessed += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        if formula is not None:
            local = lambda t: t._local_tensor  # noqa: E731 - a DTensor's own block
            self.flops += formula(*tree_map_only(DTensor, local, args),
                                  **tree_map_only(DTensor, local, kwargs),
                                  out_val=tree_map_only(DTensor, local, out))
        elif pointwise:
            self.flops += sum(t.numel() for t in outs)
        if transcendental:
            self.transcendentals += sum(t.numel() for t in outs)
        for t in outs:
            self._track(t)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return out


def cost_analysis(counter: CostCounter) -> dict:
    """A finished count under JAX's ``cost_analysis()`` key names."""
    return {"flops": float(counter.flops), "bytes accessed": float(counter.bytes_accessed),
            "transcendentals": float(counter.transcendentals)}


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], device=None):
    """``init_device_mesh`` over the default process group, dims named
    ``axis_names``, on ``device``'s type (None: the port's default, CUDA).
    The process group must already be initialised."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(resolve(device).type, tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))
