"""Step builders (port of ``repro.launch.steps``): train, prefill, decode,
the data-parallel train step, and the dry run's cells.

Eager PyTorch: there is no ``jit``, and the step functions are plain
closures over the config, but for the decode step on a CUDA device
without a mesh, which replays a CUDA graph of ``models.model.decode_step``
(:class:`DecodeGraph`): a decode step is hundreds of small kernels, and
enqueued one by one from the host they pace the step.  The train step
takes the gradients with autograd (``torch.autograd.grad``) and updates
the state in place, where JAX donates it (``donate=False`` works on a
copy instead).

:func:`make_cell` builds a step and its arguments as stand-ins on the meta
device (shapes and dtypes, no data), which ``launch.dryrun`` runs under
the counting context; :func:`make_dp_train_step` is JAX's ``shard_map``
data-parallel step with its collectives written out in
``torch.distributed``, on a mesh of any number of dims.
:func:`make_shard_ctx` takes a mesh: prefill and decode then run sequence
and expert parallelism over its model axis (``models.model.ShardCtx``),
and the train step runs there on a state placed by
:func:`train_state_shardings` (``launch.sharding.place``): every rank
passes the global batch, computes its block, and updates its own blocks
of the state.  A cell on a mesh (the dry run's) holds one rank's
arguments: its blocks of the placed state or weights, of the batch and of
the cache.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from .. import configs
from torch.distributed.tensor import DTensor

from .. import tree as T
from ..data.pipeline import batch_spec as data_batch_spec
from ..models import model as M
from ..models.common import MLA, ModelConfig, init_params, param_shapes
from ..models.model import ShardCtx
from ..optim.adamw import OptConfig, apply_updates, init_opt_state
from ..telemetry.selftrace import get_self_tracer
from . import sharding as SH
from .mesh import batch_axes as mesh_batch_axes, batch_shards

_TRACER = get_self_tracer()  # the graphed decode step's span model/decode_step


@dataclasses.dataclass(frozen=True)
class StepOptions:
    remat: str = "block"  # none | block
    fsdp: bool = True  # read only with a mesh
    ce_chunk: int = 1024
    microbatch: int = 0  # gradient-accumulation steps; 0 = auto (fit memory)
    seq_shard: bool = False  # sequence-parallel hidden states: needs a mesh
    donate: bool = True  # the train step updates its state in place
    probe: bool = False  # cost probe (dryrun --probes): direct attention, whole chunks
    # bf16 params + float32 master inside the state (JAX: halves the FSDP
    # weight-gather footprint)
    master_in_opt: bool = False
    mamba_tp: bool = True  # read only with a mesh
    opt: OptConfig = OptConfig()


def auto_microbatch(cfg: ModelConfig, global_batch: int, seq: int, dp: int) -> int:
    """Smallest power-of-two accumulation count that bounds the layer-scan
    carry chain (n_layers × B_loc/mb × S × d × 2B) near ~5 GiB/device,
    leaving headroom for the backward working set on a 16 GiB chip."""
    b_loc = max(global_batch // max(dp, 1), 1)
    carry = cfg.n_layers * b_loc * seq * cfg.d_model * 2
    budget = 5 * 1024**3
    mb = 1
    while carry / mb > budget and mb < b_loc:
        mb *= 2
    return mb


def make_shard_ctx(cfg: ModelConfig, mesh, global_batch: int, opts: StepOptions) -> ShardCtx:
    """The step's ``ShardCtx``: one device, or ``mesh`` (a ``DeviceMesh``
    whose dims are the batch axes and ``model``), as JAX's.  ``seq_shard``
    is read on a mesh only, as in JAX."""
    if mesh is None:
        return ShardCtx(remat=opts.remat, unroll=opts.probe)
    dp = batch_shards(mesh)
    return ShardCtx(
        mesh=mesh,
        batch_axes=mesh_batch_axes(mesh),
        model_axis="model",
        batch_shardable=(global_batch % dp == 0 and global_batch >= dp),
        seq_shard=opts.seq_shard,
        remat=opts.remat,
        unroll=opts.probe,
    )


# ------------------------------------------------------------ step fns
def _split(name: str, x: torch.Tensor, nm: int) -> torch.Tensor:
    """(nm, B/nm, ...) microbatches; pos3 (3, B, S) keeps its batch on axis 1."""
    if name == "pos3":
        return x.reshape((3, nm, x.shape[1] // nm) + tuple(x.shape[2:])).transpose(0, 1)
    return x.reshape((nm, x.shape[0] // nm) + tuple(x.shape[1:]))


def _microbatch(name: str, x: torch.Tensor, nm: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``nm`` of a batch leaf.  A leaf placed by
    ``batch_shardings`` (a DTensor: the rank's rows) is split as its own
    rows, each part placed alike."""
    if isinstance(x, DTensor):
        return DTensor.from_local(_split(name, x.to_local(), nm)[i], x.device_mesh, x.placements,
                                  run_check=False)
    return _split(name, x, nm)[i]


def build_grad_step(
    cfg: ModelConfig, ctx: ShardCtx, opts: StepOptions, microbatch: Optional[int] = None
) -> Callable:
    """The train step's gradients: fn(params, batch) -> (metrics, grads),
    ``jax.value_and_grad(has_aux=True)`` of ``loss_and_metrics``, with
    ``microbatch`` steps accumulated as JAX's ``lax.scan`` (the global
    batch split ``(nm, B/nm, ...)``, each part then cut to the rank's rows
    on a mesh).  On a mesh each grad is a DTensor of its leaf's placement."""
    nm = microbatch if microbatch is not None else max(opts.microbatch, 1)

    def loss_and_grads(params, batch):
        live = [t.detach().requires_grad_(True) for t in T.leaves(params)]
        with torch.enable_grad():
            loss, metrics = M.loss_and_metrics(cfg, T.unflatten(params, live), batch, ctx,
                                               opts.ce_chunk)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, live)]
        return {k: v.detach() for k, v in metrics.items()}, T.unflatten(params, grads)

    def grad_step(params, batch):
        if nm <= 1:
            return loss_and_grads(params, batch)
        gsum = [torch.zeros_like(p, dtype=torch.float32) for p in T.leaves(params)]
        lsum = torch.zeros((), dtype=torch.float32, device=gsum[0].device)
        for i in range(nm):  # summed in microbatch order, as lax.scan
            metrics, grads = loss_and_grads(
                params, {k: _microbatch(k, v, nm, i) for k, v in batch.items()})
            for acc, g in zip(gsum, T.leaves(grads)):
                acc.add_(g)
            lsum = lsum + metrics["loss"]
            del grads
        zero = torch.zeros_like(lsum)
        return {"loss": lsum / nm, "accuracy": zero, "tokens": zero}, \
            T.unflatten(params, [g / nm for g in gsum])

    return grad_step


def build_train_step(
    cfg: ModelConfig, ctx: ShardCtx, opts: StepOptions, microbatch: Optional[int] = None
) -> Callable:
    """JAX's train step: :func:`build_grad_step`, then AdamW on the state
    in place.  On a mesh (``ctx.mesh``) the state is placed by
    :func:`train_state_shardings` and every rank passes the global batch."""
    grad_step = build_grad_step(cfg, ctx, opts, microbatch)

    def train_step(state, batch) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        if not opts.donate:
            state = T.map(torch.clone, state)
        metrics, grads = grad_step(state["params"], batch)
        master = state["master"] if "master" in state else state["params"]
        new_master, opt_state, ostats = apply_updates(
            master, grads, {"m": state["m"], "v": state["v"], "step": state["step"]}, opts.opt,
        )
        del grads
        out_state = {
            "params": new_master, "m": opt_state["m"], "v": opt_state["v"],
            "step": opt_state["step"],
        }
        if "master" in state:  # bf16 working params, float32 master
            out_state["master"] = new_master
            with torch.no_grad():
                for q, w in zip(T.leaves(new_master), T.leaves(state["params"])):
                    w.copy_(q)  # rounds to bf16, as q.astype(jnp.bfloat16)
            out_state["params"] = state["params"]
        return out_state, dict(metrics, **ostats)

    return train_step


def build_prefill_step(cfg: ModelConfig, ctx: ShardCtx, opts: StepOptions,
                       max_seq=None) -> Callable:
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch, ctx, max_seq=max_seq)

    return prefill_step


def build_decode_step(cfg: ModelConfig, ctx: ShardCtx, opts: StepOptions) -> Callable:
    """step(params, cache, tokens) -> (logits, cache), as ``M.decode_step``.

    On a CUDA device without a mesh the step replays a :class:`DecodeGraph`,
    captured on the first step of each decode shape (tokens, and every
    cache leaf's shape and dtype: the batch, ``max_seq`` and the layout)
    and again if the weights are others; its span ``model/decode_step``
    carries ``graphed`` 1.  On the CPU, the meta device and a mesh (whose
    collectives and rank-dependent cache writes stay on the host) it runs
    ``M.decode_step`` eagerly."""
    graphs: Dict[Tuple, DecodeGraph] = {}

    def decode_step(params, cache, tokens):
        if ctx.mesh is not None or tokens.device.type != "cuda":
            return M.decode_step(cfg, params, cache, tokens, ctx)
        with _TRACER.span("model/decode_step") as span:
            if span:
                span.set(graphed=1)
            key = (tokens.device, tuple(tokens.shape), tokens.dtype,
                   tuple((name, tuple(t.shape), t.dtype) for layer in cache["layers"]
                         for name, t in layer.items()))
            graph = graphs.get(key)
            if graph is None or graph.params is not params:
                graphs[key] = graph = DecodeGraph(cfg, ctx, params, cache, tokens)
            return graph(cache, tokens)

    return decode_step


class DecodeGraph:
    """``M.decode_step`` at one decode shape, captured in a CUDA graph over
    static tokens, a static 0-d position and a static cache.

    Capture: the cache given is copied into the static one, one eager step
    on a side stream sets up what is made on first use (cuBLAS's handles,
    the rope tables cached per device), then ``M.decode_step`` (looked up on
    the module at capture) is captured with the self-tracer paused.  A
    failed capture raises.

    A call: a cache that is not the static one (a new wave's prefill) is
    copied into it, the tokens and the position are copied in, the graph
    replays, and the logits are cloned, so each step's logits are a tensor
    of their own.  The cache returned holds the static tensors, so the next
    step passes it back and nothing is copied; they are the graph's, and
    the next call of this shape overwrites them.  So a cache holding them
    that is not the one the last call returned, at its position, raises:
    its state was another sequence's, or already stepped.  A position past
    an MLA latent cache's slots raises (the eager step drops that token's
    latent).
    """

    def __init__(self, cfg: ModelConfig, ctx: ShardCtx, params, cache, tokens: torch.Tensor):
        dev = tokens.device
        self.params = params
        self.tokens = tokens.clone()
        self.pos = torch.full((), int(cache["pos"]), dtype=torch.int64, device=dev)
        self.layers = [{name: t.clone() for name, t in layer.items()}
                       for layer in cache["layers"]]
        self.slots = min((layer["ckv"].shape[2] for spec, layer in zip(cfg.layout, self.layers)
                          if spec.mixer == MLA), default=None)
        self.returned, self.next_pos = None, None
        static = {**cache, "pos": self.pos, "layers": self.layers}
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(dev), _TRACER.paused():
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                M.decode_step(cfg, params, static, self.tokens, ctx)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(self.graph):
                self.logits, _ = M.decode_step(cfg, params, static, self.tokens, ctx)

    def __call__(self, cache, tokens: torch.Tensor):
        pos = int(cache["pos"])
        if self.slots is not None and pos >= self.slots:
            raise ValueError(f"position {pos} is past the latent cache's {self.slots} slots")
        if cache["layers"] is self.layers:
            if cache is not self.returned or pos != self.next_pos:
                raise ValueError(
                    "this cache holds the decode graph's state, which the last step of "
                    "this shape left for another sequence or position: step each sequence "
                    "on from the cache its last step returned, one sequence at a time")
        else:
            for mine, theirs in zip(self.layers, cache["layers"]):
                for name, t in mine.items():
                    t.copy_(theirs[name])
        self.tokens.copy_(tokens)
        self.pos.fill_(pos)
        self.graph.replay()
        self.next_pos = pos + 1
        self.returned = {**cache, "pos": self.next_pos, "layers": self.layers}
        return self.logits.clone(), self.returned


def make_dp_train_step(
    cfg: ModelConfig, mesh, opt: OptConfig = OptConfig(),
    compress: bool = True, ce_chunk: int = 512,
):
    """Data-parallel step over a ``DeviceMesh`` of any number of dims, the
    gradients all-reduced leaf by leaf over all its ranks (int8-compressed
    with error feedback, or a plain mean), as JAX's ``shard_map`` step
    computes.  A mesh of more than one dim takes a new process group of
    its ranks (every rank of the default group must build the step).

    Each rank runs it on its slice of the global batch (rank r, row-major
    over the mesh's dims: rows r·B/n to (r+1)·B/n, JAX's batch sharding
    ``P(axes)``) with the same state.  The
    local loss and gradients take the default ``ShardCtx()`` (no remat, as
    JAX); then one all-reduce per parameter leaf (``compressed_psum`` or a
    sum divided by n), AdamW, and the loss averaged over the ranks (one
    more all-reduce).  Each rank holds its own error-feedback tensors, where
    JAX stacks them on a leading (ndev,) axis (``convert.error_state_from_jax``
    takes rank r's).

    Returns (step, init_err_fn).  step(state, err, batch) -> (state, err,
    metrics); the state and the error tensors are updated in place, as
    ``build_train_step`` updates its state, and each gradient leaf is
    dropped once reduced, so the step holds one gradient tree at a time.
    """
    from ..optim.compression import compressed_psum, init_error_state

    # JAX reduces over every mesh axis: one group of all the mesh's ranks,
    # row-major over its dims (a rank's place in it picks its batch rows)
    group = mesh.get_group() if mesh.ndim == 1 else \
        dist.new_group(mesh.mesh.flatten().tolist())
    ndev = mesh.size()
    ctx = ShardCtx()

    def step(state, err, batch):
        params = state["params"]
        live = [t.detach().requires_grad_(True) for t in T.leaves(params)]
        with torch.enable_grad():
            loss, _ = M.loss_and_metrics(cfg, T.unflatten(params, live), batch, ctx, ce_chunk)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads, new_g = list(grads), []
        # JAX's pmean divides by the group's size; a tensor divisor keeps
        # the quotient true on CUDA, which multiplies by a scalar's reciprocal
        n = torch.full((), float(ndev), device=loss.device)
        for i, (t, e) in enumerate(zip(live, T.leaves(err))):
            g, grads[i] = grads[i], None
            g = torch.zeros_like(t) if g is None else g
            if compress:
                g, new_e = compressed_psum(g, group, e)
                e.copy_(new_e)
                del new_e
            else:
                dist.all_reduce(g, group=group)
                g.div_(n)
            new_g.append(g)
        del grads, live
        new_params, opt_state, stats = apply_updates(
            params, T.unflatten(params, new_g),
            {"m": state["m"], "v": state["v"], "step": state["step"]}, opt,
        )
        loss = loss.detach().clone()
        dist.all_reduce(loss, group=group)
        state = {"params": new_params, "m": opt_state["m"], "v": opt_state["v"],
                 "step": opt_state["step"]}
        return state, err, {"loss": loss / n, **stats}

    return step, init_error_state


def train_state_shardings(cfg: ModelConfig, state, mesh, opts: StepOptions = StepOptions()):
    """The train state's :class:`launch.sharding.Sharding` tree on ``mesh``,
    as JAX's ``make_cell`` places it: params, m, v (and the master) by
    ``param_shardings`` with ``opts.fsdp`` and ``opts.mamba_tp``; ``step``
    None (not placed: every rank holds it)."""
    out = {k: SH.param_shardings(cfg, state[k], mesh, opts.fsdp, opts.mamba_tp)
           for k in ("params", "m", "v", "master") if k in state}
    return {**out, "step": None}


def make_train_state(cfg: ModelConfig, seed: int = 0, master_in_opt: bool = False,
                     device=None) -> Dict:
    """float32 params from ``seed`` on ``device`` (None: the port's default),
    zero m and v, step 0; with ``master_in_opt`` the params are bf16 copies
    and the float32 master lives in the state."""
    params = init_params(cfg, seed, device)
    o = init_opt_state(params)
    state = {"params": params, "m": o["m"], "v": o["v"], "step": o["step"]}
    if master_in_opt:
        state["master"] = params
        state["params"] = T.map(lambda q: q.to(torch.bfloat16), params)
    return state


# ------------------------------------------------------------------- cells
def meta_params(cfg: ModelConfig, dtype=None) -> Dict[str, Any]:
    """The parameter tree as meta tensors in ``dtype`` (default
    ``cfg.param_dtype``): shapes and dtypes, no data and no random draw."""
    dtype = cfg.param_dtype if dtype is None else dtype
    return T.map(lambda shape: torch.empty(shape, dtype=dtype, device="meta"),
                 param_shapes(cfg))


def meta_train_state(cfg: ModelConfig, master_in_opt: bool = False) -> Dict[str, Any]:
    """:func:`make_train_state`'s tree as meta tensors."""
    params = meta_params(cfg)
    o = init_opt_state(params)
    state = {"params": params, "m": o["m"], "v": o["v"], "step": o["step"]}
    if master_in_opt:
        state["master"] = params
        state["params"] = meta_params(cfg, torch.bfloat16)
    return state


@dataclasses.dataclass
class Cell:
    """One (arch × shape) step on the meta device: ``fn(*args)`` runs it."""

    cfg: ModelConfig
    shape: str
    mode: str
    fn: Callable  # the step function
    args: Tuple[Any, ...]  # meta-tensor stand-ins

    def run(self):
        return self.fn(*self.args)


def make_cell(arch, shape: str, mesh=None, opts: StepOptions = StepOptions(), *,
              batch: Optional[int] = None) -> Cell:
    """The cell's step and its arguments as meta tensors.

    The step is the one the launchers run, with ``ShardCtx(plain=True)``:
    prefill's attention and scan take their plain versions, since no kernel
    takes meta tensors.  Prefill and decode take the compute-dtype weights
    the serving driver holds (``models.model.compute_params``), where JAX's
    cells take the float32 masters and cast them inside the step.
    ``batch`` overrides the shape's global batch (the dry run counts a few
    microbatches of a train cell and extrapolates).

    On ``mesh`` (JAX's ``make_cell`` on a mesh, ``repro/launch/steps.py:260``)
    the arguments are the rank's: the train state placed by
    :func:`train_state_shardings` (``step`` whole), the batch by
    ``batch_shardings`` (DTensors of the rank's rows), the microbatch count
    ``auto_microbatch(cfg, B, S, dp)``; prefill and decode the compute
    weights placed by ``param_shardings``, decode the rank's cache blocks
    (``init_cache`` on the mesh: ``cache_shardings``' blocks) and the
    tokens placed as the batch.
    """
    cfg = configs.get_config(arch) if isinstance(arch, str) else arch
    cell = configs.SHAPES[shape]
    B, S = cell.global_batch if batch is None else batch, cell.seq_len
    ctx = dataclasses.replace(make_shard_ctx(cfg, mesh, B, opts), plain=True)
    if opts.probe:
        opts = dataclasses.replace(opts, ce_chunk=S)

    def placed(tree, shardings):
        return tree if mesh is None else SH.place(tree, shardings)

    def weights():
        params = M.compute_params(cfg, meta_params(cfg))
        return placed(params, mesh and SH.param_shardings(cfg, params, mesh, opts.fsdp,
                                                          opts.mamba_tp))

    def batch_of(spec):
        return placed(spec, mesh and SH.batch_shardings(cfg, spec, mesh))

    if cell.mode == "train":
        dp = 1 if mesh is None else batch_shards(mesh)
        mb = opts.microbatch or auto_microbatch(cfg, B, S, dp)
        fn = build_train_step(cfg, ctx, opts, microbatch=mb)
        state = meta_train_state(cfg, opts.master_in_opt)
        state = placed(state, mesh and train_state_shardings(cfg, state, mesh, opts))
        args = (state, batch_of(data_batch_spec(cfg, B, S)))
    elif cell.mode == "prefill":
        fn = build_prefill_step(cfg, ctx, opts)
        spec = data_batch_spec(cfg, B, S)
        spec.pop("labels", None)
        args = (weights(), batch_of(spec))
    else:  # decode
        fn = build_decode_step(cfg, ctx, opts)
        tokens = batch_of({"tokens": torch.empty((B, 1), dtype=torch.int32, device="meta")})
        args = (weights(), M.init_cache(cfg, B, S, device="meta", ctx=ctx), tokens["tokens"])
    return Cell(cfg, shape, cell.mode, fn, args)


def make_dp_cell(cfg: ModelConfig, batch: int, seq: int, mesh, compress: bool = True,
                 ce_chunk: int = 512, opt: OptConfig = OptConfig()) -> Cell:
    """:func:`make_dp_train_step`'s step and one rank's arguments (state,
    error state, its ``batch`` × ``seq`` rows) as meta tensors: its
    collectives run as no-ops on meta tensors, and are recorded."""
    step, init_err = make_dp_train_step(cfg, mesh, opt, compress, ce_chunk)
    state = meta_train_state(cfg)
    args = (state, init_err(state["params"]), data_batch_spec(cfg, batch, seq))
    return Cell(cfg, f"dp_{batch}x{seq}", "train", step, args)
