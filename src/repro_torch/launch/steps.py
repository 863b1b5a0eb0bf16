"""Step builders (port of ``repro.launch.steps``): train, prefill, decode.

One device, eager PyTorch: there is no ``jit``, and the step functions are
plain closures over the config.  The train step takes the gradients with
autograd (``torch.autograd.grad``) and updates the state in place, where
JAX donates it (``donate=False`` works on a copy instead).  Meshes, FSDP,
sequence parallelism and the data-parallel step wait for ROADMAP.md
queue 1, item 11; the dry-run's probe mode for item 12.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import tree as T
from .._unported import unported
from ..models import model as M
from ..models.common import ModelConfig, init_params
from ..models.model import ShardCtx
from ..optim.adamw import OptConfig, apply_updates, init_opt_state


@dataclasses.dataclass(frozen=True)
class StepOptions:
    remat: str = "block"  # none | block
    fsdp: bool = True  # read only with a mesh
    ce_chunk: int = 1024
    microbatch: int = 0  # gradient-accumulation steps; 0 = auto (fit memory)
    seq_shard: bool = False  # sequence-parallel hidden states: needs a mesh
    donate: bool = True  # the train step updates its state in place
    probe: bool = False  # unrolled cost-accounting compile (dryrun --probes)
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
    if mesh is not None:
        raise unported("meshes", 11)
    if opts.seq_shard:
        raise unported("StepOptions(seq_shard=True) (a mesh)", 11)
    if opts.probe:
        raise unported("StepOptions(probe=True) (the dry run)", 12)
    return ShardCtx(remat=opts.remat)


# ------------------------------------------------------------ step fns
def _split(name: str, x: torch.Tensor, nm: int) -> torch.Tensor:
    """(nm, B/nm, ...) microbatches; pos3 (3, B, S) keeps its batch on axis 1."""
    if name == "pos3":
        return x.reshape((3, nm, x.shape[1] // nm) + tuple(x.shape[2:])).transpose(0, 1)
    return x.reshape((nm, x.shape[0] // nm) + tuple(x.shape[1:]))


def build_train_step(
    cfg: ModelConfig, ctx: ShardCtx, opts: StepOptions, microbatch: Optional[int] = None
) -> Callable:
    nm_cfg = microbatch if microbatch is not None else max(opts.microbatch, 1)

    def loss_and_grads(params, batch):
        """-> (loss, metrics, grads tree): jax.value_and_grad(has_aux=True)."""
        live = [t.detach().requires_grad_(True) for t in T.leaves(params)]
        with torch.enable_grad():
            loss, metrics = M.loss_and_metrics(cfg, T.unflatten(params, live), batch, ctx,
                                               opts.ce_chunk)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, live)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            T.unflatten(params, grads)

    def train_step(state, batch) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        if not opts.donate:
            state = T.map(torch.clone, state)
        if nm_cfg > 1:
            nm = nm_cfg
            mb = {k: _split(k, v, nm) for k, v in batch.items()}
            gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                    for p in T.leaves(state["params"])]
            lsum = torch.zeros((), dtype=torch.float32, device=gsum[0].device)
            for i in range(nm):  # summed in microbatch order, as lax.scan
                loss, _, grads = loss_and_grads(state["params"], {k: v[i] for k, v in mb.items()})
                for acc, g in zip(gsum, T.leaves(grads)):
                    acc.add_(g)
                lsum = lsum + loss
                del grads
            grads = T.unflatten(state["params"], [g / nm for g in gsum])
            del gsum
            zero = torch.zeros_like(lsum)
            metrics = {"loss": lsum / nm, "accuracy": zero, "tokens": zero}
        else:
            _, metrics, grads = loss_and_grads(state["params"], batch)
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
    def decode_step(params, cache, tokens):
        return M.decode_step(cfg, params, cache, tokens, ctx)

    return decode_step


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
