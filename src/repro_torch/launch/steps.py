"""Step builders for serving (port of the serving part of ``repro.launch.steps``).

One device, eager PyTorch: there is no ``jit``, and the step functions are
plain closures over the config.  Meshes, FSDP and the train step wait for
ROADMAP.md queue 1, items 5 and 11.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..models import model as M
from ..models.common import ModelConfig
from ..models.model import ShardCtx


@dataclasses.dataclass(frozen=True)
class StepOptions:
    """A placeholder: serving reads no step option.  The JAX package's
    training and sharding options (remat, fsdp, ce_chunk, microbatch,
    seq_shard, master_in_opt, mamba_tp, opt) arrive with the train step
    (ROADMAP.md queue 1, item 5); the decode cache is always updated in
    place, where JAX donates it."""


def make_shard_ctx(cfg: ModelConfig, mesh, global_batch: int, opts: StepOptions) -> ShardCtx:
    if mesh is not None:
        raise NotImplementedError(
            "meshes are not ported to repro_torch yet (ROADMAP.md queue 1, item 11)")
    return ShardCtx()


def build_prefill_step(cfg: ModelConfig, ctx: ShardCtx, opts: StepOptions,
                       max_seq=None) -> Callable:
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch, ctx, max_seq=max_seq)

    return prefill_step


def build_decode_step(cfg: ModelConfig, ctx: ShardCtx, opts: StepOptions) -> Callable:
    def decode_step(params, cache, tokens):
        return M.decode_step(cfg, params, cache, tokens, ctx)

    return decode_step
