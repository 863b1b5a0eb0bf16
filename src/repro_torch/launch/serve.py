"""Serving driver (port of ``repro.launch.serve``): batched prefill + decode
with Chimbuko monitoring.

Continuous-batching-lite: a request queue fills decode slots; each decode
step advances every active slot one token; finished requests free slots.
Per-phase tracing (prefill/decode) streams to the port's own
``ChimbukoMonitor``; decode step-time anomalies (e.g. a slow host) surface
exactly like the paper's workflow delays.  On the card, prefill attention
runs the hand-written flash kernel and a Mamba layer's prefill the
hand-written selective-scan kernel; the serving loop is the same for both
families (the decode cache is whatever ``prefill`` builds).

Usage (on a CUDA card; ``--device cpu`` runs the plain versions):
  python -m repro_torch.launch.serve --arch gemma-2b --requests 8 --max-new 16
  python -m repro_torch.launch.serve --arch gemma-2b --full --prompt-len 1024 --max-new 32
  python -m repro_torch.launch.serve --arch falcon-mamba-7b --full --prompt-len 1024 --max-new 32
  python -m repro_torch.launch.serve --arch granite-moe-1b-a400m --full --prompt-len 1024 \
      --max-new 32
  python -m repro_torch.launch.serve --arch minicpm3-4b --full --prompt-len 1024 --max-new 32
A monitor built with ``ChimbukoMonitor(viz_serve=PORT)`` and passed as
``monitor=`` serves the run live (HTTP views, ``/trace``, WebSocket frames).

On a mesh (``mesh=``, a ``DeviceMesh`` over the open process group; every
rank calls ``serve`` alike) the weights are placed across the ranks
(``launch.sharding.placed_compute_params``, built leaf by leaf, so no rank
holds the whole model) and gathered a layer at a time, the experts kept
split (expert parallelism over the model axis), and the caches hold each
rank's blocks (``cache_shardings``: attention by sequence, Mamba's state
by d_inner channels); the next tokens of a batch split over the batch
axes are gathered, so every rank feeds the global batch.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from torch.distributed.tensor import DTensor

from .. import configs
from .. import tree as T
from ..device import resolve
from ..models import model as M
from ..models.common import ModelConfig, init_params
from ..trace.monitor import ChimbukoMonitor
from ..trace.tracer import Tracer
from .sharding import placed_compute_params
from .steps import StepOptions, build_decode_step, build_prefill_step, make_shard_ctx


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) int32
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


def serve(
    arch: str = "gemma-2b",
    smoke: bool = True,
    n_requests: int = 8,
    batch: int = 4,
    prompt_len: int = 16,
    max_new: int = 16,
    seed: int = 0,
    monitor: Optional[ChimbukoMonitor] = None,
    *,
    params=None,
    device=None,
    mesh=None,
    config: Optional[ModelConfig] = None,
    prompts=None,
) -> Dict:
    """Serve ``n_requests`` random prompts in waves of ``batch``.

    ``prompts`` (an (n, S) array of token ids) replaces them: n requests
    of S tokens.  A wave's Chimbuko span ``serve/prefill`` ends when the
    first tokens are on the host, and each ``serve/decode_step`` but the
    last when its tokens are.  The result's ``per_request`` rows give
    each request's ``rid``, ``queued_s`` (when its wave left the queue),
    ``first_token_s`` and ``done_s`` (its last token on the host), in
    seconds from serve's start on the program's clock
    (``time.perf_counter``, the tracer's).

    ``device=None`` is the port's default device (``cuda:0``; raises
    without CUDA).  ``params`` (float32 master weights on ``device``, e.g.
    carried from JAX by ``convert.params_from_jax``, or compute weights, on
    a mesh placed ones) replaces the port's own ``init_params(seed)``, on
    ``mesh`` ``placed_compute_params(seed)``.  ``config`` replaces
    ``arch``'s config (a cut one).
    """
    device = resolve(device)
    cfg = config or (configs.smoke(arch) if smoke else configs.get_config(arch))
    assert not cfg.is_encoder, "decode serving needs a decoder arch"
    if prompts is not None:
        prompts = np.asarray(prompts, dtype=np.int32)
        if prompts.ndim != 2:
            raise ValueError(f"prompts is an (n, S) array of token ids, got {prompts.shape}")
        n_requests, prompt_len = prompts.shape
    opts = StepOptions()
    ctx = make_shard_ctx(cfg, mesh, batch, opts)
    max_seq = prompt_len + max_new
    if params is None:
        params = init_params(cfg, seed, device) if mesh is None else \
            placed_compute_params(cfg, seed, mesh, device=device)
    # Cast once; every step then computes with the same values JAX's per-call
    # casts give (see M.compute_params).
    params = M.compute_params(cfg, params)
    if mesh is not None and not any(isinstance(t, DTensor) for t in T.leaves(params)):
        params = M.local_params(cfg, params, ctx)  # whole weights: the rank's experts
    prefill_fn = build_prefill_step(cfg, ctx, opts, max_seq=max_seq)
    decode_fn = build_decode_step(cfg, ctx, opts)  # updates the cache in place

    own_monitor = monitor is None
    monitor = monitor or ChimbukoMonitor(num_funcs=16, min_samples=8)
    tracer = Tracer(monitor.registry, rank=0)

    if prompts is None:
        rng = np.random.default_rng(seed)
        prompts = [rng.integers(0, cfg.vocab, prompt_len).astype(np.int32)
                   for _ in range(n_requests)]
    pending = [Request(i, prompt, max_new) for i, prompt in enumerate(prompts)]
    finished: List[Request] = []
    rows: List[dict] = []
    step = 0
    t_start = time.perf_counter()
    tokens_out = 0
    while pending:
        wave, pending = pending[:batch], pending[batch:]
        t_wave = time.perf_counter() - t_start
        with tracer.span("serve/prefill"):
            wave_prompts = np.stack([r.prompt for r in wave])
            if len(wave) < batch:  # pad the wave to the batch
                pad = np.tile(wave_prompts[-1:], (batch - len(wave), 1))
                wave_prompts = np.concatenate([wave_prompts, pad])
            logits, cache = prefill_fn(
                params, {"tokens": torch.from_numpy(wave_prompts).to(device)})
            next_tok = _global_rows(ctx, torch.argmax(logits[:, -1], dim=-1), batch)
            toks = next_tok.tolist()  # the first tokens on the host
        t_first = t_toks = t_done = time.perf_counter() - t_start
        for t in range(max_new):
            t0 = time.perf_counter()
            with tracer.span("serve/decode_step"):
                for i, r in enumerate(wave):
                    r.out.append(toks[i])
                tokens_out += len(wave)
                t_done = t_toks  # when the tokens just appended reached the host
                # the last step's decode, as JAX's loop runs it, gives no token
                logits, cache = decode_fn(params, cache, next_tok[:, None].to(torch.int32))
                next_tok = _global_rows(ctx, torch.argmax(logits[:, 0], dim=-1), batch)
                if t + 1 < max_new:
                    toks = next_tok.tolist()  # one device sync a step for the wave's tokens
                    t_toks = time.perf_counter() - t_start
            monitor.record_step_times(step, {0: time.perf_counter() - t0})
            step += 1
        rows += [dict(rid=r.rid, queued_s=t_wave, first_token_s=t_first, done_s=t_done)
                 for r in wave]
        finished.extend(wave)
        monitor.ingest(tracer.drain(step))
    dt = time.perf_counter() - t_start
    out = {
        "requests": len(finished),
        "tokens": tokens_out,
        "tok_per_s": tokens_out / dt if dt > 0 else 0.0,
        "monitor": monitor.summary(),
        "samples": [r.out[:8] for r in finished[:3]],
        "per_request": rows,
    }
    if own_monitor:
        monitor.close()
    return out


def _global_rows(ctx, t: torch.Tensor, batch: int) -> torch.Tensor:
    """A per-row tensor of a global batch of ``batch`` whose rank holds its
    rows, whole: gathered over the batch axes where the mesh splits them."""
    if ctx.mesh is None or not ctx.for_pass(batch, 1).batch_split:
        return t
    for axis in reversed(ctx.batch_axes):
        t = torch.cat(ctx.all_gather(t, axis), dim=0)
    return t


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full", action="store_true",
                    help="the published width instead of the smoke config")
    ap.add_argument("--device", default=None, help="default: cuda:0")
    args = ap.parse_args()
    out = serve(
        arch=args.arch, smoke=not args.full, n_requests=args.requests, batch=args.batch,
        prompt_len=args.prompt_len, max_new=args.max_new, device=args.device,
    )
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()
