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
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import configs
from ..device import resolve
from ..models import model as M
from ..models.common import init_params
from ..trace.monitor import ChimbukoMonitor
from ..trace.tracer import Tracer
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
) -> Dict:
    """Serve ``n_requests`` random prompts in waves of ``batch``.

    ``device=None`` is the port's default device (``cuda:0``; raises
    without CUDA).  ``params`` (float32 master weights on ``device``, e.g.
    carried from JAX by ``convert.params_from_jax``) replaces the port's own
    ``init_params(seed)``.
    """
    device = resolve(device)
    cfg = configs.smoke(arch) if smoke else configs.get_config(arch)
    assert not cfg.is_encoder, "decode serving needs a decoder arch"
    opts = StepOptions()
    ctx = make_shard_ctx(cfg, None, batch, opts)
    max_seq = prompt_len + max_new
    if params is None:
        params = init_params(cfg, seed, device)
    # Cast once; every step then computes with the same values JAX's per-call
    # casts give (see M.compute_params).
    params = M.compute_params(cfg, params)
    prefill_fn = build_prefill_step(cfg, ctx, opts, max_seq=max_seq)
    decode_fn = build_decode_step(cfg, ctx, opts)  # updates the cache in place

    own_monitor = monitor is None
    monitor = monitor or ChimbukoMonitor(num_funcs=16, min_samples=8)
    tracer = Tracer(monitor.registry, rank=0)

    rng = np.random.default_rng(seed)
    pending = [
        Request(i, rng.integers(0, cfg.vocab, prompt_len).astype(np.int32), max_new)
        for i in range(n_requests)
    ]
    finished: List[Request] = []
    step = 0
    t_start = time.perf_counter()
    tokens_out = 0
    while pending or finished is None:
        wave, pending = pending[:batch], pending[batch:]
        if not wave:
            break
        with tracer.span("serve/prefill"):
            prompts = np.stack([r.prompt for r in wave])
            if len(wave) < batch:  # pad the wave to the batch
                pad = np.tile(prompts[-1:], (batch - len(wave), 1))
                prompts = np.concatenate([prompts, pad])
            logits, cache = prefill_fn(params, {"tokens": torch.from_numpy(prompts).to(device)})
            next_tok = torch.argmax(logits[:, -1], dim=-1)
        for t in range(max_new):
            t0 = time.perf_counter()
            with tracer.span("serve/decode_step"):
                # One device sync per step for the whole wave's tokens.
                toks = next_tok.tolist()
                for i, r in enumerate(wave):
                    r.out.append(toks[i])
                tokens_out += len(wave)
                logits, cache = decode_fn(params, cache, next_tok[:, None].to(torch.int32))
                next_tok = torch.argmax(logits[:, 0], dim=-1)
            monitor.record_step_times(step, {0: time.perf_counter() - t0})
            step += 1
        finished.extend(wave)
        monitor.ingest(tracer.drain(step))
    dt = time.perf_counter() - t_start
    out = {
        "requests": len(finished),
        "tokens": tokens_out,
        "tok_per_s": tokens_out / dt if dt > 0 else 0.0,
        "monitor": monitor.summary(),
        "samples": [r.out[:8] for r in finished[:3]],
    }
    if own_monitor:
        monitor.close()
    return out


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
