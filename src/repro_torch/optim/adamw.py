"""AdamW with warmup+cosine schedule and global-norm clipping (port of
``repro.optim.adamw``).

The step, the learning rate, the bias corrections, the clip scale and the
norm are tensors on the parameters' device (int32 and float32, as JAX keeps
them): a Python float is float64 and would move lr by an ulp, and reading
one back with ``.item()`` would wait for the device every step.  Python
constants enter the float32 arithmetic as JAX's weakly typed scalars do,
rounded to float32 first.

``apply_updates`` works leaf by leaf under ``torch.no_grad()`` and writes
the new m, v and parameters into the old tensors, which the caller gives up
(JAX donates the state instead).  At gemma-2b's full width that keeps the
update's transient memory to a few copies of one leaf (the embedding:
256000 × 2048 float32, 2.1 GB), not a second 30 GB state.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from .. import tree as T


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """float32 learning rate at ``step`` (an integer tensor)."""
    step = step.to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0, 1.0,
    )
    # cos of the float32 argument, rounded once from float64: XLA's float32
    # cos gives these values, and torch's CPU float32 cos is an ulp off at
    # some steps
    cos_t = torch.cos((math.pi * t).to(torch.float64)).to(torch.float32)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + cos_t)
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params) -> Dict[str, Any]:
    leaves = T.leaves(params)
    device = leaves[0].device if leaves else None
    return {"m": T.map(torch.zeros_like, params), "v": T.map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the float32 sum of squares, summed leaf by leaf in
    ``jax.tree.leaves`` order."""
    total = 0
    for g in T.leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def apply_updates(
    params, grads, opt_state, cfg: OptConfig
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """-> (params, opt_state, {"grad_norm", "lr"}); the returned params, m
    and v are the tensors passed in, updated in place."""
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))

    def upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        del g
        delta = (m / b1c).div_(torch.sqrt(v / b2c).add_(cfg.eps))
        delta.add_(cfg.weight_decay * p.to(torch.float32))
        p.copy_(p.to(torch.float32) - lr * delta)

    for p, g, m, v in zip(T.leaves(params), T.leaves(grads), T.leaves(opt_state["m"]),
                          T.leaves(opt_state["v"])):
        upd(p, g, m, v)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}, {
        "grad_norm": gnorm, "lr": lr,
    }
