"""Whether what the timed path produced is correct.

After the window, a sample of its waves drawn from the seed (whole waves:
a routed layer batches a wave's requests together) is run through the
plain float32 reference: each prompt with its served tokens, the logits at
the position of every served token.  The numbers below are read; a cell
compares those that ``limits/<workload>.json`` gives a limit:

    gap            the widest gap by which a served (greedy) token's logit
                   lies below the reference's best at its position
    gap_p90        the 90th percentile (nearest rank) of those gaps
    logit_err      the largest |program - reference| logit at those positions
    logit_err_p50  the median (nearest rank) over positions of the
                   position's largest |program - reference| logit
    ad_labels      records the monitor labelled otherwise than the plain
                   mu +- alpha*sigma rule over the same spans (or missed)
    ad_stats       the largest relative gap between the monitor's count,
                   mean and standard deviation per function and the plain ones
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from . import spec as SP
from .stats import nearest_rank
from ..reference import chimbuko_ad


def sample_waves(n_waves: int, cell: SP.Cell, seed: int) -> List[int]:
    """Which waves to check: enough for ``check_tokens`` served tokens,
    drawn from the seed (all, where the run served fewer)."""
    t = cell.traffic
    want = math.ceil(t["check_tokens"] / (t["clients"] * t["max_new"]))
    rng = np.random.default_rng([seed, 2])
    return sorted(rng.choice(n_waves, size=min(want, n_waves), replace=False).tolist())


def served_inputs(waves, picked: Sequence[int], device):
    """(tokens (R, S + max_new - 1), served (R, max_new), groups) of the
    picked waves: each prompt followed by every served token but the last."""
    rows, served, groups = [], [], []
    for i in picked:
        w = waves[i]
        groups.append(list(range(len(rows), len(rows) + len(w.prompts))))
        rows += [np.concatenate([p, t[:-1]]) for p, t in zip(w.prompts, w.tokens)]
        served += list(w.tokens)
    return (torch.as_tensor(np.stack(rows), device=device),
            torch.as_tensor(np.stack(served), device=device), groups)


def program_logits(waves, picked: Sequence[int], vocab: int) -> torch.Tensor:
    """The program's float32 logits at the same positions: (R, max_new, vocab)."""
    return torch.cat([torch.stack(waves[i].logits, dim=1)[..., :vocab].float()
                      for i in picked])


def gaps(ref: torch.Tensor, chosen: torch.Tensor) -> List[float]:
    """Each position's gap of the chosen token's reference logit below the best."""
    picked = ref.gather(-1, chosen[..., None])[..., 0]
    return (ref.amax(-1) - picked).flatten().tolist()


def logit_numbers(ref: torch.Tensor, got: torch.Tensor, chosen: torch.Tensor,
                  prefix: str = "") -> Dict[str, float]:
    """The logit numbers of ``got`` (whose tokens were ``chosen``) against ``ref``."""
    g = gaps(ref, chosen)
    err = (got - ref).abs().amax(-1).flatten().tolist()
    return {f"{prefix}gap": max(g), f"{prefix}gap_p90": nearest_rank(g, 0.9),
            f"{prefix}logit_err": max(err), f"{prefix}logit_err_p50": nearest_rank(err, 0.5)}


def model_numbers(cell: SP.Cell, weights, waves, picked, device,
                  quant: Optional[str] = None) -> Dict[str, float]:
    """The logit numbers of the picked waves; with ``quant`` also those of
    the reference computed at that precision in the program's place."""
    m = cell.model
    tokens, served, groups = served_inputs(waves, picked, device)
    family = SP.reference(cell.conf["reference"])
    ref = family.logits(m, weights, tokens, served.shape[1], groups=groups,
                        prompt_len=cell.traffic["prompt_len"])
    prog = program_logits(waves, picked, m["vocab"]).to(ref.device)
    out = {**logit_numbers(ref, prog, served), "tokens": int(served.numel())}
    if quant is not None:
        low = family.logits(m, weights, tokens, served.shape[1], groups=groups,
                            prompt_len=cell.traffic["prompt_len"], quant=quant)
        out.update(logit_numbers(ref, low, low.argmax(-1), f"{quant}_"))
    return out


def monitor_numbers(waves, monitor, min_samples: int, alpha: float) -> Dict[str, float]:
    labels, stats = chimbuko_ad.replay([w.frame for w in waves], min_samples, alpha)
    mismatch = chimbuko_ad.label_mismatches(labels, [w.records for w in waves])
    table = monitor.ps.snapshot().table
    return {"ad_labels": float(mismatch), "ad_stats": chimbuko_ad.stats_gap(stats, table)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number the cell limits is within its limit."""
    return all(numbers[k] <= limit for k, limit in limits.items())


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    return {k: {"value": numbers[k], "limit": limit} for k, limit in limits.items()}


def check(cell: SP.Cell, weights, waves, monitor, seed: int, device,
          min_samples: int, alpha: float) -> Dict[str, float]:
    picked = sample_waves(len(waves), cell, seed)
    numbers = model_numbers(cell, weights, waves, picked, device)
    numbers.update(monitor_numbers(waves, monitor, min_samples, alpha))
    numbers["waves_checked"] = len(picked)
    return numbers
