"""The arithmetic of the host-clock metrics, over all the work of a window."""
from __future__ import annotations

import math
from typing import Iterable, List


def nearest_rank(values: Iterable[float], q: float) -> float:
    """The q-quantile by nearest rank: the ceil(q * n)-th smallest value."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(0, math.ceil(q * len(v)) - 1)]


def tokens_per_s(waves, t0: float, t_close: float) -> float:
    """Prompt and generated tokens that reached the host in [t0, t_close],
    over the whole of it: a wave's prompt tokens count with its first
    tokens, each generated token when it is on the host."""
    n = sum(k for w in waves for t, k in w.emitted if t0 <= t <= t_close)
    return n / (t_close - t0)


def ttfts(waves) -> List[float]:
    """Every request's time from its submission to its first token on the host."""
    return [w.t_first - w.submit for w in waves for _ in range(len(w.prompts))]
