"""tok_per_s: prompt and generated tokens completed in the window, over the
whole window (host clock)."""
from perfbench.harness import stats


def read(run):
    return stats.tokens_per_s(run.waves, run.t0, run.t_close)
