"""decode_step_p90_ms: the 90th percentile (nearest rank) over every decode
step of the window of its host time, ending when its tokens are on the host."""
from perfbench.harness import stats


def read(run):
    steps = [s for w in run.waves for s in w.step_s]
    return 1e3 * stats.nearest_rank(steps, 0.9) if steps else None
