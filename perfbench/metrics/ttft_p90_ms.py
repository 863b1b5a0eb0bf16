"""ttft_p90_ms: the 90th percentile (nearest rank) over every request of
the window of its time from submission to its first token on the host."""
from perfbench.harness import stats


def read(run):
    return 1e3 * stats.nearest_rank(stats.ttfts(run.waves), 0.9)
