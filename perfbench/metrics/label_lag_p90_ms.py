"""label_lag_p90_ms: for every span the monitor labelled in the window, the
time from the span's end to the return of the ingest that labelled it; the
90th percentile (nearest rank) over all of them."""
import numpy as np

from perfbench.harness import stats


def read(run):
    lags = np.concatenate([w.label_lag_s for w in run.waves])
    return 1e3 * stats.nearest_rank(lags.tolist(), 0.9) if lags.size else None
