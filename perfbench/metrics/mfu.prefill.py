"""mfu.prefill: the prefill's model operations (peaks.prefill_flops) over
its mean device time (prefill_ms), as a share of the bf16 peak of the
cell's cards (chips × one card's), %."""
from perfbench.harness import peaks


def read(run):
    ms = [w.prefill_ms for w in run.waves]
    if not ms or any(m is None for m in ms):
        return None
    t = run.traffic
    flops = peaks.prefill_flops(run.model, t["clients"], t["prompt_len"])
    return 100.0 * peaks.mfu(flops, sum(ms) / len(ms) / 1e3, int(run.cell.workload["chips"]))
