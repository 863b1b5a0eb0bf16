"""mfu.prefill_mla: the prefill's model operations (peaks_mla.prefill_flops:
MLA's projections and attention, the dense, routed and shared experts'
SwiGLUs, the last position's logits) over its mean device time (CUDA events
around each wave's prefill and argmax, as prefill_ms), as a share of the
bf16 peak of the cell's cards, %."""
from perfbench.harness import peaks, peaks_mla


def read(run):
    ms = [w.prefill_ms for w in run.waves]
    if not ms or any(m is None for m in ms):
        return None
    t = run.traffic
    flops = peaks_mla.prefill_flops(run.model, t["clients"], t["prompt_len"])
    return 100.0 * peaks.mfu(flops, sum(ms) / len(ms) / 1e3, int(run.cell.workload["chips"]))
