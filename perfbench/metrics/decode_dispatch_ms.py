"""decode_dispatch_ms: the host time of the program's ``model/decode_step``
spans (the step's enqueue, entry to return, before its tokens are read),
the 90th percentile (nearest rank) over the traced decode steps."""
from perfbench.harness import program_spans, stats


def read(run):
    steps = [s.dur_us / 1e3 for s in program_spans.spans(run) if s.name == "model/decode_step"]
    return stats.nearest_rank(steps, 0.9) if steps else None
