"""moe_slot_fill: the share of the expert buffer's capacity slots that hold
a routed (token, expert) pair in the traced waves' prefills: the sum of the
``moe`` spans' ``kept`` over the sum of their ``slots`` (experts × capacity),
%; the rest is the buffer's padding."""
from perfbench.harness import program_spans


def read(run):
    moe = program_spans.under_prefill(program_spans.spans(run), "moe")
    slots = sum(s.args["slots"] for s in moe)
    return 100.0 * sum(s.args["kept"] for s in moe) / slots if slots else None
