"""moe_drop_share: the share of the routed (token, expert) pairs of the
traced waves' prefills that their experts' capacity dropped: 1 - the sum
of the ``moe`` spans' ``kept`` over the sum of their ``pairs`` (N·k), %.
A program whose ``moe`` spans count no ``pairs`` gives nothing."""
from perfbench.harness import program_spans


def read(run):
    moe = program_spans.under_prefill(program_spans.spans(run), "moe")
    if not moe or any("pairs" not in (s.args or {}) for s in moe):
        return None
    pairs = sum(s.args["pairs"] for s in moe)
    return 100.0 * (1.0 - sum(s.args["kept"] for s in moe) / pairs) if pairs else None
