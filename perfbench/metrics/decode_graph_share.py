"""decode_graph_share: the share of the traced ``model/decode_step`` spans
whose ``graphed`` arg is 1 (the step replayed from a CUDA graph), %.  A
program whose steps carry no ``graphed`` arg runs them eagerly and reads 0;
a run without the program's spans on the card gives nothing."""
from perfbench.harness import program_spans


def read(run):
    steps = [s for s in program_spans.spans(run) if s.name == "model/decode_step"]
    if not steps:
        return None
    return 100.0 * sum((s.args or {}).get("graphed") == 1 for s in steps) / len(steps)
