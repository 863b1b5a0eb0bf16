"""flash_roofline: the flash-attention kernel's least time per launch
(peaks.flash_bound: causal bf16 at the prefill's B, S and heads) over its
device time per launch in the traced waves, %."""
from perfbench.harness import peaks

KERNEL = "flash_fwd"


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel(KERNEL)
    if not launches:
        return None
    m, t = run.model, run.traffic
    bound = peaks.flash_bound(t["clients"], t["prompt_len"], m["n_heads"], m["n_kv_heads"],
                              m["head_dim"])["bound_s"]
    return 100.0 * bound * launches / seconds
