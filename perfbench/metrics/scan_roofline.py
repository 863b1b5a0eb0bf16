"""scan_roofline: the selective-scan kernel's least time per launch
(peaks.scan_bound at the prefill's B, S, d_inner, d_state) over its device
time per launch in the traced waves, %."""
from perfbench.harness import peaks

KERNEL = "mamba_scan_fwd"


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel(KERNEL)
    if not launches:
        return None
    m, t = run.model, run.traffic
    bound = peaks.scan_bound(t["clients"], t["prompt_len"], m["ssm_expand"] * m["d_model"],
                             m["ssm_d_state"])["bound_s"]
    return 100.0 * bound * launches / seconds
