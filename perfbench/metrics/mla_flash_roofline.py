"""mla_flash_roofline: the least time per launch of MLA's causal attention
on its unpadded widths (peaks_mla.flash_bound at the prefill's B, S, heads,
nope + rope and v) over the flash kernel's device time per launch in the
traced waves, %.  The kernel computes at the padded head dim, so padding
shows as a lower share."""
from perfbench.harness import peaks_mla

KERNEL = "flash_fwd"


def read(run):
    if run.trace is None:
        return None
    seconds, launches = run.trace.kernel(KERNEL)
    if not launches:
        return None
    m, t = run.model, run.traffic
    bound = peaks_mla.flash_bound(t["clients"], t["prompt_len"], m["n_heads"],
                                  m["qk_nope_dim"] + m["qk_rope_dim"],
                                  m["v_head_dim"])["bound_s"]
    return 100.0 * bound * launches / seconds
