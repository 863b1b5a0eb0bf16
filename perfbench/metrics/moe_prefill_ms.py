"""moe_prefill_ms: device milliseconds of the program's ``moe`` spans under
``model/prefill`` (routing, dispatch, expert GEMMs and combine,
``models/moe.py:moe_local``), summed over a wave's layers, mean over the
traced waves."""
from perfbench.harness import program_spans


def read(run):
    return program_spans.device_ms_per_wave(run, "moe")
