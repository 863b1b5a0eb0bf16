"""mamba_prefill_ms: device milliseconds of the program's ``mamba/prefill``
spans (the whole Mamba mixer of a prefill, ``models/mamba.py:mamba_prefill``),
summed over a wave's layers, mean over the traced waves."""
from perfbench.harness import program_spans


def read(run):
    return program_spans.device_ms_per_wave(run, "mamba/prefill")
