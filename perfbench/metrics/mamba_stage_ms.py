"""mamba_stage_ms: device milliseconds of the program's ``mamba/stage``
spans (the scan's elements a = exp(dt·A) and b = (dt·x)·B built in float32,
``models/mamba.py:mamba_prefill``), summed over a wave's layers, mean over
the traced waves."""
from perfbench.harness import program_spans


def read(run):
    return program_spans.device_ms_per_wave(run, "mamba/stage")
