"""mla_prefill_ms: device milliseconds of the program's ``mla/prefill``
spans (the whole MLA mixer of a prefill: projections, rope, pads, flash,
crop and wo, ``models/model.py:_mla_seq_with_cache``), summed over a wave's
layers, mean over the traced waves."""
from perfbench.harness import program_spans


def read(run):
    return program_spans.device_ms_per_wave(run, "mla/prefill")
