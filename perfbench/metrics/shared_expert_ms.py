"""shared_expert_ms: device milliseconds of the program's ``moe/shared``
spans (the shared experts' SwiGLU on every token, ``models/model.py:
_mlp_apply``) under prefill, summed over a wave's layers, mean over the
traced waves."""
from perfbench.harness import program_spans


def read(run):
    return program_spans.device_ms_per_wave(run, "moe/shared")
