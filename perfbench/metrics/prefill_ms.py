"""prefill_ms: device milliseconds of a wave's prefill and its first-token
argmax (CUDA events around the call), mean over every wave of the window."""


def read(run):
    ms = [w.prefill_ms for w in run.waves]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / len(ms)
