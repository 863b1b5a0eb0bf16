"""setup_s: from the process's start to the window's first request: imports,
the weights made from the seed, the kernels built (nvcc, on a checkout's
first run only: the result line gives those seconds apart as ``build_s``)
or found, and one warm-up wave of the cell's shapes."""


def read(run):
    return run.setup_s
