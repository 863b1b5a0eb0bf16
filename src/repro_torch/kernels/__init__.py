"""Hand-written Hopper kernels for the port's hot spots.

csrc/<name>.cu   CUDA C++ for sm_90a with a plain C interface
_build.py        nvcc build at first use, ctypes loading
<name>.py        the wrapper: checks, launch, launch counter
ops.py           public wrappers in the torch_ad table layout
ref.py           plain PyTorch versions (CPU path, allclose ground truth)
"""
