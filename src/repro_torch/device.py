"""Where the port runs, and the numeric switches a parity run pins."""
from __future__ import annotations

from typing import Dict

import torch


def default_device() -> torch.device:
    """The device entry points use when the caller names none: ``cuda:0``.

    Raises when CUDA is absent.  It never returns the CPU: a caller that
    wants the CPU (the tests do) passes ``device="cpu"`` explicitly.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA and found no CUDA device; "
            "pass device='cpu' explicitly to run the plain PyTorch versions"
        )
    return torch.device("cuda", 0)


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or :func:`default_device` for None."""
    return default_device() if device is None else torch.device(device)


def parity_mode() -> Dict[str, bool]:
    """Pin float32 products to full float32 (no TF32) and return the setting.

    A float32 matmul on the card is full float32 by default, but a float32
    convolution goes through cuDNN in TF32 by default; parity runs against
    the JAX reference turn both off.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {
        "torch.backends.cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "torch.backends.cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
    }
