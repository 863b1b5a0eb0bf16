"""Optimizers (port of ``repro.optim``): AdamW, placed on a mesh too, and the
int8 gradient compression of the data-parallel step."""
from . import adamw  # noqa: F401
