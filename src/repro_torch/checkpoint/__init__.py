"""Atomic, async checkpointing (port of ``repro.checkpoint``)."""
from . import ckpt  # noqa: F401
