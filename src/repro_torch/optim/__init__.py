"""Optimizers (port of ``repro.optim``; ``compression`` waits for ROADMAP.md
queue 1, item 11)."""
from . import adamw  # noqa: F401
