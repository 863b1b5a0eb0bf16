"""Synthetic, deterministic, host-sharded data pipeline (port of ``repro.data``)."""
from . import pipeline  # noqa: F401
