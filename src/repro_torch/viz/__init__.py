"""Visualization data products (paper Figs. 3-6): the port's copy of
``repro.viz.server``.  The live gateway (``repro.viz.{gateway,http,ws}``)
waits for ROADMAP.md queue 1, item 2d."""
from . import server  # noqa: F401
from .server import VizServer  # noqa: F401

__all__ = ["VizServer", "server"]
