"""Visualization data products (paper Figs. 3-6) and the live gateway.

:mod:`server` computes the view data; :mod:`gateway` serves it — HTTP GET
for every view (plus ``/trace`` for Perfetto's open-with-URL) and a
WebSocket broadcast of per-frame anomaly deltas — on the
:mod:`repro_torch.net.server` event loop.  :mod:`http` and :mod:`ws` are the
incremental protocol codecs underneath, fuzz-locked by
``tests/test_viz_gateway.py``.
"""
from . import server  # noqa: F401
from .server import VizServer  # noqa: F401

__all__ = ["VizServer", "server"]
