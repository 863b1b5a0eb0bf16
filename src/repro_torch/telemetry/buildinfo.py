"""Build identity for the running analysis fleet (satellite of tracing).

One info-style gauge -- ``repro_build_info`` with value 1 and the build
coordinates as labels -- makes every ``/metrics`` exposition and every
``BENCH_*.json`` row attributable to an exact build: the git commit the
tree was at, plus the interpreter and key library versions (the port's
copy of ``repro.telemetry.buildinfo`` labels torch where the original
labels jax).  The lookup
runs once per process (subprocess + metadata probes are not free) and is
safe everywhere: a missing git binary, a non-repo checkout, or an
uninstalled library all degrade to ``"unknown"``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
from typing import Dict, Optional

from .registry import get_registry

__all__ = ["build_info", "register_build_info"]

_lock = threading.Lock()
_info: Optional[Dict[str, str]] = None
_registered = False


def _git_sha() -> str:
    sha = os.environ.get("REPRO_BUILD_SHA")
    if sha:
        return sha
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short=12", "HEAD"],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=10,
        )
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        pass
    return "unknown"


def _dist_version(name: str) -> str:
    try:
        from importlib import metadata

        return metadata.version(name)
    except Exception:
        return "unknown"


def build_info() -> Dict[str, str]:
    """The build coordinates, computed once per process."""
    global _info
    with _lock:
        if _info is None:
            _info = {
                "git_sha": _git_sha(),
                "python": "%d.%d.%d" % sys.version_info[:3],
                "numpy": _dist_version("numpy"),
                "torch": _dist_version("torch"),
            }
        return dict(_info)


def register_build_info() -> Dict[str, str]:
    """Set the ``repro_build_info`` gauge (idempotent); returns the labels."""
    global _registered
    info = build_info()
    with _lock:
        if not _registered:
            _registered = True
            get_registry().gauge(
                "repro_build_info",
                "Build identity of this process (value is always 1; the"
                " labels carry the coordinates).",
                labelnames=sorted(info),
            ).labels(**info).set(1)
    return info
