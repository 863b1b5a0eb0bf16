"""The run's process may hold no module of JAX or of the JAX package.

Module names are compared by their top-level name, whole: ``repro_torch``
(the port) begins with ``repro`` (the JAX package) and is allowed.
"""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: ``sys.modules``)."""
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None else names)}
    return sorted(tops.intersection(FORBIDDEN))
