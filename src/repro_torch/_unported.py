"""The error for a part of the JAX package the port does not have yet.

Options of the copied modules whose backing module is not ported (the
decode caches' placements and the dry run on a mesh: item 11) raise it
when asked for, instead of importing ``repro`` or skipping the option
quietly.
"""
from __future__ import annotations


def unported(what: str, item) -> NotImplementedError:
    """``what`` waits for ROADMAP.md queue 1, item ``item``."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md queue 1, item {item})"
    )
