"""Mesh queries (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` (``compat.make_mesh``):
its dims are named by ``mesh_dim_names`` and sized by ``shape``.  The
queries below read nothing else, so they hold for any object with those
two attributes.  The production meshes (JAX: 16 × 16 and 2 × 16 × 16
devices) need parameters placed across cards: ROADMAP.md item 11.
"""
from __future__ import annotations

from typing import Tuple

from .._unported import unported


def make_production_mesh(*, multi_pod: bool = False):
    raise unported("make_production_mesh (a multi-card mesh with DTensor placements)", 11)


def _size(mesh, name: str) -> int:
    return mesh.shape[tuple(mesh.mesh_dim_names).index(name)]


def batch_axes(mesh) -> Tuple[str, ...]:
    """Axes the global batch shards over (everything except 'model')."""
    return tuple(n for n in mesh.mesh_dim_names if n != "model")


def batch_shards(mesh) -> int:
    n = 1
    for a in batch_axes(mesh):
        n *= _size(mesh, a)
    return n


def tp_size(mesh) -> int:
    return _size(mesh, "model")
