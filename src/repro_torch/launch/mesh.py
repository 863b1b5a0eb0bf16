"""Mesh queries (port of ``repro.launch.mesh``).

A mesh is a ``torch.distributed`` ``DeviceMesh`` (``compat.make_mesh``):
its dims are named by ``mesh_dim_names`` and sized by ``shape``.  The
queries below read nothing else, so they hold for any object with those
two attributes.  :func:`make_production_mesh` builds JAX's production
meshes over the process group's ranks.
"""
from __future__ import annotations

import math
from typing import Tuple


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """JAX's production mesh: (data=16, model=16), or with ``multi_pod``
    (pod=2, data=16, model=16), over the first ranks of the default process
    group (which must be initialised).  Raises ``RuntimeError`` when the
    group has fewer ranks than the mesh, as JAX's does with too few
    devices."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 0
    if world < n:
        raise RuntimeError(f"mesh {shape} needs {n} ranks, the process group has {world}: "
                           f"start {n} processes (or a fake process group of world size {n})")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


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
