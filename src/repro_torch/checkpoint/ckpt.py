"""Fault-tolerant checkpointing: atomic, async (port of ``repro.checkpoint.ckpt``).

The on-disk format is the JAX package's, so a checkpoint written by either
package restores in the other, bit for bit:

  <dir>/step_%08d/manifest.json   {"step", "leaves": [{"key", "file",
                                   "shape", "dtype"}], "extra"}
  <dir>/step_%08d/leaf_%05d.npy   one full (unsharded) array per leaf

Leaves are in ``jax.tree.leaves`` order and keyed by their
``jax.tree_util.keystr`` path (:mod:`repro_torch.tree`); a bf16 leaf is
stored as its uint16 bit pattern with dtype "bfloat16".

Durability: writes go to ``<dir>/step_<n>.tmp/`` and are renamed only after
every leaf + manifest land — a crash mid-save never corrupts the latest
checkpoint (restart picks the newest *committed* step).

Async: ``CheckpointManager(async_save=True)`` copies the tree to host
memory synchronously and writes in a background thread, overlapping I/O
with the next training steps.  Restoring onto other shardings waits for
meshes (ROADMAP.md queue 1, item 11).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import tree as T
from .._unported import unported


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """-> (array to store, dtype name); bf16 as its uint16 bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _host_copy(leaf):
    """A host copy the caller's later in-place updates cannot reach."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    return np.array(leaf)


def save(path: str, step: int, tree, extra: Optional[Dict[str, Any]] = None) -> str:
    """Synchronous atomic save. Returns the committed directory."""
    final = os.path.join(path, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    items = T.paths(tree)
    manifest = {"step": step, "leaves": [], "extra": extra or {}}
    for i, (key, leaf) in enumerate(items):
        arr, dtype = _to_numpy(leaf)
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"].append(
            {"key": key, "file": fname, "shape": list(arr.shape), "dtype": dtype}
        )
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def latest_step(path: str) -> Optional[int]:
    if not os.path.isdir(path):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(path)
        if (m := re.fullmatch(r"step_(\d+)", d))
    ]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def load(
    path: str,
    step: Optional[int] = None,
    target=None,
    shardings=None,
) -> Tuple[int, Any]:
    """Restore (step, tree).  With ``target`` (a tree of the same leaves,
    e.g. a fresh train state) each leaf takes its target leaf's dtype and
    device and the tree its structure; the keys must match.  Without it,
    (step, a list of CPU tensors) in manifest order, bf16 leaves as
    ``torch.bfloat16`` (JAX returns numpy with ``ml_dtypes.bfloat16``)."""
    if shardings is not None:
        raise unported("ckpt.load(shardings=...) (meshes)", 11)
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {path}")
    d = os.path.join(path, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    tensors = [_tensor(np.load(os.path.join(d, leaf["file"])), leaf["dtype"])
               for leaf in manifest["leaves"]]
    if target is not None:
        items = T.paths(target)
        keys, want = [leaf["key"] for leaf in manifest["leaves"]], [k for k, _ in items]
        if keys != want:
            raise ValueError(f"checkpoint leaves differ from the target's: "
                             f"{sorted(set(keys) ^ set(want))[:6]} (counts {len(keys)}, "
                             f"{len(want)})")
        tensors = [
            t.to(device=l.device, dtype=l.dtype) if isinstance(l, torch.Tensor) else t
            for t, (_, l) in zip(tensors, items)
        ]
        return step, T.unflatten(target, tensors)
    return step, tensors


def prune(path: str, keep: int) -> None:
    if not os.path.isdir(path):
        return
    steps = sorted(
        int(m.group(1))
        for d in os.listdir(path)
        if (m := re.fullmatch(r"step_(\d+)", d))
    )
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(path, f"step_{s:08d}"), ignore_errors=True)


class CheckpointManager:
    """Interval + retention policy + optional async background writer."""

    def __init__(
        self, path: str, interval: int = 50, keep: int = 3, async_save: bool = True
    ):
        self.path = path
        self.interval = interval
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self.saves = 0
        os.makedirs(path, exist_ok=True)

    def maybe_save(self, step: int, tree, extra=None, force: bool = False) -> bool:
        if not force and (step == 0 or step % self.interval):
            return False
        # snapshot to host first: the train step updates the state in place
        host = T.map(_host_copy, tree)
        self.wait()

        def _do():
            save(self.path, step, host, extra)
            prune(self.path, self.keep)

        if self.async_save:
            self._thread = threading.Thread(target=_do, daemon=True)
            self._thread.start()
        else:
            _do()
        self.saves += 1
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def restore_or_none(self, target=None, shardings=None):
        self.wait()
        if latest_step(self.path) is None:
            return None
        return load(self.path, target=target, shardings=shardings)
