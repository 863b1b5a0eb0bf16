"""Synthetic data pipeline (port of ``repro.data.pipeline``): deterministic,
host-sharded token streams.

Real corpora are absent offline; the pipeline generates reproducible
pseudo-random batches shaped exactly like each architecture's inputs
(including modality stubs), sharded per host the way a multi-pod data
loader would shard (each host materializes only its slice of the global
batch — data parallelism axis 0).

``SyntheticStream.batch_at`` returns numpy arrays byte-identical to the JAX
package's for any (seed, host, step), so both packages train on the same
stream.  ``synthetic_batch`` returns torch tensors on a device, and
``batch_spec`` describes a batch with ``meta`` tensors (shape and dtype, no
storage) where JAX returns ``ShapeDtypeStruct``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..device import resolve
from ..models.common import ModelConfig


def vis_tokens(seq_len: int) -> int:
    """Visual-prefix length for vision_stub batches (¼ of the sequence)."""
    return max(1, seq_len // 4)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_spec(cfg: ModelConfig, batch: int, seq: int) -> Dict[str, torch.Tensor]:
    """``meta`` tensors for one training batch (shape and dtype stand-ins)."""
    if cfg.modality == "audio_stub":
        return {
            "embeds": _meta((batch, seq, cfg.d_model), torch.bfloat16),
            "labels": _meta((batch, seq), torch.int32),
        }
    spec = {
        "tokens": _meta((batch, seq), torch.int32),
        "labels": _meta((batch, seq), torch.int32),
    }
    if cfg.modality == "vision_stub":
        spec["visual_embeds"] = _meta((batch, vis_tokens(seq), cfg.d_model), torch.bfloat16)
        spec["pos3"] = _meta((3, batch, seq), torch.int32)
    return spec


def make_pos3(batch: int, seq: int, n_vis: int) -> np.ndarray:
    """M-RoPE positions: visual prefix gets (t=0, h=row, w=col) grid; text
    continues with t=h=w."""
    side = max(1, int(np.floor(np.sqrt(n_vis))))
    t = np.zeros(n_vis, np.int32)
    h = (np.arange(n_vis) // side).astype(np.int32)
    w = (np.arange(n_vis) % side).astype(np.int32)
    text = np.arange(n_vis, seq, dtype=np.int32)
    base = int(h.max(initial=0)) + 1
    pos3 = np.stack(
        [
            np.concatenate([t, text - n_vis + base]),
            np.concatenate([h, text - n_vis + base]),
            np.concatenate([w, text - n_vis + base]),
        ]
    )
    return np.broadcast_to(pos3[:, None, :], (3, batch, seq)).copy()


def to_device(batch: Dict[str, np.ndarray], device=None) -> Dict[str, torch.Tensor]:
    """A numpy batch (``batch_at``) as tensors of the same dtypes on
    ``device`` (None: the port's default), as ``jnp.asarray`` takes it."""
    device = resolve(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in batch.items()}


def _bf16_floats(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: (v.to(torch.bfloat16) if v.is_floating_point() else v) for k, v in batch.items()}


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
                    device=None) -> Dict[str, torch.Tensor]:
    """One concrete batch matching batch_spec (tests/examples), on ``device``;
    the same values as the JAX package's for the same seed."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio_stub":
        return _bf16_floats(to_device({
            "embeds": rng.normal(0, 1, (batch, seq, cfg.d_model)).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32),
        }, device))
    tokens = rng.integers(0, cfg.vocab, (batch, seq + 1))
    out = {
        "tokens": tokens[:, :-1].astype(np.int32),
        "labels": tokens[:, 1:].astype(np.int32),
    }
    if cfg.modality == "vision_stub":
        n_vis = vis_tokens(seq)
        out["visual_embeds"] = rng.normal(0, 1, (batch, n_vis, cfg.d_model)).astype(np.float32)
        out["pos3"] = make_pos3(batch, seq, n_vis)
    return _bf16_floats(to_device(out, device))


@dataclasses.dataclass
class DataShard:
    """Host-local slice of the global batch (data-parallel loading)."""

    host_index: int
    n_hosts: int
    global_batch: int

    @property
    def local_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticStream:
    """Deterministic infinite batch stream; step-indexed for exact resume
    after checkpoint restart (fault tolerance: data order is a pure function
    of (seed, step), so a restarted run sees the identical stream)."""

    def __init__(self, cfg: ModelConfig, shard: DataShard, seq: int, seed: int = 0):
        self.cfg = cfg
        self.shard = shard
        self.seq = seq
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            (self.seed, self.shard.host_index, step)
        )
        B, S = self.shard.local_batch, self.seq
        cfg = self.cfg
        if cfg.modality == "audio_stub":
            return {
                "embeds": rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            }
        tokens = rng.integers(0, cfg.vocab, (B, S + 1))
        out = {
            "tokens": tokens[:, :-1].astype(np.int32),
            "labels": tokens[:, 1:].astype(np.int32),
        }
        if cfg.modality == "vision_stub":
            n_vis = vis_tokens(S)
            out["visual_embeds"] = rng.normal(0, 1, (B, n_vis, cfg.d_model)).astype(
                np.float32
            )
            out["pos3"] = make_pos3(B, S, n_vis)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
