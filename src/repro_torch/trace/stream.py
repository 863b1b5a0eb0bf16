"""ADIOS2-SST analogue: step-framed trace channels.

In-process: bounded thread-safe queues, one per producing rank (the paper's
SST stream between TAU and the on-node AD).  File-backed: frames spill to
.npz per (rank, step) so a separate process (offline mode, §II-B "online
and offline modes") can re-read an entire run.
"""
from __future__ import annotations

import glob
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

from repro_torch.core.events import Frame


class SSTChannel:
    """Single-producer single-consumer framed stream with backpressure."""

    def __init__(self, capacity: int = 16):
        self._q: "queue.Queue[Optional[Frame]]" = queue.Queue(maxsize=capacity)
        self.closed = False

    def put(self, frame: Frame, timeout: Optional[float] = None) -> None:
        self._q.put(frame, timeout=timeout)

    def close(self) -> None:
        self._q.put(None)

    def get(self, timeout: Optional[float] = None) -> Optional[Frame]:
        """None signals end-of-stream."""
        return self._q.get(timeout=timeout)

    def __iter__(self) -> Iterator[Frame]:
        while True:
            f = self.get()
            if f is None:
                return
            yield f


class FrameStore:
    """File-backed frame archive (offline mode / crash-safe replay)."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def path(self, rank: int, step: int) -> str:
        return os.path.join(self.root, f"frame_r{rank:05d}_s{step:06d}.npz")

    def write(self, frame: Frame) -> str:
        p = self.path(frame.rank, frame.step)
        tmp = p + ".tmp.npz"
        np.savez_compressed(
            tmp, func=frame.func_events, comm=frame.comm_events,
            meta=np.asarray([frame.app, frame.rank, frame.step], np.int64),
        )
        os.replace(tmp, p)
        return p

    def read(self, rank: int, step: int) -> Frame:
        with np.load(self.path(rank, step)) as z:
            app, rank_, step_ = (int(v) for v in z["meta"])
            return Frame(app, rank_, step_, z["func"], z["comm"])

    def steps(self, rank: int) -> List[int]:
        pat = os.path.join(self.root, f"frame_r{rank:05d}_s*.npz")
        return sorted(
            int(os.path.basename(p).split("_s")[1].split(".")[0])
            for p in glob.glob(pat)
        )

    def ranks(self) -> List[int]:
        return sorted(
            {
                int(os.path.basename(p).split("_r")[1].split("_")[0])
                for p in glob.glob(os.path.join(self.root, "frame_r*.npz"))
            }
        )

    def replay(self, rank: int) -> Iterator[Frame]:
        for s in self.steps(rank):
            yield self.read(rank, s)
