"""Write-ahead durability for PS shards: length-prefixed binary log.

A :class:`~repro_torch.core.ps.PSShard` holds the only copy of its slice of the
global moments table in memory — before this module, a killed shard worker
lost every delta it had merged.  The WAL makes the shard's state replayable:
every applied mutation (``push_rows`` / ``push`` / ``grow``) is appended to
the log *before* it is applied, so a restarted shard that replays the file
through the **same** merge code path reconstructs a bit-exact table — the
PS twin of the provenance store's JSONL durability.

Record format (all integers big-endian, mirroring ``repro_torch.net.framing``)::

    record  := magic "RW" | type u8 | payload_len u32 | crc32 u32 | payload
    CONF    := shard_id i64 | num_shards i64 | num_funcs i64
    ROWS    := seq i64 | rows_total i64 | n i64 | idx int64[n] | rows f64[n,7]
    PUSH    := n i64 | rows f64[n,7]
    GROW    := num_rows i64
    SNAP    := n_pushes i64 | last_seq i64 | n i64 | table f64[n,7]

Stats rows travel as raw float64 bytes (never through text), so replayed
``merge_moments`` sees bit-identical operands — the same rule the wire
framing follows.  The CRC (over type + payload) plus the length prefix make
*torn tails* detectable: a worker killed mid-append leaves a partial or
corrupt final record, which :func:`read_wal_records` truncates away on the
next open.  Everything before the tear was flushed to the OS per append
(``flush()``, no fsync — a SIGKILL loses process buffers, not page cache),
so the log always replays to the exact prefix of mutations the shard had
durably applied.

Compaction: every ``compact_every`` delta records the owner snapshots the
live table into a fresh ``CONF + SNAP`` log (atomic ``os.replace``), so the
file and replay time stay O(table + compact_every), not O(pushes).
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import List, Optional, Tuple

import numpy as np

from ..telemetry import registry as telemetry

__all__ = [
    "CONF",
    "GROW",
    "PUSH",
    "ROWS",
    "SNAP",
    "PSWal",
    "WalCorrupt",
    "read_wal_records",
]

_MAGIC = b"RW"
_HEADER = struct.Struct("!2sBII")  # magic, type, payload_len, crc32
_I64 = struct.Struct("!q")
_I64x3 = struct.Struct("!qqq")

CONF, ROWS, PUSH, GROW, SNAP = 1, 2, 3, 4, 5
_KNOWN_TYPES = frozenset((CONF, ROWS, PUSH, GROW, SNAP))
_NCOLS = 7  # stats table columns (repro_torch.core.stats.NCOLS)


class WalCorrupt(Exception):
    """A WAL record that parsed but cannot be applied (bad type/shape)."""


def _crc(rtype: int, payload: bytes) -> int:
    return zlib.crc32(payload, zlib.crc32(bytes((rtype,)))) & 0xFFFFFFFF


def _record(rtype: int, payload: bytes) -> bytes:
    return _HEADER.pack(_MAGIC, rtype, len(payload), _crc(rtype, payload)) + payload


def read_wal_records(path: str) -> Tuple[List[Tuple[int, bytes]], int]:
    """Parse ``(type, payload)`` records; return them plus the byte offset of
    the last *good* record's end.

    Stops (without raising) at the first incomplete, unknown-typed, or
    CRC-failing record — that is the torn tail a killed writer leaves, and
    everything before it is intact by construction (appends are flushed in
    order).  Callers truncate the file to the returned offset before
    appending again.
    """
    with open(path, "rb") as f:
        blob = f.read()
    records: List[Tuple[int, bytes]] = []
    off = 0
    good = 0
    n = len(blob)
    while off + _HEADER.size <= n:
        magic, rtype, plen, crc = _HEADER.unpack_from(blob, off)
        if magic != _MAGIC or rtype not in _KNOWN_TYPES:
            break
        end = off + _HEADER.size + plen
        if end > n:
            break  # torn mid-payload
        payload = blob[off + _HEADER.size : end]
        if _crc(rtype, payload) != crc:
            break  # torn mid-header rewrite or bit rot
        records.append((rtype, payload))
        off = good = end
    return records, good


# ------------------------------------------------------- payload (en|de)coders
def encode_conf(shard_id: int, num_shards: int, num_funcs: int) -> bytes:
    return _I64x3.pack(shard_id, num_shards, num_funcs)


def decode_conf(payload: bytes) -> Tuple[int, int, int]:
    return _I64x3.unpack(payload)


def encode_rows(seq: int, idx: np.ndarray, rows: np.ndarray, rows_total: int) -> bytes:
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    return b"".join(
        (_I64x3.pack(seq, rows_total, idx.shape[0]), idx.tobytes(), rows.tobytes())
    )


def decode_rows(payload: bytes) -> Tuple[int, np.ndarray, np.ndarray, int]:
    seq, rows_total, n = _I64x3.unpack_from(payload)
    o = _I64x3.size
    idx = np.frombuffer(payload, np.int64, count=n, offset=o)
    rows = np.frombuffer(
        payload, np.float64, count=n * _NCOLS, offset=o + 8 * n
    ).reshape(n, _NCOLS)
    return seq, idx, rows, rows_total


def encode_push(rows: np.ndarray) -> bytes:
    rows = np.ascontiguousarray(rows, dtype=np.float64)
    return _I64.pack(rows.shape[0]) + rows.tobytes()


def decode_push(payload: bytes) -> np.ndarray:
    (n,) = _I64.unpack_from(payload)
    return np.frombuffer(payload, np.float64, count=n * _NCOLS,
                         offset=_I64.size).reshape(n, _NCOLS)


def decode_grow(payload: bytes) -> int:
    return _I64.unpack_from(payload)[0]


def encode_snap(table: np.ndarray, n_pushes: int, last_seq: int) -> bytes:
    table = np.ascontiguousarray(table, dtype=np.float64)
    return _I64x3.pack(n_pushes, last_seq, table.shape[0]) + table.tobytes()


def decode_snap(payload: bytes) -> Tuple[np.ndarray, int, int]:
    n_pushes, last_seq, n = _I64x3.unpack_from(payload)
    table = np.frombuffer(
        payload, np.float64, count=n * _NCOLS, offset=_I64x3.size
    ).reshape(n, _NCOLS)
    return table, n_pushes, last_seq


class PSWal:
    """One shard's write-ahead log: torn-tail-tolerant open, per-append OS
    flush, periodic snapshot compaction.

    Not thread-safe by itself — the owning :class:`~repro_torch.core.ps.PSShard`
    serializes every append/compact under its own lock, exactly like the
    table mutation the record describes.
    """

    def __init__(self, path: str, compact_every: int = 1024, reset: bool = False):
        self.path = path
        self.compact_every = max(int(compact_every), 1)
        self._fh = None
        self._deltas = 0  # delta records since the last CONF/SNAP prefix
        if os.path.dirname(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
        if reset and os.path.exists(path):
            os.remove(path)
        if telemetry.ENABLED:
            reg = telemetry.get_registry()
            self._m_records = reg.counter(
                "repro_fault_wal_records_total",
                "WAL records appended, by record kind.",
                ["kind"],
            ).labels(kind="delta")
            self._m_compactions = reg.counter(
                "repro_fault_wal_compactions_total",
                "WAL snapshot compactions (log rewrites).",
            )
        else:
            self._m_records = self._m_compactions = None

    # ---------------------------------------------------------------- replay
    def load(self) -> Tuple[List[Tuple[int, bytes]], bool]:
        """Open for append; return ``(records, resumed)``.

        Truncates any torn tail in place first, so the append position is
        the end of the last intact record.  ``resumed`` is False for a
        fresh/empty log (the owner must write its CONF record).
        """
        records: List[Tuple[int, bytes]] = []
        good = 0
        if os.path.exists(self.path):
            records, good = read_wal_records(self.path)
            if os.path.getsize(self.path) != good:
                with open(self.path, "r+b") as f:
                    f.truncate(good)
        self._fh = open(self.path, "ab")
        self._deltas = sum(1 for rtype, _ in records if rtype in (ROWS, PUSH, GROW))
        return records, bool(records)

    # --------------------------------------------------------------- appends
    def _append(self, rtype: int, payload: bytes) -> None:
        self._fh.write(_record(rtype, payload))  # lint: ignore[loop-blocking-io] — write-ahead: the record reaches the page cache before the merge is acknowledged
        # Flush to the OS per record: a SIGKILLed worker loses only its
        # user-space buffers, so the log survives exactly as applied.
        self._fh.flush()  # lint: ignore[loop-blocking-io] — buffered flush, no fsync (the original's baseline entry)
        if self._m_records is not None and telemetry.ENABLED:
            self._m_records.inc()

    def append_conf(self, shard_id: int, num_shards: int, num_funcs: int) -> None:
        self._fh.write(_record(CONF, encode_conf(shard_id, num_shards, num_funcs)))
        self._fh.flush()

    def append_rows(
        self, seq: int, idx: np.ndarray, rows: np.ndarray, rows_total: int
    ) -> None:
        self._append(ROWS, encode_rows(seq, idx, rows, rows_total))
        self._deltas += 1

    def append_push(self, rows: np.ndarray) -> None:
        self._append(PUSH, encode_push(rows))
        self._deltas += 1

    def append_grow(self, num_rows: int) -> None:
        self._append(GROW, _I64.pack(int(num_rows)))
        self._deltas += 1

    # ------------------------------------------------------------ compaction
    def should_compact(self) -> bool:
        return self._deltas >= self.compact_every

    def compact(
        self,
        conf: Tuple[int, int, int],
        table: np.ndarray,
        n_pushes: int,
        last_seq: int,
    ) -> None:
        """Rewrite the log as ``CONF + SNAP`` of the live state, atomically.

        The owner calls this under its shard lock, so ``table`` is the
        exact state every logged delta so far produced; replay from the
        snapshot is bitwise-identical to replay of the full delta history.
        fsync before replace: the one record that must not be lost to a
        *node* crash is the one that just made the history disposable.
        """
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:  # lint: ignore[loop-blocking-io] — compaction, once per compact_every records, atomic with the log it replaces
            f.write(_record(CONF, encode_conf(*conf)))
            f.write(_record(SNAP, encode_snap(table, n_pushes, last_seq)))
            f.flush()
            os.fsync(f.fileno())  # lint: ignore[loop-blocking-io] — the snapshot must survive a node crash before it replaces the log
        self._fh.close()
        os.replace(tmp, self.path)  # lint: ignore[loop-blocking-io] — atomic swap of the compacted log
        self._fh = open(self.path, "ab")  # lint: ignore[loop-blocking-io] — reopen the compacted log for appends
        self._deltas = 0
        if self._m_compactions is not None and telemetry.ENABLED:
            self._m_compactions.inc()

    def size_bytes(self) -> int:
        return os.path.getsize(self.path) if os.path.exists(self.path) else 0

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def wal_path(wal_dir: str, shard_id: int) -> str:
    """The path family: one ``ps_shard<k>.wal`` per PS shard under a dir."""
    return os.path.join(wal_dir, f"ps_shard{shard_id}.wal")
