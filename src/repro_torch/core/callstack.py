"""Vectorized call-stack construction from streamed ENTRY/EXIT events.

A copy of ``repro.core.callstack``: the port keeps its own so that it
imports nothing of ``repro``; its records are byte-identical to the
original's for the same frames.

The paper's on-node AD module "can build and maintain a function call stack
with function events and map communication events to a specific function"
(§III-B1). Frames arrive every ~second; calls may stay open across frames, so
the builder carries the open stack between frames.

The matcher is numpy-vectorized using a depth-pairing property: within one
(rank, tid) stream, calls at the same stack depth cannot overlap, so the k-th
EXIT observed at depth d always matches the k-th unmatched ENTRY at depth d.
That reduces parenthesis matching to a per-depth zip — O(E log E) with no
Python loop over events (the paper's modules process ~1e5–1e6 events/frame).

A slow reference path handles malformed streams (orphan exits) and doubles as
the oracle in property tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .events import (
    ENTRY,
    EXIT,
    EXEC_RECORD_DTYPE,
    Frame,
    empty_exec_records,
)


@dataclasses.dataclass
class _OpenCall:
    fid: int
    ts: int
    n_children: int = 0
    n_msgs: int = 0


@dataclasses.dataclass
class FrameContext:
    """Side info for one processed frame (provenance/viz support).

    ``records`` rows map 1:1 to ``rec_entry_row``: the row in the combined
    per-frame entry arrays, from which ancestor chains can be chased.
    """

    tid_of_record: np.ndarray  # (R,) tid per record
    # per-tid combined entry tables
    entry_fid: Dict[int, np.ndarray]
    entry_ts: Dict[int, np.ndarray]
    entry_depth: Dict[int, np.ndarray]
    entry_parent_row: Dict[int, np.ndarray]  # -1 for roots
    rec_entry_row: np.ndarray  # (R,) row into the tid's entry tables
    # comm attribution: for each comm event, (tid, entry_row) or -1
    comm_entry_row: np.ndarray

    def ancestors(self, rec_idx: int) -> List[Tuple[int, int, int]]:
        """Ancestor chain (outermost last) of a record: [(fid, entry_ts, depth)]."""
        tid = int(self.tid_of_record[rec_idx])
        row = int(self.rec_entry_row[rec_idx])
        out: List[Tuple[int, int, int]] = []
        parent = self.entry_parent_row[tid]
        fid, ts, dep = self.entry_fid[tid], self.entry_ts[tid], self.entry_depth[tid]
        row = int(parent[row])
        while row >= 0:
            out.append((int(fid[row]), int(ts[row]), int(dep[row])))
            row = int(parent[row])
        return out


class CallStackBuilder:
    """Per-rank incremental call-stack builder (one per on-node AD module)."""

    def __init__(self, app: int = 0, rank: int = 0):
        self.app = app
        self.rank = rank
        self.stacks: Dict[int, List[_OpenCall]] = {}
        self.n_events = 0
        self.n_orphan_exits = 0
        self.n_fid_mismatch = 0

    # ------------------------------------------------------------------ API
    def process(self, frame: Frame) -> Tuple[np.ndarray, FrameContext]:
        """Consume one frame; return completed exec records + context."""
        recs: List[np.ndarray] = []
        tid_list: List[np.ndarray] = []
        rec_rows: List[np.ndarray] = []
        ctx = FrameContext(
            tid_of_record=np.zeros(0, np.uint32),
            entry_fid={},
            entry_ts={},
            entry_depth={},
            entry_parent_row={},
            rec_entry_row=np.zeros(0, np.int64),
            comm_entry_row=np.full(len(frame.comm_events), -1, np.int64),
        )
        fe, ce = frame.func_events, frame.comm_events
        self.n_events += len(fe) + len(ce)
        tids = np.unique(np.concatenate([fe["tid"], ce["tid"]])) if len(fe) or len(ce) else []
        for tid in tids:
            tid = int(tid)
            f = fe[fe["tid"] == tid]
            c_mask = ce["tid"] == tid
            c = ce[c_mask]
            r, rows = self._process_tid(tid, f, c, ctx, np.nonzero(c_mask)[0])
            if len(r):
                recs.append(r)
                tid_list.append(np.full(len(r), tid, np.uint32))
                rec_rows.append(rows)
        if recs:
            records = np.concatenate(recs)
            ctx.tid_of_record = np.concatenate(tid_list)
            ctx.rec_entry_row = np.concatenate(rec_rows)
        else:
            records = empty_exec_records(0)
        return records, ctx

    def open_depth(self, tid: int = 0) -> int:
        return len(self.stacks.get(tid, []))

    # ------------------------------------------------------- vectorized core
    def _process_tid(
        self,
        tid: int,
        f: np.ndarray,
        c: np.ndarray,
        ctx: FrameContext,
        comm_pos: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        stack = self.stacks.setdefault(tid, [])
        d0 = len(stack)
        # Combined arrays: synthetic re-ENTRY prefix for carried-open calls.
        n_new = len(f)
        fid = np.concatenate([[oc.fid for oc in stack], f["fid"]]).astype(np.int64)
        ts = np.concatenate([[oc.ts for oc in stack], f["ts"]]).astype(np.uint64)
        etype = np.concatenate(
            [np.zeros(d0, np.uint8), f["etype"]]
        )  # prefix = ENTRY
        n_ev = d0 + n_new
        if n_ev == 0:
            return empty_exec_records(0), np.zeros(0, np.int64)

        dirs = np.where(etype == ENTRY, 1, -1)
        depth_after = np.cumsum(dirs)
        if depth_after.min(initial=0) < 0:
            # Malformed stream (exit without entry): robust slow path.
            return self._process_tid_slow(tid, f, c, ctx, comm_pos)

        is_entry = etype == ENTRY
        e_idx = np.nonzero(is_entry)[0]
        x_idx = np.nonzero(~is_entry)[0]
        e_depth = depth_after[e_idx]
        x_depth = depth_after[x_idx] + 1

        # --- per-depth pairing ------------------------------------------
        # entries/exits are already in idx order; stable-group them by depth.
        e_ord = np.argsort(e_depth, kind="stable")
        x_ord = np.argsort(x_depth, kind="stable")
        e_keys = self._depth_occurrence_keys(e_depth[e_ord], n_ev)
        x_keys = self._depth_occurrence_keys(x_depth[x_ord], n_ev)
        pos = np.searchsorted(e_keys, x_keys)
        # Every exit must match (depth accounting guarantees it).  x_keys[k]
        # belongs to exit x_idx[x_ord[k]], so reorder exits accordingly.
        matched_entry_rows = e_ord[pos]  # rows into e_idx-space
        entry_ev = e_idx[matched_entry_rows]
        exit_ev = x_idx[x_ord]
        open_mask = np.ones(len(e_idx), bool)
        open_mask[matched_entry_rows] = False

        # --- parents for every entry -------------------------------------
        by_depth: Dict[int, np.ndarray] = {}
        for d in np.unique(e_depth):
            by_depth[int(d)] = e_idx[e_depth == d]
        entry_parent_row = np.full(len(e_idx), -1, np.int64)
        row_of_entry_ev = np.full(n_ev, -1, np.int64)
        row_of_entry_ev[e_idx] = np.arange(len(e_idx))
        for d in by_depth:
            if d <= 1:
                continue
            parents = by_depth.get(d - 1)
            if parents is None:
                continue
            rows = np.nonzero(e_depth == d)[0]
            p = np.searchsorted(parents, e_idx[rows]) - 1
            ok = p >= 0
            entry_parent_row[rows[ok]] = row_of_entry_ev[parents[p[ok]]]

        # --- n_children ----------------------------------------------------
        child_count = np.zeros(len(e_idx), np.int64)
        pr = entry_parent_row[matched_entry_rows]
        np.add.at(child_count, pr[pr >= 0], 1)

        # --- comm attribution ----------------------------------------------
        msg_count = np.zeros(len(e_idx), np.int64)
        if len(c):
            cpos = np.searchsorted(ts, c["ts"], side="right") - 1
            cdepth = np.where(cpos >= 0, depth_after[np.maximum(cpos, 0)], 0)
            for d in np.unique(cdepth):
                if d <= 0:
                    continue
                cand = by_depth.get(int(d))
                if cand is None:
                    continue
                sel = np.nonzero(cdepth == d)[0]
                p = np.searchsorted(cand, cpos[sel], side="right") - 1
                ok = p >= 0
                rows = row_of_entry_ev[cand[p[ok]]]
                np.add.at(msg_count, rows, 1)
                ctx.comm_entry_row[comm_pos[sel[ok]]] = rows

        # --- fold in carryover counters ------------------------------------
        for i, oc in enumerate(stack):
            row = row_of_entry_ev[i]  # synthetic prefix entries are rows 0..d0-1
            child_count[row] += oc.n_children
            msg_count[row] += oc.n_msgs

        # --- build records ---------------------------------------------------
        m = len(exit_ev)
        recs = empty_exec_records(m)
        efid = fid[entry_ev]
        xfid = fid[exit_ev]
        self.n_fid_mismatch += int((efid != xfid).sum())
        recs["app"] = self.app
        recs["rank"] = self.rank
        recs["tid"] = tid
        recs["fid"] = efid
        recs["entry"] = ts[entry_ev]
        recs["exit"] = ts[exit_ev]
        recs["runtime"] = ts[exit_ev] - ts[entry_ev]
        recs["depth"] = depth_after[exit_ev] + 1
        rec_rows = row_of_entry_ev[entry_ev]
        recs["n_children"] = child_count[rec_rows]
        recs["n_msgs"] = msg_count[rec_rows]
        parent_rows = entry_parent_row[rec_rows]
        recs["parent_fid"] = np.where(parent_rows >= 0, fid[e_idx[np.maximum(parent_rows, 0)]], -1)
        # Sort by completion time (stream order for downstream consumers).
        order = np.argsort(recs["exit"], kind="stable")
        recs = recs[order]
        rec_rows = rec_rows[order]

        # --- update carry stack ---------------------------------------------
        new_stack: List[_OpenCall] = []
        open_rows = np.nonzero(open_mask)[0]
        open_rows = open_rows[np.argsort(e_depth[open_rows])]
        for row in open_rows:
            ev = e_idx[row]
            new_stack.append(
                _OpenCall(
                    fid=int(fid[ev]),
                    ts=int(ts[ev]),
                    n_children=int(child_count[row]),
                    n_msgs=int(msg_count[row]),
                )
            )
        self.stacks[tid] = new_stack

        ctx.entry_fid[tid] = fid[e_idx]
        ctx.entry_ts[tid] = ts[e_idx].astype(np.int64)
        ctx.entry_depth[tid] = e_depth
        ctx.entry_parent_row[tid] = entry_parent_row
        return recs, rec_rows

    @staticmethod
    def _depth_occurrence_keys(sorted_depths: np.ndarray, n_ev: int) -> np.ndarray:
        """key = depth * (n_ev + 1) + occurrence-within-depth, ascending."""
        if len(sorted_depths) == 0:
            return sorted_depths.astype(np.int64)
        change = np.r_[True, np.diff(sorted_depths) != 0]
        starts = np.nonzero(change)[0]
        grp = np.cumsum(change) - 1
        occ = np.arange(len(sorted_depths)) - starts[grp]
        return sorted_depths.astype(np.int64) * np.int64(n_ev + 1) + occ

    # ------------------------------------------------------------ slow path
    def _process_tid_slow(
        self,
        tid: int,
        f: np.ndarray,
        c: np.ndarray,
        ctx: FrameContext,
        comm_pos: np.ndarray,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Reference implementation; tolerates orphan exits. Also the oracle."""
        stack = self.stacks.setdefault(tid, [])
        # entry bookkeeping mirrors the vectorized context tables
        entry_fid: List[int] = []
        entry_ts: List[int] = []
        entry_depth: List[int] = []
        entry_parent: List[int] = []
        live: List[int] = []  # entry rows of currently open calls
        counters: List[List[int]] = []  # per entry row: [n_children, n_msgs]
        for oc in stack:
            row = len(entry_fid)
            entry_parent.append(live[-1] if live else -1)
            entry_fid.append(oc.fid)
            entry_ts.append(oc.ts)
            entry_depth.append(len(live) + 1)
            counters.append([oc.n_children, oc.n_msgs])
            live.append(row)

        out: List[tuple] = []
        out_rows: List[int] = []
        ci = 0
        comm_ts = c["ts"] if len(c) else np.zeros(0, np.uint64)
        for i in range(len(f)):
            while ci < len(comm_ts) and comm_ts[ci] < f["ts"][i]:
                if live:
                    counters[live[-1]][1] += 1
                    ctx.comm_entry_row[comm_pos[ci]] = live[-1]
                ci += 1
            if f["etype"][i] == ENTRY:
                row = len(entry_fid)
                entry_parent.append(live[-1] if live else -1)
                entry_fid.append(int(f["fid"][i]))
                entry_ts.append(int(f["ts"][i]))
                entry_depth.append(len(live) + 1)
                counters.append([0, 0])
                live.append(row)
            else:
                if not live:
                    self.n_orphan_exits += 1
                    continue
                row = live.pop()
                if entry_fid[row] != int(f["fid"][i]):
                    self.n_fid_mismatch += 1
                if live:
                    counters[live[-1]][0] += 1
                out.append(
                    (
                        entry_fid[row],
                        entry_ts[row],
                        int(f["ts"][i]),
                        len(live) + 1,
                        counters[row][0],
                        counters[row][1],
                        entry_fid[entry_parent[row]] if entry_parent[row] >= 0 else -1,
                    )
                )
                out_rows.append(row)
        while ci < len(comm_ts):
            if live:
                counters[live[-1]][1] += 1
                ctx.comm_entry_row[comm_pos[ci]] = live[-1]
            ci += 1

        recs = empty_exec_records(len(out))
        for k, (fid_, ent, ext, dep, nch, nmsg, pfid) in enumerate(out):
            recs["fid"][k] = fid_
            recs["entry"][k] = ent
            recs["exit"][k] = ext
            recs["runtime"][k] = ext - ent
            recs["depth"][k] = dep
            recs["n_children"][k] = nch
            recs["n_msgs"][k] = nmsg
            recs["parent_fid"][k] = pfid
        recs["app"] = self.app
        recs["rank"] = self.rank
        recs["tid"] = tid
        order = np.argsort(recs["exit"], kind="stable")
        recs = recs[order]
        rec_rows = np.asarray(out_rows, np.int64)[order] if out_rows else np.zeros(0, np.int64)

        self.stacks[tid] = [
            _OpenCall(entry_fid[r], entry_ts[r], counters[r][0], counters[r][1])
            for r in live
        ]
        ctx.entry_fid[tid] = np.asarray(entry_fid, np.int64)
        ctx.entry_ts[tid] = np.asarray(entry_ts, np.int64)
        ctx.entry_depth[tid] = np.asarray(entry_depth, np.int64)
        ctx.entry_parent_row[tid] = np.asarray(entry_parent, np.int64)
        return recs, rec_rows
