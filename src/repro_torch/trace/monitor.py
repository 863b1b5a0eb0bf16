"""ChimbukoMonitor: the paper's full online pipeline wired to a training run.

One object owns, per rank: on-node AD + reducer + provenance; globally: the
parameter server and viz feeds.  ``ingest`` is the in-situ path (frame →
records → labels → reduced stream → provenance); ``record_step_times`` is
the workflow-level application: per-rank step-time anomaly detection =
straggler detection, feeding mitigation callbacks (alert / checkpoint-now /
rebalance) — the fault-tolerance hook the framework exposes at scale.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch._unported import unported
from repro_torch.core.ad import ADFrameResult, OnNodeAD
from repro_torch.core.events import Frame, FunctionRegistry
from repro_torch.core.provenance import FederatedProvenanceDB, ProvenanceDB
from repro_torch.core.ps import BatchedPSClient, FederatedPS, ParameterServer
from repro_torch.core.reduction import Reducer, merge_stats
from repro_torch.core.stats import RunningStats
from repro_torch.telemetry import registry as telemetry
from repro_torch.telemetry import spans
from repro_torch.telemetry.ring import get_ring, prefer_recording
from repro_torch.telemetry.selftrace import SELF_TRACE_PID, get_self_tracer

_INGEST_STAGES = ("ad", "reduce", "ps", "prov", "write", "publish")


class _StageTimer:
    """Per-frame stage clock: marks observe the stage histogram and, when
    self-tracing, record the stage as a span."""

    __slots__ = ("_hists", "_tracer", "_last")

    def __init__(self, hists, tracer):
        self._hists = hists
        self._tracer = tracer
        self._last = time.perf_counter_ns()

    def mark(self, stage: str) -> None:
        now = time.perf_counter_ns()
        dur_ns = now - self._last
        self._hists[stage].observe(dur_ns // 1000)
        if self._tracer is not None:
            self._tracer.record(
                f"ingest:{stage}", self._last // 1000, dur_ns // 1000
            )
        self._last = now


class _NullTimer:
    __slots__ = ()

    def mark(self, stage: str) -> None:
        pass


_NULL_TIMER = _NullTimer()


@dataclasses.dataclass
class StragglerEvent:
    step: int
    rank: int
    step_time: float
    zscore: float


class ChimbukoMonitor:
    def __init__(
        self,
        num_funcs: int = 64,
        registry: Optional[FunctionRegistry] = None,
        prov_path: Optional[str] = None,
        alpha: float = 6.0,
        min_samples: int = 10,
        k_neighbors: int = 5,
        straggler_alpha: float = 3.0,
        straggler_min_steps: int = 10,
        algorithm: str = "sstd",
        run_info: Optional[dict] = None,
        ps_shards: int = 1,
        ps_batch_frames: int = 1,
        ps_aggregate_every: int = 16,
        provdb_shards: int = 1,
        prov_append: bool = False,
        ps_transport: str = "local",
        provdb_transport: str = "local",
        shard_endpoints: Optional[list] = None,
        ps_wal_dir: Optional[str] = None,
        fault_policy=None,
        export_trace: Optional[str] = None,
        stream_path: Optional[str] = None,
        viz_serve: Optional[int] = None,
        self_trace: Optional[bool] = None,
        trace_spans: Optional[bool] = None,
        span_sample_every: int = 8,
        span_dump_severity: int = 6,
    ):
        self.registry = registry or FunctionRegistry()
        # Kept for observability: the gateway's /metrics federates
        # metrics.snapshot from these endpoints on socket transports.
        self.shard_endpoints = list(shard_endpoints or [])
        # Self-observability: per-frame pipeline stage timings, plus the
        # opt-in self-trace (REPRO_SELF_TRACE=1 or self_trace=True) that
        # drains the analyzer's own spans into the live trace export as a
        # dedicated process group.
        _stage_family = telemetry.get_registry().histogram(
            "repro_frame_stage_us",
            "Per-frame ingest pipeline stage latency in microseconds.",
            ["stage"],
        )
        self._m_stage = {s: _stage_family.labels(stage=s) for s in _INGEST_STAGES}
        self._m_frames = telemetry.get_registry().counter(
            "repro_frames_ingested_total",
            "Frames run through the full in-situ ingest path.",
        )
        self._selftrace = get_self_tracer()
        if self_trace is not None:
            self._selftrace.set_enabled(bool(self_trace))
        self._selftrace_proc_named = False
        # Distributed request tracing (repro.telemetry.spans): every ingest
        # runs under a deterministic per-frame trace root; anomalous frames
        # upgrade their sampled bit (tail sampling) and high-severity ones
        # dump the flight recorder.  NOTE trace_spans=True only arms *this*
        # process — spawned shard workers read REPRO_SPANS=1 at import, so
        # socket-transport runs must set the env var before the pool spawns.
        if trace_spans is not None:
            spans.set_enabled(bool(trace_spans))
        self._span_sample = max(int(span_sample_every), 0)
        self._span_dump_severity = int(span_dump_severity)
        # proc label -> {(trace, span): span}: the monitor-side archive of
        # federated flight-recorder views (quiesce/close pull these), keyed
        # by process so the export can draw per-process span tracks.
        self._span_views: Dict[str, Dict[Tuple[int, int], dict]] = {}
        if spans.ENABLED:
            spans.install_health_trigger()
        # PS federation (paper §III-B2): with ps_shards > 1 the stats table
        # is partitioned over fid space across shard instances; clients can
        # additionally coalesce ps_batch_frames deltas per push.  With
        # transport="socket" the shards live in repro.launch.shard_server
        # worker processes at shard_endpoints — the paper's separate-process
        # PS/provenance instances — with unchanged semantics (bit-matched
        # stats, byte-matched provenance).
        # ps_wal_dir arms crash tolerance (repro.fault): workers write-ahead
        # log applied deltas there, stubs get a retry/replay policy, and a
        # killed+respawned shard recovers to a bit-exact table while the
        # monitor keeps analyzing (degraded) through the outage.
        if ps_wal_dir is not None:
            raise unported("ChimbukoMonitor(ps_wal_dir=...) (repro.fault.wal)")
        if ps_transport == "socket":
            self.ps = FederatedPS(
                num_funcs, aggregate_every=ps_aggregate_every,
                transport="socket", endpoints=shard_endpoints,
                wal_dir=ps_wal_dir, fault_policy=fault_policy,
            )
        elif ps_shards > 1:
            self.ps = FederatedPS(
                num_funcs, num_shards=ps_shards, aggregate_every=ps_aggregate_every
            )
        else:
            self.ps = ParameterServer(num_funcs)
        self._ps_batch_frames = max(int(ps_batch_frames), 1)
        self._ps_clients: Dict[int, object] = {}
        self._num_funcs = num_funcs
        self._alpha = alpha
        self._min_samples = min_samples
        self._algorithm = algorithm
        self.ads: Dict[int, OnNodeAD] = {}
        self.reducers: Dict[int, Reducer] = {}
        # Provenance federation (paper §V at scale): with provdb_shards > 1
        # anomaly docs are partitioned over (rank, fid) space across shard
        # JSONL files + indexes, mirroring the PS federation; prov_append
        # resumes a prior run's store instead of truncating it.
        if provdb_transport == "socket":
            self.provdb = FederatedProvenanceDB(
                path=prov_path, registry=self.registry, k_neighbors=k_neighbors,
                run_info=run_info, append=prov_append,
                transport="socket", endpoints=shard_endpoints,
                fault_policy=fault_policy,
            )
        elif provdb_shards > 1:
            self.provdb = FederatedProvenanceDB(
                num_shards=provdb_shards, path=prov_path, registry=self.registry,
                k_neighbors=k_neighbors, run_info=run_info, append=prov_append,
            )
        else:
            self.provdb = ProvenanceDB(
                path=prov_path, registry=self.registry, k_neighbors=k_neighbors,
                run_info=run_info, append=prov_append,
            )
        # reduced record store: what the on-node modules write for the viz
        self.kept: Dict[Tuple[int, int], np.ndarray] = {}
        # per-frame export metadata: (ts, n_records, n_anomalies) and the
        # (kept_idx, prov_seq, severity) anomaly links — what the Perfetto
        # exporter (repro.export) and the VizServer /trace endpoint replay.
        self.frame_meta: Dict[Tuple[int, int], Tuple[Optional[int], int, int]] = {}
        self.anom_meta: Dict[Tuple[int, int], List[Tuple[int, int, int]]] = {}
        # continuous during-run export: a live Chrome-trace writer and/or a
        # persisted reduced record stream for offline `python -m repro.export`
        self._trace_writer = None
        self._stream_writer = None
        if export_trace:
            from repro_torch.export.chrome_trace import ChromeTraceWriter

            self._trace_writer = ChromeTraceWriter(path=export_trace)
        if stream_path:
            from repro_torch.export.record_stream import RecordStreamWriter

            # prov_append governs the whole resume: a resumed run appends to
            # its record stream exactly like it appends to its provenance
            # store (one header, prior frames preserved).
            self._stream_writer = RecordStreamWriter(stream_path,
                                                     append=prov_append)
        # live viz gateway (paper §IV's online server): HTTP views + /trace
        # + WebSocket per-frame broadcast, on the repro.net event loop.
        self.frames_ingested = 0
        self.viz_gateway = None
        if viz_serve is not None:
            raise unported("ChimbukoMonitor(viz_serve=...) (repro.viz)")
        # straggler detection state
        self._stime = RunningStats()
        self._s_alpha = straggler_alpha
        self._s_min = straggler_min_steps
        self.stragglers: List[StragglerEvent] = []
        self._mitigations: List[Callable[[StragglerEvent], None]] = []

    # ------------------------------------------------------------- trace AD
    def _ad(self, rank: int) -> OnNodeAD:
        if rank not in self.ads:
            if self._ps_batch_frames > 1:
                client = BatchedPSClient(self.ps, rank, self._ps_batch_frames)
                self._ps_clients[rank] = client
            else:
                client = self.ps
            self.ads[rank] = OnNodeAD(
                self._num_funcs, rank=rank, ps_client=client,
                alpha=self._alpha, min_samples=self._min_samples,
                algorithm=self._algorithm,
            )
            self.reducers[rank] = Reducer()
        return self.ads[rank]

    def ingest(self, frame: Frame) -> ADFrameResult:
        """Full in-situ path for one rank-frame.

        With tracing armed the whole ingest runs under the frame's
        deterministic trace root (trace id = H(rank, step)), so every RPC
        the frame causes — PS pushes, provenance batches, their server-side
        handling — hangs off one causal tree."""
        if not spans.ENABLED:
            return self._ingest_frame(frame)
        ctx = spans.root_context(frame.rank, frame.step, self._span_sample)
        t0 = spans.now_us()
        err = False
        with spans.use(ctx):
            try:
                return self._ingest_frame(frame)
            except BaseException:
                err = True
                raise
            finally:
                fin = spans.current() or ctx  # tail sampling may upgrade it
                spans.record(
                    fin.trace_id, fin.span_id, 0, "frame", "frame",
                    fin.flags, t0, spans.now_us() - t0, err=err,
                    order=(frame.step, frame.rank),
                )

    def _ingest_frame(self, frame: Frame) -> ADFrameResult:
        if telemetry.ENABLED:
            timer = _StageTimer(
                self._m_stage,
                self._selftrace if self._selftrace.enabled else None,
            )
        else:
            timer = _NULL_TIMER
        res = self._ad(frame.rank).process_frame(frame)
        if res.n_anomalies and spans.ENABLED:
            # Tail sampling: the anomaly verdict upgrades the frame's
            # sampled bit before the provenance writes ship, so the whole
            # anomaly path (client + server + ingest spans) is kept.  PS
            # pushes travel inside process_frame, before the verdict — they
            # follow the 1/N policy.
            spans.mark_sampled()
        timer.mark("ad")
        kept_idx = self.reducers[frame.rank].reduce(res)
        kept = res.records[kept_idx]
        self.kept[(frame.rank, frame.step)] = kept
        timer.mark("reduce")
        self.ps.report_anomalies(frame.rank, frame.step, res.n_anomalies)
        timer.mark("ps")
        anom: List[Tuple[int, int, int]] = []
        if res.n_anomalies:
            self.provdb.ingest(res, frame.comm_events)
            # Link each anomalous kept record to the provenance doc it just
            # produced (anomalies are always kept, so the searchsorted map
            # is total).  (kept_idx, global seq, severity) triples feed the
            # trace exporter's instant events.
            kpos = np.searchsorted(kept_idx, res.anomaly_idx)
            anom = [
                (int(k), int(seq), int(sev))
                for k, (seq, sev) in zip(kpos, self.provdb.last_ingest)
            ]
        timer.mark("prov")
        if anom and spans.ENABLED:
            max_sev = max(sev for _k, _s, sev in anom)
            if max_sev >= self._span_dump_severity:
                get_ring().dump(
                    f"anomaly:sev{max_sev}:r{frame.rank}s{frame.step}"
                )
        ts = int(res.records["exit"].max()) if len(res.records) else None
        key = (frame.rank, frame.step)
        self.frame_meta[key] = (ts, len(res.records), res.n_anomalies)
        self.anom_meta[key] = anom
        for writer in (self._stream_writer, self._trace_writer):
            if writer is not None:
                writer.add_frame(
                    frame.rank, frame.step, kept, self.registry.names,
                    anomalies=anom, n_records=len(res.records),
                    n_anomalies=res.n_anomalies, ts=ts,
                )
        timer.mark("write")
        self.frames_ingested += 1
        self._m_frames.inc()
        if self.viz_gateway is not None:
            self.viz_gateway.publish_frame(
                frame.rank, frame.step, res.n_anomalies,
                severity=max((sev for _k, _s, sev in anom), default=0),
            )
        timer.mark("publish")
        if self._trace_writer is not None and self._selftrace.enabled:
            self._drain_selftrace()
        return res

    def _drain_selftrace(self) -> None:
        """Append the analyzer's own spans (this monitor's ingest stages,
        RPC dispatch, heavy offloads) to the live trace export as complete
        events in a dedicated process group."""
        writer = self._trace_writer
        if not self._selftrace_proc_named:
            writer.set_process(SELF_TRACE_PID, "repro.telemetry (self)",
                               sort_index=SELF_TRACE_PID)
            self._selftrace_proc_named = True
        for name, tid, t0_us, dur_us, args in self._selftrace.drain():
            writer.complete(SELF_TRACE_PID, tid, name, t0_us, dur_us,
                            args=args, cat="selftrace")

    # ---------------------------------------------------------- stragglers
    def on_straggler(self, cb: Callable[[StragglerEvent], None]) -> None:
        self._mitigations.append(cb)

    def record_step_times(
        self, step: int, times_by_rank: Dict[int, float]
    ) -> List[StragglerEvent]:
        """Detect per-rank step-time outliers against the running profile."""
        out: List[StragglerEvent] = []
        xs = np.asarray(list(times_by_rank.values()), np.float64)
        mu, sd = self._stime.mean, self._stime.std
        if self._stime.n >= self._s_min and sd > 0:
            for rank, t in times_by_rank.items():
                z = (t - mu) / sd
                if z > self._s_alpha:
                    ev = StragglerEvent(step, rank, t, float(z))
                    out.append(ev)
                    self.stragglers.append(ev)
                    for cb in self._mitigations:
                        cb(ev)
        self._stime.push_batch(xs)
        return out

    # -------------------------------------------------------------- report
    def reduction_stats(self):
        return merge_stats([r.stats for r in self.reducers.values()])

    def summary(self) -> dict:
        red = self.reduction_stats()
        out = {
            "frames": sum(ad.frames_seen for ad in self.ads.values()),
            "events": sum(ad.builder.n_events for ad in self.ads.values()),
            "anomalies": sum(ad.n_anomalies_total for ad in self.ads.values()),
            "reduction_factor": red.factor,
            "raw_bytes": red.raw_bytes,
            "reduced_bytes": red.reduced_bytes,
            "provenance_records": len(self.provdb),
            "stragglers": len(self.stragglers),
            "ps_updates": self.ps.n_updates,
        }
        if isinstance(self.ps, FederatedPS):
            out["ps_shards"] = self.ps.num_shards
            out["ps_shard_pushes"] = self.ps.n_shard_pushes
            out["ps_transport"] = self.ps.transport
        if isinstance(self.provdb, FederatedProvenanceDB):
            out["provdb_shards"] = self.provdb.num_shards
            out["provdb_shard_docs"] = self.provdb.shard_doc_counts()
            out["provdb_transport"] = self.provdb.transport
        if self.viz_gateway is not None:
            host, port = self.viz_gateway.endpoint
            out["viz_endpoint"] = f"http://{host}:{port}"
        from repro_torch.fault.health import get_health  # local: cheap, avoids cycle

        out["health"] = get_health().snapshot()
        return out

    def flush_ps(self) -> None:
        """Push any deltas still buffered in batching PS clients."""
        for client in self._ps_clients.values():
            client.flush()

    # ----------------------------------------------------------- span fleet
    def _federate_spans(self, dump: bool, reason: str) -> List[str]:
        """Pull every process's flight recorder into the monitor-side
        per-proc archive (``_span_views``); returns degraded-shard errors.

        Without shard endpoints this is the local half of
        ``repro.telemetry.federate.federated_spans``: the monitor's own
        flight recorder.  Shard processes wait for ROADMAP.md queue 1, item 2b."""
        if self.shard_endpoints:
            raise unported("span federation (repro.telemetry.federate)")
        ring = get_ring()
        if dump:
            ring.dump(reason)
        dst = self._span_views.setdefault("monitor", {})
        for span in ring.collect():
            key = (span["trace"], span["span"])
            dst[key] = prefer_recording(dst.get(key), span)
        return []

    def quiesce(self, dump: bool = True) -> dict:
        """Deterministic settle point: flush + drain every in-flight write,
        then pull the fleet's span flight recorders into the monitor-side
        archive.  After a quiesce the unacked-write set is empty and every
        server-side span so far is safely archived locally, so a SIGKILL
        of any shard afterwards cannot orphan part of a sampled trace —
        the byte-identity anchor for traced chaos runs."""
        self.flush_ps()
        for obj in (self.ps, self.provdb):
            drain = getattr(obj, "drain", None)
            if drain is not None:
                drain()
        errors: List[str] = []
        if spans.ENABLED:
            errors = self._federate_spans(dump=dump, reason="quiesce")
        return {"errors": errors}

    def fleet_spans(self) -> Dict[str, List[dict]]:
        """The per-process span sets the export renders: the federated
        archive plus whatever sits in the local ring right now."""
        out = {p: list(v.values()) for p, v in self._span_views.items()}
        local = {(s["trace"], s["span"]): s for s in out.get("monitor", ())}
        for span in get_ring().collect():
            key = (span["trace"], span["span"])
            local[key] = prefer_recording(local.get(key), span)
        out["monitor"] = list(local.values())
        return out

    def _render_spans(self) -> None:
        from repro_torch.export.chrome_trace import render_spans

        self._federate_spans(dump=True, reason="close")
        render_spans(self._trace_writer, self.fleet_spans())

    def close(self) -> None:
        self.flush_ps()
        if self.viz_gateway is not None:
            self.viz_gateway.stop()
            self.viz_gateway = None
        self.provdb.close()
        if self._trace_writer is not None:
            if self._selftrace.enabled:
                self._drain_selftrace()  # spans since the last ingest
            if spans.ENABLED:
                self._render_spans()  # federated span trees + flow arrows
            self._trace_writer.close()
            self._trace_writer = None
        if self._stream_writer is not None:
            self._stream_writer.close()
            self._stream_writer = None
        if isinstance(self.ps, FederatedPS):
            self.ps.close()
