"""Training driver (port of ``repro.launch.train``): Chimbuko-monitored,
checkpointed, restartable.

Every step is traced (data/forward+backward/checkpoint phases) through the
TAU-analogue tracer; frames stream to the in-situ ChimbukoMonitor whose
detector flags anomalous steps/phases; step-time straggler detection feeds
mitigation hooks.  Fault tolerance: atomic checkpoints + exact resume (the
data stream is a pure function of (seed, step)), optional failure injection
to exercise the restart path.

The step is the port's ``build_train_step``, called eagerly (no ``jit``),
updating the state in place.  Its attention and Mamba layers run the plain
PyTorch versions, as JAX trains through plain ``attention`` and
``_ssm_scan_fused``: the hand-written kernels are forward-only.  The data,
checkpoints and monitor outputs (``provenance.jsonl``, ``stream.jsonl``,
``trace.json``, ``viz.json``, ``history.json``) are the JAX package's
formats, so a checkpoint from either driver resumes in the other.

Usage (on a CUDA card; ``--device cpu`` runs on the CPU):
  python -m repro_torch.launch.train --arch gemma-2b --smoke --steps 60 \\
      --global-batch 8 --seq 64 --ckpt-dir /tmp/ckpt --monitor-dir /tmp/mon
  python -m repro_torch.launch.train --full --steps 6 --global-batch 4 --seq 1024
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional

import torch

from .. import configs
from .._unported import unported
from ..checkpoint import ckpt as CK
from ..data.pipeline import DataShard, SyntheticStream, to_device
from ..device import resolve
from ..optim.adamw import OptConfig
from ..telemetry import spans as _spans
from ..trace.monitor import ChimbukoMonitor
from ..trace.tracer import Tracer
from ..viz.server import VizServer
from .steps import StepOptions, build_train_step, make_shard_ctx, make_train_state


def _refuse_unported(ps_transport, provdb_transport, shard_endpoints, supervise, ps_wal,
                     viz_port) -> None:
    if "socket" in (ps_transport, provdb_transport) or shard_endpoints or supervise:
        raise unported("socket transports, --shard-endpoints and --supervise "
                       "(repro.net, repro.launch.shard_server)", "2b")
    if ps_wal is not None:
        raise unported("--ps-wal (repro.fault.wal)", "2a")
    if viz_port is not None:
        raise unported("--viz-port (repro.viz.gateway)", "2d")


def train(
    arch: str = "gemma-2b",
    smoke: bool = True,
    steps: int = 60,
    global_batch: int = 8,
    seq: int = 64,
    ckpt_dir: Optional[str] = None,
    monitor_dir: Optional[str] = None,
    ckpt_interval: int = 20,
    fail_at: Optional[int] = None,
    seed: int = 0,
    inject_straggler_at: Optional[int] = None,
    opts: StepOptions = StepOptions(ce_chunk=512, opt=OptConfig(warmup_steps=10, peak_lr=1e-3)),
    log_every: int = 10,
    provdb_shards: int = 1,
    ps_transport: str = "local",
    provdb_transport: str = "local",
    shard_endpoints: Optional[str] = None,
    export_trace: bool = False,
    viz_port: Optional[int] = None,
    supervise: bool = False,
    ps_wal: Optional[str] = None,
    trace_spans: bool = False,
    device=None,
) -> Dict:
    """The JAX driver's ``train``; ``device=None`` is the port's default
    device (``cuda:0``; raises without CUDA)."""
    _refuse_unported(ps_transport, provdb_transport, shard_endpoints, supervise, ps_wal,
                     viz_port)
    device = resolve(device)
    if trace_spans:
        _spans.set_enabled(True)
    cfg = configs.smoke(arch) if smoke else configs.get_config(arch)
    ctx = make_shard_ctx(cfg, None, global_batch, opts)
    step_fn = build_train_step(cfg, ctx, opts)
    stream = SyntheticStream(cfg, DataShard(0, 1, global_batch), seq, seed=seed)

    start_step = 0
    mgr = CK.CheckpointManager(ckpt_dir, interval=ckpt_interval) if ckpt_dir else None
    state = make_train_state(cfg, seed, device=device)
    if mgr is not None:
        restored = mgr.restore_or_none(target=state)
        if restored is not None:
            start_step, state = restored
            print(f"[train] resumed from checkpoint at step {start_step}")

    history = []
    # On a checkpoint resume the provenance store appends instead of
    # truncating, so the auto-restart path keeps every pre-failure anomaly
    # record.
    if monitor_dir:
        os.makedirs(monitor_dir, exist_ok=True)
    # With a monitor dir the reduced record stream persists alongside the
    # provenance JSONL, so `python -m repro_torch.export <monitor_dir>` can
    # produce the Perfetto trace offline; --export-trace additionally
    # streams trace.json continuously *during* the run.
    monitor = ChimbukoMonitor(
        num_funcs=32,
        prov_path=os.path.join(monitor_dir, "provenance.jsonl") if monitor_dir else None,
        min_samples=8, alpha=6.0, straggler_alpha=3.0, straggler_min_steps=8,
        run_info={"arch": cfg.name, "steps": steps, "global_batch": global_batch,
                  "torch_version": torch.__version__, "cuda_version": torch.version.cuda,
                  "device": str(device),
                  "device_name": (torch.cuda.get_device_name(device)
                                  if device.type == "cuda" else "cpu")},
        provdb_shards=provdb_shards,
        prov_append=start_step > 0,
        trace_spans=trace_spans or None,
        stream_path=os.path.join(monitor_dir, "stream.jsonl") if monitor_dir else None,
        export_trace=(
            os.path.join(monitor_dir, "trace.json")
            if export_trace and monitor_dir else None
        ),
    )
    monitor.on_straggler(
        lambda ev: print(f"[monitor] straggler: step={ev.step} z={ev.zscore:.1f}")
    )
    tracer = Tracer(monitor.registry, rank=0)

    for step in range(start_step, steps):
        t0 = time.perf_counter()
        with tracer.span("train/step"):
            with tracer.span("train/data"):
                batch = to_device(stream.batch_at(step), device)
            with tracer.span("train/fwd_bwd_update"):
                state, metrics = step_fn(state, batch)
                loss = float(metrics["loss"])
            if inject_straggler_at is not None and step == inject_straggler_at:
                with tracer.span("train/injected_delay"):
                    time.sleep(0.5)
            if mgr is not None:
                with tracer.span("train/checkpoint", filterable=False):
                    mgr.maybe_save(step + 1, state)
        dt = time.perf_counter() - t0
        monitor.ingest(tracer.drain(step))
        if step - start_step >= 2:  # first-step outliers would poison sigma
            monitor.record_step_times(step, {0: dt})
        history.append({"step": step, "loss": loss, "time_s": dt})
        if step % log_every == 0:
            print(f"[train] step {step:5d} loss {loss:.4f} {dt*1e3:.0f} ms")
        if fail_at is not None and step + 1 == fail_at:
            if mgr is not None:
                mgr.wait()  # fail-stop after in-flight async save settles,
                # so the injected failure is deterministic for resume tests
            print(f"[train] simulated failure at step {step + 1}")
            raise RuntimeError("injected node failure")

    if mgr is not None:
        mgr.maybe_save(steps, state, force=True)
        mgr.wait()
    summary = monitor.summary()
    if monitor_dir:
        os.makedirs(monitor_dir, exist_ok=True)
        VizServer(monitor).dump(os.path.join(monitor_dir, "viz.json"))
        with open(os.path.join(monitor_dir, "history.json"), "w") as f:
            json.dump(history, f)
    monitor.close()
    return {"history": history, "monitor": summary,
            "final_loss": history[-1]["loss"] if history else None}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--monitor-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None)
    ap.add_argument("--auto-restart", action="store_true")
    ap.add_argument("--inject-straggler-at", type=int, default=None)
    ap.add_argument("--provdb-shards", type=int, default=1)
    ap.add_argument("--ps-transport", choices=("local", "socket"), default="local")
    ap.add_argument("--provdb-transport", choices=("local", "socket"), default="local")
    ap.add_argument(
        "--shard-endpoints", default=None,
        help="shard_server workers (not ported yet: ROADMAP.md queue 1, item 2b)",
    )
    ap.add_argument(
        "--supervise", action="store_true",
        help="respawn dead shard workers (not ported yet: item 2b)",
    )
    ap.add_argument(
        "--ps-wal", default=None, metavar="DIR",
        help="write-ahead-log directory for PS shards (not ported yet: item 2a)",
    )
    ap.add_argument(
        "--trace-spans", action="store_true",
        help="distributed request tracing: per-process span flight recorders "
        "and span trees in the trace export (this process's spans only)",
    )
    ap.add_argument(
        "--export-trace", action="store_true",
        help="continuously write <monitor-dir>/trace.json (Chrome Trace "
        "Event JSON, openable in ui.perfetto.dev) during the run",
    )
    ap.add_argument(
        "--viz-port", type=int, default=None,
        help="serve the live viz gateway (not ported yet: item 2d)",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="default: cuda:0")
    args = ap.parse_args()
    if args.export_trace and not args.monitor_dir:
        ap.error("--export-trace needs --monitor-dir (trace.json lives there)")

    kw = dict(
        arch=args.arch, smoke=args.smoke, steps=args.steps,
        global_batch=args.global_batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
        monitor_dir=args.monitor_dir, ckpt_interval=args.ckpt_interval,
        seed=args.seed, inject_straggler_at=args.inject_straggler_at,
        provdb_shards=args.provdb_shards,
        ps_transport=args.ps_transport, provdb_transport=args.provdb_transport,
        shard_endpoints=args.shard_endpoints,
        export_trace=args.export_trace,
        viz_port=args.viz_port,
        supervise=args.supervise,
        ps_wal=args.ps_wal,
        trace_spans=args.trace_spans,
        device=args.device,
    )
    if args.auto_restart:
        attempts = 0
        while True:
            try:
                out = train(fail_at=args.fail_at if attempts == 0 else None, **kw)
                break
            except RuntimeError as e:
                attempts += 1
                print(f"[train] restart #{attempts} after: {e}")
                assert attempts < 5, "too many restarts"
    else:
        out = train(fail_at=args.fail_at, **kw)
    print(json.dumps(out["monitor"], indent=2))


if __name__ == "__main__":
    main()
