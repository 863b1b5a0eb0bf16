#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's anomaly-detection path on one GPU and check it.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each of which raises on a failed check (the script then exits
non-zero):

  env      torch, CUDA and nvcc versions, the card, and the kernel build
           from src/repro_torch/kernels/csrc/ (timed);
  kernel   the moments kernel against its plain PyTorch version on the card,
           at the repo's test shapes and at full width, with a fid_offset
           sweep, a determinism check and timings;
  trace    main path A: NWChem-shaped traces of 100 ranks x 30 steps through
           the port's sim -> callstack -> make_distributed_ad_step(use_kernel)
           over a one-process NCCL group, held against the float64 host
           StatsTable and the plain-PyTorch step;
  width    main path B: ops.moments_update over 20 steps of 262,144 events
           with F = 2048 and injected outliers, each step replayed through the
           kernel and the plain version;

then one JSON line describing every ported kernel, and last
{"ok": true, "device": {...}}.  Without a CUDA device it exits 2 and prints
no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

SEED = 17
ALPHA = 6.0
# Held as in tests/test_kernels.py:32-37: raw sums rtol 1e-5 (atol 1e-2),
# min/max rtol 1e-6 on rows some event reached, labels exact.
SUMS_RTOL, SUMS_ATOL, EXT_RTOL = 1e-5, 1e-2, 1e-6
KERNEL_CASES = [(64, 16, 32), (500, 128, 128), (1000, 7, 512)]  # test_kernels.py:16
WIDTH_N, WIDTH_F, WIDTH_EB = 262_144, 2048, 512
H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same sheet
MOMENTS_OPS_PER_EVENT = 20  # float32 operations the kernel does per event


def log(msg: str) -> None:
    print(msg, flush=True)


def run_text(cmd) -> str:
    return subprocess.run(cmd, check=True, capture_output=True, text=True).stdout.strip()


# ------------------------------------------------------------------- checks
class Agreement:
    """Largest kernel-vs-plain errors seen over every comparison."""

    def __init__(self):
        self.max_abs = 0.0
        self.max_rel = 0.0

    def check(self, what, d_k, l_k, d_p, l_p):
        import torch

        dk, dp = d_k.double().cpu(), d_p.double().cpu()
        seen = dp[:, 0] > 0
        if not torch.equal(dk[:, 0], dp[:, 0]):
            raise AssertionError(f"{what}: counts differ")
        err = (dk[:, :3] - dp[:, :3]).abs()
        if bool((err > SUMS_ATOL + SUMS_RTOL * dp[:, :3].abs()).any()):
            raise AssertionError(f"{what}: sums beyond rtol {SUMS_RTOL} atol {SUMS_ATOL}, "
                                 f"max abs err {float(err.max())}")
        ext_err = (dk[seen, 3:] - dp[seen, 3:]).abs()
        if bool((ext_err > EXT_RTOL * dp[seen, 3:].abs()).any()):
            raise AssertionError(f"{what}: min/max beyond rtol {EXT_RTOL}")
        if not torch.equal(dk[~seen], dp[~seen]):
            raise AssertionError(f"{what}: empty rows do not hold the ±1e30 sentinels")
        if not torch.equal(l_k.cpu(), l_p.cpu()):
            raise AssertionError(f"{what}: labels differ at "
                                 f"{int((l_k.cpu() != l_p.cpu()).sum())} events")
        rel = err / dp[:, :3].abs().clamp(min=1e-30)
        self.max_abs = max(self.max_abs, float(err.max()), float(ext_err.max()) if seen.any() else 0.0)
        self.max_rel = max(self.max_rel, float(rel[seen].max()) if seen.any() else 0.0)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int) -> float:
    """Mean host milliseconds to enqueue one call of ``fn`` (no synchronise)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    return ms


def device_ms_by_kernel(fn, iters: int) -> dict:
    """Device milliseconds per call of ``fn``, by kernel name (torch.profiler);
    empty where the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            out[ev.key[:60]] = us / 1e3 / iters
    return out


# ---------------------------------------------------------------------- env
def phase_env() -> dict:
    import torch

    from repro_torch.device import parity_mode
    from repro_torch.kernels import _build

    log(f"env: python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    log("env: nvcc " + run_text([_build.nvcc(), "--version"]).splitlines()[-1])
    smi = run_text(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"]).splitlines()[0]
    log(f"env: nvidia-smi {smi}")
    log(f"env: parity {parity_mode()}")
    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"env: built {sorted(logs) or 'nothing (cached)'} in {build_s:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"env: ptxas[{name}] {line.strip()}")
    return {"smi": smi, "build_s": build_s}


# ------------------------------------------------------------------- kernel
def _kernel_inputs(rng, N, F, prev_events, outliers, fid_low=-1):
    import torch

    from repro_torch.kernels.ref import moments_and_labels_ref

    fids = rng.integers(fid_low, F, N).astype(np.int32)
    durs = rng.lognormal(3, 1, N).astype(np.float32)
    durs[:outliers] = 1e5
    prev_f = rng.integers(0, F, prev_events).astype(np.int32)
    prev_x = rng.lognormal(3, 0.2, prev_events).astype(np.float32)
    prev, _ = moments_and_labels_ref(torch.from_numpy(prev_f), torch.from_numpy(prev_x),
                                     torch.zeros((F, 5)))
    return torch.from_numpy(fids), torch.from_numpy(durs), prev


def phase_kernel(dev, agree: Agreement) -> dict:
    import torch

    from repro_torch.kernels import moments as mo
    from repro_torch.kernels.ref import moments_and_labels_ref

    rng = np.random.default_rng(SEED)
    for N, F, EB in KERNEL_CASES:
        f, d, prev = (t.to(dev) for t in _kernel_inputs(rng, N, F, 4 * F, 3))
        d_k, l_k = mo.moments_and_labels(f, d, prev, block_events=EB)
        d_p, l_p = moments_and_labels_ref(f, d, prev)
        agree.check(f"kernel N={N} F={F} EB={EB}", d_k, l_k, d_p, l_p)
        log(f"kernel: N={N} F={F} EB={EB} ok, labelled {int(l_k.sum())}")

    N, F, EB = WIDTH_N, WIDTH_F, WIDTH_EB
    f, d, prev = (t.to(dev) for t in _kernel_inputs(rng, N, F, 64 * F, 8))
    d_k, l_k = mo.moments_and_labels(f, d, prev, block_events=EB)
    d_p, l_p = moments_and_labels_ref(f, d, prev)
    agree.check(f"kernel full width N={N} F={F}", d_k, l_k, d_p, l_p)
    if not bool(l_k[:8][f[:8] >= 0].all()):
        raise AssertionError("full width: an injected 1e5 outlier was not labelled")
    d_k2, l_k2 = mo.moments_and_labels(f, d, prev, block_events=EB)
    if not (torch.equal(d_k.view(torch.int32), d_k2.view(torch.int32)) and torch.equal(l_k, l_k2)):
        raise AssertionError("two launches on the same input gave different results")
    log(f"kernel: full width N={N} F={F} EB={EB} ok, labelled {int(l_k.sum())}, "
        f"two launches bitwise equal")

    Fs = 512
    gf = torch.from_numpy(rng.integers(0, F, N).astype(np.int32)).to(dev)
    for off in (0, 512, 1536):
        block = prev[off:off + Fs].contiguous()
        d_k, l_k = mo.moments_and_labels(gf, d, block, fid_offset=off)
        d_p, l_p = moments_and_labels_ref(gf, d, block, fid_offset=off)
        agree.check(f"kernel fid_offset={off}", d_k, l_k, d_p, l_p)
    log(f"kernel: fid_offset sweep Fs={Fs} at 0, 512, 1536 ok")

    launch = lambda: mo.moments_and_labels(f, d, prev, block_events=EB)  # noqa: E731
    kernel_ms = cuda_ms(launch, iters=200)
    plain_ms = cuda_ms(lambda: moments_and_labels_ref(f, d, prev), iters=20)
    nbytes = N * (4 + 4 + 1) + 2 * F * 5 * 4
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = N * MOMENTS_OPS_PER_EVENT / H100_F32_OPS_PER_S * 1e3
    timing = {
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes,
    }
    log(f"kernel: full width kernel {kernel_ms * 1e3:.2f} us, plain {plain_ms * 1e3:.2f} us, "
        f"bound {timing['bound_ms'] * 1e3:.3f} us ({nbytes} B over 3.35 TB/s); "
        f"library: no single PyTorch call computes this function")
    timing["host_ms"] = host_ms(launch, iters=200)
    timing["device_ms"] = device_ms_by_kernel(launch, iters=20)
    log(f"kernel: full width host enqueue {timing['host_ms'] * 1e3:.2f} us/call; device time "
        f"by kernel (torch.profiler, us/call): "
        + (", ".join(f"{k} {v * 1e3:.2f}" for k, v in timing["device_ms"].items())
           or "not measured (no device time recorded)"))

    # The trace path's shape: 100 ranks x 512 calls, F = 7 (main path A).
    rng_t = np.random.default_rng(SEED + 1)
    ft = torch.from_numpy(rng_t.integers(0, 7, 51_200).astype(np.int32)).to(dev)
    dt = torch.from_numpy(rng_t.lognormal(6, 0.5, 51_200).astype(np.float32)).to(dev)
    zt = torch.zeros((7, 5), device=dev)
    timing["trace_shape"] = {
        "N": 51_200, "F": 7,
        "ms": cuda_ms(lambda: mo.moments_and_labels(ft, dt, zt), iters=200),
        "plain_ms": cuda_ms(lambda: moments_and_labels_ref(ft, dt, zt), iters=20),
        "bound_ms": (51_200 * 9 + 2 * 7 * 20) / H100_BYTES_PER_S * 1e3,
        "device_ms": device_ms_by_kernel(lambda: mo.moments_and_labels(ft, dt, zt), iters=20),
    }
    log("kernel: trace shape N=51200 F=7: " + json.dumps(timing["trace_shape"]))
    return timing


# ----------------------------------------------------- main path A: traces
def _trace_step_records(gen, builders, step):
    recs, truths = [], []
    for r, b in enumerate(builders):
        frame, truth = gen.frame(r, step)
        rec, _ = b.process(frame)
        recs.append(rec)
        truths.append(truth)
    E = max(len(r) for r in recs)
    fids = np.full((len(recs), E), -1, np.int32)
    durs = np.zeros((len(recs), E), np.float32)
    for r, rec in enumerate(recs):
        fids[r, :len(rec)] = rec["fid"]
        durs[r, :len(rec)] = rec["runtime"]
    return recs, truths, fids, durs


def phase_trace(dev, group, ranks=100, steps=30, roots=64, min_count=30.0) -> dict:
    import torch

    from repro_torch.core import torch_ad as T
    from repro_torch.core.callstack import CallStackBuilder
    from repro_torch.core.sim import WorkloadGenerator, nwchem_like
    from repro_torch.core.stats import StatsTable
    from repro_torch.kernels import moments as mo

    spec = nwchem_like(anomaly_rate=0.004, roots_per_frame=roots)
    for fs in spec.funcs.values():
        fs.anomaly_scale = 40.0
    gen = WorkloadGenerator(spec, n_ranks=ranks, seed=SEED)
    builders = [CallStackBuilder(rank=r) for r in range(ranks)]
    F = len(gen.registry)
    step_k = T.make_distributed_ad_step(group, alpha=ALPHA, min_count=min_count, use_kernel=True)
    step_p = T.make_distributed_ad_step(group, alpha=ALPHA, min_count=min_count, use_kernel=False)
    table_k = T.init_table(F, device=dev)
    table_p = T.init_table(F, device=dev)
    host = StatsTable(F)
    agree = total = tp = fp = fn = n_events = 0
    host_s = device_s = 0.0

    mo.launches = 0
    for step in range(steps):
        t0 = time.perf_counter()
        recs, truths, fids, durs = _trace_step_records(gen, builders, step)
        valid = fids >= 0
        host.update_batch(fids[valid].astype(np.int64), durs[valid].astype(np.float64))
        host_s += time.perf_counter() - t0

        t0 = time.perf_counter()
        f, d = torch.from_numpy(fids).to(dev), torch.from_numpy(durs).to(dev)
        table_k, labels_k = step_k(table_k, f, d)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        device_s += time.perf_counter() - t0
        table_p, labels_p = step_p(table_p, f, d)

        lk, lp = labels_k.cpu().numpy(), labels_p.cpu().numpy()
        agree += int((lk[valid] == lp[valid]).sum())
        total += int(valid.sum())
        n_events += int(valid.sum())
        for r, (rec, truth) in enumerate(zip(recs, truths)):
            pred = {(int(a), int(b), int(c)) for a, b, c, l in
                    zip(rec["fid"], rec["entry"], rec["exit"], lk[r, :len(rec)]) if l}
            true = {(int(t["fid"]), int(t["entry"]), int(t["exit"]))
                    for t in truth[truth["label"] == 1]}
            tp += len(pred & true)
            fp += len(pred - true)
            fn += len(true - pred)

        got = table_k.double().cpu().numpy()
        if not np.array_equal(got[:, T.N], host.counts()):
            raise AssertionError(f"trace step {step}: n differs from the float64 host table")
        seen = host.counts() > 0
        np.testing.assert_allclose(got[seen, T.MEAN], host.means()[seen], rtol=1e-4,
                                   err_msg=f"trace step {step}: mean")
        sd = np.sqrt(np.maximum(got[:, T.M2] / np.maximum(got[:, T.N], 1.0), 0.0))
        np.testing.assert_allclose(sd[seen], host.stds()[seen], rtol=1e-2,
                                   err_msg=f"trace step {step}: sigma")
    launches = mo.launches

    agreement = agree / max(total, 1)
    if agreement < 0.9999:
        raise AssertionError(f"trace: kernel and plain steps agree on {agreement:.6f} of labels")
    precision = tp / (tp + fp) if tp + fp else 1.0
    recall = tp / (tp + fn) if tp + fn else 1.0
    log(f"trace: {ranks} ranks x {steps} steps, {n_events} calls, F={F}: n exact, mean rtol 1e-4, "
        f"sigma rtol 1e-2 against float64 StatsTable; label agreement kernel/plain "
        f"{agreement:.6f}; precision {precision:.4f} recall {recall:.4f} "
        f"(tp {tp} fp {fp} fn {fn}); host {host_s:.2f} s, device steps {device_s:.3f} s; "
        f"moments launches {launches}")
    return {"launches": launches, "precision": precision, "recall": recall}


# ------------------------------------------------------ main path B: width
def phase_width(dev, agree: Agreement, ranks=64, events=4096, F=WIDTH_F, steps=20,
                warmup=3, outliers=64) -> dict:
    import torch

    from repro_torch.core import torch_ad as T
    from repro_torch.kernels import moments as mo
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import moments_and_labels_ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    table = T.init_table(F, device=dev)
    runs = []
    mo.launches = 0
    t0 = time.perf_counter()
    for step in range(steps):
        fids = torch.randint(0, F, (ranks, events), generator=g, device=dev, dtype=torch.int32)
        durs = torch.empty((ranks, events), device=dev).log_normal_(3.0, 1.0, generator=g)
        pos = None
        if step >= warmup:
            pos = torch.randperm(ranks * events, generator=g, device=dev)[:outliers]
            durs.view(-1)[pos] = 1e6
        new_table, labels = ops.moments_update(table, fids, durs, alpha=ALPHA)
        runs.append((table, fids, durs, labels, pos))
        table = new_table
    if dev.type == "cuda":
        torch.cuda.synchronize()
    path_s = time.perf_counter() - t0
    launches = mo.launches

    for step, (before, fids, durs, labels, pos) in enumerate(runs):
        sums = ops.stats_to_sums(before).contiguous()
        f, d = fids.reshape(-1), durs.reshape(-1)
        d_k, l_k = mo.moments_and_labels(f, d, sums, alpha=ALPHA)
        d_p, l_p = moments_and_labels_ref(f, d, sums, alpha=ALPHA)
        agree.check(f"width step {step}", d_k, l_k, d_p, l_p)
        if not torch.equal(l_k, labels):
            raise AssertionError(f"width step {step}: main-path labels differ from the replay")
        if pos is not None and not bool((labels[pos] == 1).all()):
            raise AssertionError(f"width step {step}: an injected outlier was not labelled")
    n_final = int(table[:, T.N].sum())
    if n_final != ranks * events * steps:
        raise AssertionError(f"width: table holds {n_final} events, expected {ranks * events * steps}")
    log(f"width: {steps} steps x {ranks * events} events, F={F}: kernel == plain each step "
        f"(sums rtol {SUMS_RTOL}, min/max rtol {EXT_RTOL}, labels exact), all "
        f"{outliers * (steps - warmup)} injected outliers labelled; path {path_s:.3f} s "
        f"({path_s / steps * 1e3:.2f} ms/step); moments launches {launches}")
    return {"launches": launches}


# --------------------------------------------------------------------- main
def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; run this on a machine with a GPU",
              file=sys.stderr)
        return 2
    import torch.distributed as dist

    from repro_torch.device import default_device

    dev = default_device()
    torch.cuda.set_device(dev)
    env = phase_env()
    agree = Agreement()
    timing = phase_kernel(dev, agree)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0,
                                world_size=1)
        try:
            trace = phase_trace(dev, dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    width = phase_width(dev, agree)

    launches = {"trace": trace["launches"], "width": width["launches"]}
    if min(launches.values()) <= 0:
        raise AssertionError(f"a main path never launched the moments kernel: {launches}")
    kernels = [{
        "name": "moments_and_labels",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moments.cu",
        "replaces": "src/repro/kernels/moments.py:46",
        "launches": sum(launches.values()),
        "launches_by_path": launches,
        "max_abs_err": agree.max_abs,
        "max_rel_err": agree.max_rel,
        "labels_equal": True,  # every comparison above raised otherwise
        "ms": timing["ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": None,
        "shape": {"N": WIDTH_N, "F": WIDTH_F, "block_events": WIDTH_EB},
        "host_ms": timing["host_ms"],
        "device_ms": timing["device_ms"],
        "trace_shape": timing["trace_shape"],
    }]
    log(f"trace precision {trace['precision']:.4f} recall {trace['recall']:.4f}; "
        f"build {env['build_s']:.2f} s")
    log(env["smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
