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
  flash    the flash-attention kernel against its plain PyTorch version on
           the card: the repo's 8 test shapes, the kv_len case, ragged shapes,
           100 random shapes and the full-width gemma-2b prefill shape (B 4,
           S 1024, H 8, KV 1, hd 256, causal, bf16, and again in float32),
           with a determinism check and timings beside one
           scaled_dot_product_attention call (a yardstick only);
  serve    main path C: repro_torch.launch.serve at gemma-2b's published
           width (8 requests of 1024 prompt tokens, 32 new tokens each, in
           waves of 4) with the port's ChimbukoMonitor; then the float32
           gemma-2b smoke model through prefill and decode on the card (the
           kernel) and on the CPU (the plain version), logits held together;

then one JSON line describing every ported kernel, and last
{"ok": true, "device": {...}}.  Without a CUDA device it exits 2 and prints
no result.
"""
from __future__ import annotations

import dataclasses
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
H100_BF16_OPS_PER_S = 989e12  # bf16 dense tensor cores, same sheet
MOMENTS_OPS_PER_EVENT = 20  # float32 operations the kernel does per event
FLASH_CASES = [  # tests/test_kernels.py:66-76: (B, Sq, Sk, H, KV, hd, causal, window, cap, dtype)
    (2, 128, 128, 4, 4, 64, True, 0, 0.0, "float32"),
    (1, 256, 256, 4, 2, 64, True, 0, 0.0, "float32"),
    (2, 128, 128, 8, 1, 64, True, 0, 0.0, "bfloat16"),
    (1, 256, 256, 4, 4, 64, False, 0, 0.0, "float32"),
    (1, 256, 256, 4, 2, 64, True, 100, 0.0, "float32"),
    (1, 128, 128, 2, 2, 64, True, 0, 50.0, "float32"),
    (1, 128, 128, 2, 2, 120, True, 0, 0.0, "float32"),
    (1, 128, 128, 2, 1, 256, True, 64, 30.0, "bfloat16"),
]
FLASH_RAGGED = [  # shapes the Pallas wrapper refuses; the kernel masks the edges
    (2, 70, 70, 4, 2, 16, True, 0, 0.0, "float32"),
    (2, 33, 97, 4, 2, 120, False, 0, 0.0, "float32"),
    (2, 100, 100, 4, 2, 256, True, 40, 30.0, "bfloat16"),
]
FLASH_FULL = (4, 1024, 1024, 8, 1, 256, True, 0, 0.0, "bfloat16")  # gemma-2b prefill wave
FLASH_SWEEP = 100  # random shapes: GQA groups, head dims, ragged lengths, masks, dtypes
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:88
SERVE = dict(arch="gemma-2b", n_requests=8, batch=4, prompt_len=1024, max_new=32)


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


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0 (before a main path)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moments as mo

    mo.launches = 0
    fa.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moments as mo

    return {"moments_and_labels": mo.launches, "flash_attention": fa.launches}


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


# The name torch.profiler gives each kernel of the port, by wrapper count.
PROFILER_NAMES = {"moments_and_labels": ("moments_pass1", "moments_pass2"),
                  "flash_attention": ("flash_fwd",)}


def _profile(fn, calls: int):
    """Profile ``calls`` calls of ``fn`` after a warm-up cycle of as many, so
    that the recorded cycle loses nothing to the profiler's start.  Returns
    {kernel name[:120]: (device ms, launches)}, the host wall ms of the
    recorded cycle, and the wrapper counts' rise over it."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):  # warm-up cycle, then the recorded one
            before = read_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            launched = {k: v - before[k] for k, v in read_counts().items()}
            prof.step()
    by_kernel = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA") and \
                not ev.key.startswith("ProfilerStep"):  # the schedule's own range, no kernel
            ms, n = by_kernel.get(ev.key[:120], (0.0, 0))
            by_kernel[ev.key[:120]] = (ms + us / 1e3, n + ev.count)
    ops = sum(1 for e in prof.events() if e.name.startswith("aten::") and not (
        e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::")))
    return by_kernel, wall_ms, launched, ops / calls


def _lost_launches(by_kernel, calls, launched) -> str:
    """Why a profile cannot be read ('' where it can): a kernel the profiler
    saw a number of times that is no multiple of ``calls``, or a kernel of
    the port seen fewer or more times than its wrapper launched it."""
    for name, (_, n) in by_kernel.items():
        if n % calls:
            return f"{name}: {n} launches over {calls} calls"
    for wrapper, names in PROFILER_NAMES.items():
        for part in names:
            n = sum(c for k, (_, c) in by_kernel.items() if part in k)
            if n != launched[wrapper]:
                return f"{part}: profiler saw {n} launches, the wrapper made {launched[wrapper]}"
    return ""


def profiled(fn, calls: int, tries: int = 3):
    """``_profile`` taken again (at most ``tries`` times in all) while the
    profiler has lost a launch; raises if it still has.  A profile with no
    device time at all is returned as it is: its device times then read
    "not measured"."""
    for _ in range(tries):
        by_kernel, wall_ms, launched, ops = _profile(fn, calls)
        why = _lost_launches(by_kernel, calls, launched)
        if not why or not by_kernel:
            return by_kernel, wall_ms, ops
        log(f"profile: lost launches ({why}); taken again")
    raise AssertionError(f"torch.profiler lost launches in {tries} profiles: {why}")


def device_ms_by_kernel(fn, iters: int) -> dict:
    """Device milliseconds per launch of each kernel of ``fn`` (torch.profiler,
    over ``iters`` calls; every kernel here launches once per call)."""
    by_kernel, _, _ = profiled(fn, iters)
    return {name: ms / n for name, (ms, n) in by_kernel.items()}


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
        f"by kernel (torch.profiler, us/launch): "
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

    zero_counts()
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
    counts = read_counts()
    launches = counts["moments_and_labels"]

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
    return {"counts": counts, "precision": precision, "recall": recall}


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
    zero_counts()
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
    counts = read_counts()
    launches = counts["moments_and_labels"]

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
    return {"counts": counts}


# -------------------------------------------------------------------- flash
class FlashAgreement:
    """Largest kernel-vs-plain errors over every flash comparison; the
    relative error is taken where the plain output is at least 0.01."""

    def __init__(self):
        self.max_abs = 0.0
        self.max_rel = 0.0

    def check(self, what, got, want, tol):
        import torch

        g, w = got.double().cpu(), want.double().cpu()
        if g.shape != w.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: shape {tuple(g.shape)} or non-finite output")
        err = (g - w).abs()
        if bool((err > tol + tol * w.abs()).any()):
            raise AssertionError(f"{what}: beyond rtol = atol = {tol}, max abs err "
                                 f"{float(err.max())}")
        big = w.abs() >= 0.01
        self.max_abs = max(self.max_abs, float(err.max()))
        if bool(big.any()):
            self.max_rel = max(self.max_rel, float((err[big] / w.abs()[big]).max()))


def _flash_inputs(dev, case, seed):
    import torch

    B, Sq, Sk, H, KV, hd, _, _, _, dtype = case
    rng = np.random.default_rng(seed)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dev, dt)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]


def flash_bound(case) -> dict:
    """The least time for one call at ``case``: the QK^T and PV products of
    the live (query, key) pairs over the bf16 tensor-core rate, against each
    input read once and the output written once over the memory rate."""
    B, Sq, Sk, H, KV, hd, causal, window, _, dtype = case
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    live = np.ones((Sq, Sk), bool)
    if causal:
        live &= k <= q
    if window > 0:
        live &= (q - k) < window
    flops = 4.0 * hd * B * H * float(live.sum())  # 2 per multiply-add, two products
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = itemsize * (2 * B * Sq * H * hd + 2 * B * Sk * KV * hd)
    rate = H100_BF16_OPS_PER_S if dtype == "bfloat16" else H100_F32_OPS_PER_S
    ops_ms, bytes_ms = flops / rate * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_flash(dev, agree: FlashAgreement) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref

    def compare(what, case, seed, kv_len=None):
        q, k, v = _flash_inputs(dev, case, seed)
        kw = dict(causal=case[6], window=case[7], cap=case[8], kv_len=kv_len)
        got = ops.flash_attention(q, k, v, **kw)
        agree.check(what, got, flash_attention_ref(q, k, v, **kw), FLASH_TOL[case[9]])
        return q, k, v, got

    for i, case in enumerate(FLASH_CASES):
        compare(f"flash case {i} {case}", case, case[5] + case[1] + case[3])
    compare("flash kv_len=77", (1, 64, 128, 2, 2, 64, False, 0, 0.0, "float32"), 1, kv_len=77)
    for case in FLASH_RAGGED:
        compare(f"flash ragged {case}", case, sum(case[1:3]))
    rng = np.random.default_rng(SEED)
    for i in range(FLASH_SWEEP):
        KV, G = int(rng.choice([1, 2, 4])), int(rng.choice([1, 2, 4, 8]))
        case = (int(rng.integers(1, 4)), int(rng.integers(1, 300)), int(rng.integers(1, 300)),
                KV * G, KV, int(rng.choice([16, 64, 80, 120, 128, 200, 256])),
                bool(rng.integers(0, 2)), int(rng.choice([0, 0, 1, 7, 64, 150])),
                float(rng.choice([0.0, 0.0, 5.0, 30.0])), str(rng.choice(["float32", "bfloat16"])))
        kv_len = None if rng.random() < 0.6 else int(rng.integers(0, case[2] + 5))
        compare(f"flash sweep {i} {case} kv_len={kv_len}", case, i, kv_len=kv_len)
    log(f"flash: {len(FLASH_CASES)} test shapes, kv_len=77, {len(FLASH_RAGGED)} ragged shapes "
        f"and {FLASH_SWEEP} random shapes within 2e-5 (f32) / 2e-2 (bf16) of the plain version")

    q, k, v, out = compare("flash full width float32", FLASH_FULL[:9] + ("float32",), SEED)
    f32_err = float((out - flash_attention_ref(q, k, v, causal=True)).abs().max())
    q, k, v, out = compare("flash full width", FLASH_FULL, SEED)
    again = fa.flash_attention(q, k, v, causal=True)
    if not torch.equal(out.view(torch.int16), again.view(torch.int16)):
        raise AssertionError("flash: two launches on the same input gave different results")
    log(f"flash: full width {FLASH_FULL} ok (and in float32 within 2e-5, max abs err "
        f"{f32_err:.3g}), two launches bitwise equal; max abs err "
        f"{agree.max_abs:.3g}, max rel err {agree.max_rel:.3g}")

    launch = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # (B, heads, S, hd)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    lib = library().transpose(1, 2)
    agree_lib = float((lib.float() - out.float()).abs().max())
    timing = {
        "ms": cuda_ms(launch, iters=20),
        "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True), iters=5),
        "library_ms": cuda_ms(library, iters=20),
        "host_ms": host_ms(launch, iters=20),
        "device_ms": device_ms_by_kernel(launch, iters=5),
        "library_max_abs_diff": agree_lib,
        **flash_bound(FLASH_FULL),
    }
    log(f"flash: full width kernel {timing['ms'] * 1e3:.1f} us/call, plain "
        f"{timing['plain_ms'] * 1e3:.1f} us, scaled_dot_product_attention "
        f"{timing['library_ms'] * 1e3:.1f} us (max abs diff to the kernel {agree_lib:.3g}), "
        f"bound {timing['bound_ms'] * 1e3:.2f} us ({timing['bound_by']}: "
        f"{timing['flops'] / 1e9:.2f} GFLOP, {timing['bytes'] / 1e6:.1f} MB); host enqueue "
        f"{timing['host_ms'] * 1e3:.1f} us; device by kernel (torch.profiler, us/launch): "
        + (", ".join(f"{n} {m * 1e3:.1f}" for n, m in timing["device_ms"].items())
           or "not measured (no device time recorded)"))
    return timing


# ----------------------------------------------------- main path C: serve
def device_breakdown(fn) -> dict:
    """One profiled call of ``fn``: device ms by kernel (top 8), the sum, the
    host wall ms around it, the share of that wall time the device spent in
    no kernel (one stream, so kernels do not overlap), and the number of
    top-level aten ops the host dispatched."""
    by_kernel, wall_ms, ops = profiled(fn, 1)
    busy = sum(ms for ms, _ in by_kernel.values())
    top = dict(sorted(((k, ms) for k, (ms, _) in by_kernel.items()), key=lambda kv: -kv[1])[:8])
    return {"wall_ms": wall_ms, "device_ms": busy, "top": top, "host_ops": int(ops),
            "idle_share": (1.0 - busy / wall_ms) if busy > 0 else None}


def phase_serve(dev) -> dict:
    import torch

    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params

    cfg = configs.get_config(SERVE["arch"])
    params = init_params(cfg, SEED, dev)
    param_bytes = sum(t.numel() * t.element_size() for t in
                      [params["embed"], params["final_ln"]]
                      + [x for layer in params["layers"] for x in layer.values()])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    out = serve(smoke=False, seed=SEED, params=params, device=dev, **SERVE)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    waves = -(-SERVE["n_requests"] // SERVE["batch"])
    want_launches = cfg.n_layers * waves
    mon = out["monitor"]
    if out["requests"] != SERVE["n_requests"] or \
            out["tokens"] != SERVE["n_requests"] * SERVE["max_new"]:
        raise AssertionError(f"serve: {out['requests']} requests, {out['tokens']} tokens")
    if mon["frames"] <= 0 or mon["events"] <= 0:
        raise AssertionError(f"serve: empty monitor summary {mon}")
    if counts["flash_attention"] != want_launches:
        raise AssertionError(f"serve: {counts['flash_attention']} flash launches, expected "
                             f"{want_launches} ({cfg.n_layers} layers x {waves} waves)")
    log(f"serve: {cfg.name} full width, {cfg.n_params():,} parameters ({param_bytes / 1e9:.2f} "
        f"GB float32 master); {out['requests']} requests, {out['tokens']} tokens in "
        f"{serve_s:.2f} s, {out['tok_per_s']:.1f} tok/s; peak memory {peak / 1e9:.2f} GB; "
        f"flash launches {counts['flash_attention']}; monitor frames {mon['frames']} events "
        f"{mon['events']} anomalies {mon['anomalies']} ps_updates {mon['ps_updates']} "
        f"stragglers {mon['stragglers']}; samples {out['samples']}")

    # The same weights, one wave timed outside the driver (CUDA events).
    cparams = M.compute_params(cfg, params)
    del params
    g = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab, (SERVE["batch"], SERVE["prompt_len"]), generator=g,
                         device=dev, dtype=torch.int32)
    max_seq = SERVE["prompt_len"] + SERVE["max_new"]
    prefill = lambda: M.prefill(cfg, cparams, {"tokens": toks}, max_seq=max_seq)  # noqa: E731
    logits, cache = prefill()
    if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
        raise AssertionError("serve: non-finite prefill logits")
    prefill_ms = cuda_ms(prefill, iters=3, warmup=1)
    nxt = torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    steps = 16
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        logits, cache = M.decode_step(cfg, cparams, cache, nxt)
        nxt = torch.argmax(logits[:, 0], -1)[:, None].to(torch.int32)
    end.record()
    end.synchronize()
    decode_ms = start.elapsed_time(end) / steps
    if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
        raise AssertionError("serve: non-finite decode logits")
    _, cache = prefill()
    prof_prefill = device_breakdown(prefill)
    prof_decode = device_breakdown(lambda: M.decode_step(cfg, cparams, cache, nxt))
    log(f"serve: prefill {prefill_ms:.2f} ms per wave of {SERVE['batch']} x "
        f"{SERVE['prompt_len']} tokens, decode {decode_ms:.2f} ms per step of "
        f"{SERVE['batch']} tokens (CUDA events, steps after the serve run)")
    for name, prof in (("prefill", prof_prefill), ("decode step", prof_decode)):
        log(f"serve: {name} traced: {prof['host_ops']} top-level aten ops, wall "
            f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms, idle share "
            + (f"{prof['idle_share']:.3f}" if prof["idle_share"] is not None
               else "not measured")
            + "; top kernels (ms): "
            + ", ".join(f"{n} {m:.3f}" for n, m in prof["top"].items()))
    del cparams, cache, logits

    # float32 smoke gemma-2b, same weights: the card (kernel) against the CPU (plain).
    smoke = dataclasses.replace(configs.smoke(SERVE["arch"]), compute_dtype=torch.float32)
    p_cpu = init_params(smoke, SEED, "cpu")
    p_dev = {**{k: v.to(dev) for k, v in p_cpu.items() if k != "layers"},
             "layers": [{k: v.to(dev) for k, v in layer.items()} for layer in p_cpu["layers"]]}
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, smoke.vocab, (2, 44)).astype(np.int32))
    runs = {}
    for where, p in (("card", p_dev), ("cpu", p_cpu)):
        t = toks.to(p["embed"].device)
        logits, cache = M.prefill(smoke, p, {"tokens": t[:, :40]}, max_seq=44)
        outs = [logits[..., :smoke.vocab].cpu()]
        for i in range(40, 44):
            logits, cache = M.decode_step(smoke, p, cache, t[:, i:i + 1])
            outs.append(logits[..., :smoke.vocab].cpu())
        runs[where] = torch.cat(outs, dim=1)
    smoke_err = float((runs["card"] - runs["cpu"]).abs().max())
    np.testing.assert_allclose(runs["card"].numpy(), runs["cpu"].numpy(), rtol=1e-4, atol=1e-3,
                               err_msg="serve: float32 smoke logits, card vs CPU")
    log(f"serve: float32 smoke {smoke.name} prefill(40) + 4 decode steps, card (kernel) vs "
        f"CPU (plain): logits within rtol 1e-4 / atol 1e-3, max abs diff {smoke_err:.3g}")
    return {"counts": counts, "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "tok_per_s": out["tok_per_s"], "peak_bytes": peak, "param_bytes": param_bytes}


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
    flash_agree = FlashAgreement()
    flash = phase_flash(dev, flash_agree)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0,
                                world_size=1)
        try:
            trace = phase_trace(dev, dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    width = phase_width(dev, agree)
    served = phase_serve(dev)

    paths = {"trace": trace["counts"], "width": width["counts"], "serve": served["counts"]}
    needs = {"trace": "moments_and_labels", "width": "moments_and_labels",
             "serve": "flash_attention"}
    for path, name in needs.items():
        if paths[path][name] <= 0:
            raise AssertionError(f"main path {path} never launched {name}: {paths[path]}")

    def by_path(name):
        return {path: c[name] for path, c in paths.items()}

    kernels = [{
        "name": "moments_and_labels",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/moments.cu",
        "replaces": "src/repro/kernels/moments.py:46",
        "launches": sum(by_path("moments_and_labels").values()),
        "launches_by_path": by_path("moments_and_labels"),
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
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:35",
        "launches": sum(by_path("flash_attention").values()),
        "launches_by_path": by_path("flash_attention"),
        "max_abs_err": flash_agree.max_abs,
        "max_rel_err": flash_agree.max_rel,
        "ms": flash["ms"],
        "plain_ms": flash["plain_ms"],
        "bound_ms": flash["bound_ms"],
        "bound_by": flash["bound_by"],
        "library_ms": flash["library_ms"],
        "shape": dict(zip(("B", "Sq", "Sk", "H", "KV", "hd", "causal", "window", "cap",
                           "dtype"), FLASH_FULL)),
        "host_ms": flash["host_ms"],
        "device_ms": flash["device_ms"],
        "serve": {k: served[k] for k in ("prefill_ms", "decode_ms", "tok_per_s",
                                         "peak_bytes", "param_bytes")},
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
