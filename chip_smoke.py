#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each of which raises on a failed check (the script then exits
non-zero):

  env      torch, CUDA and nvcc versions, the card, and the kernel build
           from src/repro_torch/kernels/csrc/ (timed);
  kernel   the moments kernel against its plain PyTorch version on the card,
           at the repo's test shapes and at full width, with a fid_offset
           sweep, determinism on one stream and across two (two workspaces),
           its ptxas line and SASS counts (the cluster barrier and
           distributed shared memory required), and timings at the width
           and trace shapes: CUDA events, 200 launches in one CUDA graph,
           host enqueue and its input checks, device time, and the launch
           floor (an empty kernel of the same geometry);
  trace    main path A: NWChem-shaped traces of 100 ranks x 30 steps through
           the port's sim -> callstack -> make_distributed_ad_step(use_kernel)
           over a one-process NCCL group, held against the float64 host
           StatsTable and the plain-PyTorch step;
  width    main path B: ops.moments_update over 20 steps of 262,144 events
           with F = 2048 and injected outliers, each step replayed through the
           kernel and the plain version;
  flash    the flash-attention kernel against its plain PyTorch version on
           the card: the repo's 8 test shapes, the kv_len case, ragged shapes,
           100 random shapes, the full-width gemma-2b prefill shape (B 4,
           S 1024, H 8, KV 1, hd 256, causal, bf16, and again in float32) and
           the attention shapes of gemma2-2b and h2o-danube3-4b at one wave;
           bf16 goes through the tensor-core instances (wgmma, TMA), float32
           through the CUDA-core one.  Each instance's SASS instruction counts
           (HGMMA and UTMALDG required in bf16) and ptxas line (no spills), a
           determinism check, and timings of both dtypes at full width in
           turns with one scaled_dot_product_attention call (a yardstick
           only);
  scan     the selective-scan kernel against its plain PyTorch version on
           the card: the repo's 4 test shapes, ragged shapes (S 1 and 77, d_inner
           no multiple of a CTA's channels, d_state 1, 3, 4, 8 and 32), 40
           random shapes and the full-width falcon-mamba-7b prefill shape
           (B 4, S 1024, d_inner 8192, d_state 16), with a determinism check
           and timings;
  serve    main path C: repro_torch.launch.serve at gemma-2b's published
           width (8 requests of 1024 prompt tokens, 32 new tokens each, in
           waves of 4) with the port's ChimbukoMonitor; then the float32
           gemma-2b smoke model through prefill and decode on the card (the
           kernel) and on the CPU (the plain version), logits held together,
           and the same in bf16 for the gemma-2b and gemma2-2b smoke models;
  serve_ssm  main path D: the same traffic and checks on falcon-mamba-7b at
           its published width (64 Mamba layers, no attention), whose every
           prefill layer runs the scan kernel;
  refusals the card-only limits (moments' F, flash's TMA alignment) raise
           for CUDA tensors without a launch; the CPU takes the same inputs;
  train    main path E: repro_torch.launch.train.train on gemma-2b at its
           published width (global batch 4 x 1024 tokens, remat "block",
           ce_chunk 512, 6 steps, monitored, trace export on): losses, grad
           norms, step times (host and CUDA events), tokens/s, peak memory,
           monitor outputs, and no port kernel launched (training runs the
           plain versions, as JAX does); one traced step (idle share, top
           kernels); one float32 step of the same width cut to 2 layers on the
           card against the CPU; and the exact-resume check on the smoke
           model (tests/test_training.py:63) on the card;
  train_socket  main path F: path E's run for 24 steps with an injected
           straggler, the monitor's PS and provenance DB in two supervised
           shard worker processes (socket transports, a PS write-ahead log),
           against a local-transport run of the same configuration: (F-a)
           equal losses, socket transports in the summary, at least one
           anomaly; the frames that run's monitor ingested are archived and
           (F-b) replayed offline with local transports to the live events,
           anomalies and PS table; (F-c) replayed twice through a supervised
           worker pool with a WAL, once with two seed-chosen SIGKILLs: PS
           snapshot and provenance files byte-identical, anomalies equal;
           step times, tokens/s and peak memory beside path E's, the
           workers' spawn time, each respawn and the replay rates;

then the script's wall time, the card's name and power limit, one JSON line
describing every ported kernel, and last
{"ok": true, "device": {...}}.  Without a CUDA device it exits 2 and prints
no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
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
KERNEL_EDGES = [  # (N, F, block_events) the grid and the row split must get right
    (0, 16, 512), (1, 1, 512), (300, 7, 37), (1000, 3, 100), (5000, 129, 1024),
    (100_000, 2048, 32), (70_000, 10_000, 512)]
WIDTH_N, WIDTH_F, WIDTH_EB = 262_144, 2048, 512
H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # float32 outside the tensor cores, same sheet
H100_BF16_OPS_PER_S = 989e12  # bf16 dense tensor cores, same sheet
MOMENTS_OPS_PER_EVENT = 20  # float32 operations the kernel does per event
MOMENTS_SASS = ("UCGABAR_ARV", "UCGABAR_WAIT", "LD", "LDS", "STS", "LDG", "STG", "ATOM",
                "VOTE", "SHFL", "BAR", "MEMBAR")
MOMENTS_SASS_NEEDS = {"cluster barrier": ("UCGABAR_ARV", "UCGABAR_WAIT"),
                      # ld.shared::cluster of the peers' tables: the kernel's only LD
                      # (its own shared memory is LDS, global memory LDG)
                      "distributed shared memory": ("LD",)}
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
FLASH_MODELS = {  # the other bf16 configs' attention at one wave (configs/*.py)
    "gemma2-2b": (4, 1024, 1024, 8, 4, 256, True, 4096, 50.0, "bfloat16"),
    "h2o-danube3-4b": (4, 1024, 1024, 32, 8, 120, True, 4096, 0.0, "bfloat16"),
}
FLASH_SASS = ("HGMMA", "UTMALDG", "SYNCS", "MUFU", "FFMA", "FMUL", "LDS", "STS", "BAR")
FLASH_SWEEP = 100  # random shapes: GQA groups, head dims, ragged lengths, masks, dtypes
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_kernels.py:88
SCAN_CASES = [(1, 64, 16, 4), (2, 128, 64, 16), (1, 256, 32, 16),  # test_kernels.py:120-122
              (2, 128, 32, 8)]  # test_kernels.py:140: (B, S, d_inner, d_state)
SCAN_RAGGED = [(2, 1, 16, 16), (1, 77, 32, 16), (2, 33, 50, 16), (1, 40, 24, 3),
               (2, 29, 37, 4), (1, 45, 70, 8), (1, 20, 9, 1), (1, 12, 5, 32)]
SCAN_SWEEP = 40  # random shapes: batch, ragged S and d_inner, every d_state up to 32
SCAN_FULL = (4, 1024, 8192, 16)  # falcon-mamba-7b prefill wave: B, S, d_inner, d_state
SCAN_TOL = 1e-5  # tests/test_kernels.py:133-134
SCAN_OPS_PER_STATE = 4  # h = a*h + b (2), h*C and its share of the sum over st (2)
SERVE = dict(n_requests=8, batch=4, prompt_len=1024, max_new=32)
TRAIN = dict(arch="gemma-2b", steps=6, global_batch=4, seq=1024)  # path E
# path E's StepOptions: train.py's default (remat "block", ce_chunk 512, warmup 10, lr 1e-3)
TRAIN_OPTS = dict(remat="block", ce_chunk=512, opt=dict(warmup_steps=10, peak_lr=1e-3))
# Path F: path E's configuration with the monitor's PS and provenance in two
# supervised shard worker processes.  24 steps, the straggler at step 20: the
# socket federation's PS aggregate refreshes every 16 frames
# (ChimbukoMonitor(ps_aggregate_every=16)), and before the first refresh it is
# empty, so no call of steps 0-15 can be labelled; a self-inclusive mu +- 6
# sigma over n samples bounds any z to sqrt(n - 1), so the local PS cannot
# label one either in fewer than 38 steps.  Steps 16-30 are labelled against
# steps 0-15.  Losses against the local run at the card's exact-resume rtol.
TRAIN_SOCKET = dict(steps=24, inject_straggler_at=20, shards=2, loss_rtol=1e-5,
                    chaos_seed=2026)
# The training driver's monitor settings (launch/train.py), for the replays.
TRAIN_MONITOR = dict(num_funcs=32, kw=dict(min_samples=8, alpha=6.0, straggler_alpha=3.0,
                                           straggler_min_steps=8))
TRAIN_LOSS0_ATOL = 2.0  # step 0 near ln V: random weights give near-uniform logits
# The card-vs-CPU step: float32 (TF32 off), full width cut to 2 layers.  Loss
# and grad norm at float32 sums' tolerances; Adam's first step moves each
# weight by about lr * sign(g), so an element whose tiny gradient changes
# sign between the two summation orders moves by up to 2 lr the other way:
# a share of 1e-4 of the elements may miss rtol 1e-4 / atol 1e-6 (never by
# more than 2 lr).
TRAIN_PARITY = dict(n_layers=2, batch=1, seq=64, loss_rtol=1e-5, grad_norm_rtol=1e-4,
                    params_rtol=1e-4, params_atol=1e-6, params_off_share=1e-4)
SMOKE_TOL = {"float32": dict(rtol=1e-4, atol=1e-3),  # tests/test_torch_models.py:43
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}  # tests/test_torch_models.py:229


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


def _wrappers() -> dict:
    """Each kernel's wrapper module, by kernel name."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import moments as mo

    return {"moments_and_labels": mo, "flash_attention": fa, "mamba_scan": ms}


def zero_counts() -> None:
    """Set every kernel wrapper's launch count to 0 (before a main path)."""
    for mod in _wrappers().values():
        mod.launches = 0


def read_counts() -> dict:
    return {name: mod.launches for name, mod in _wrappers().items()}


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
PROFILER_NAMES = {"moments_and_labels": ("moments_cluster",),
                  "flash_attention": ("flash_fwd",), "mamba_scan": ("mamba_scan_fwd",)}


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


def profiled(fn, calls: int, tries: int = 6):
    """``_profile`` taken again (at most ``tries`` times in all) while the
    profiler has lost a launch; raises if it still has.  A profile with no
    device time at all is returned as it is: its device times then read
    "not measured".  (Three profiles in a row lost scan launches in one
    H100 run, hence six.)"""
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
    for N, F, EB in KERNEL_EDGES:
        f, d, prev = (t.to(dev) for t in _kernel_inputs(rng, N, F, 4 * F, min(N, 3)))
        d_k, l_k = mo.moments_and_labels(f, d, prev, block_events=EB)
        agree.check(f"kernel edge N={N} F={F} EB={EB}", d_k, l_k,
                    *moments_and_labels_ref(f, d, prev))
    log(f"kernel: {len(KERNEL_EDGES)} edge shapes ok (empty stream, one event, F below the "
        f"cluster size, ragged chunks, chunks past the grid, F near the shared-memory limit)")

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
        d_o, l_o = mo.moments_and_labels(gf, d, block, fid_offset=off)
        d_p, l_p = moments_and_labels_ref(gf, d, block, fid_offset=off)
        agree.check(f"kernel fid_offset={off}", d_o, l_o, d_p, l_p)
    log(f"kernel: fid_offset sweep Fs={Fs} at 0, 512, 1536 ok")

    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    on_streams = []
    for s in (s1, s2):  # both in flight at once, each with its own workspace
        s.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(s):
            on_streams.append(mo.moments_and_labels(f, d, prev, block_events=EB))
    torch.cuda.synchronize()
    for d_s, l_s in on_streams:
        if not (torch.equal(d_k.view(torch.int32), d_s.view(torch.int32))
                and torch.equal(l_k, l_s)):
            raise AssertionError("launches on two streams gave different results")
    if len({k for k in mo._workspaces if k[1] in (s1.cuda_stream, s2.cuda_stream)}) != 2:
        raise AssertionError("two streams did not get two workspaces")
    log("kernel: full width on two streams at once (two workspaces) bitwise equal to the "
        "default stream's")

    facts = moments_build_facts()
    log(f"kernel: ptxas {facts['ptxas']}; SASS "
        + ", ".join(f"{op} {n}" for op, n in facts["sass"].items()))
    timing = moments_timing(f, d, prev, EB, (d_k, l_k))
    timing.update(facts)

    # The trace path's shape: 100 ranks x 512 calls, F = 7 (main path A).
    rng_t = np.random.default_rng(SEED + 1)
    ft = torch.from_numpy(rng_t.integers(0, 7, 51_200).astype(np.int32)).to(dev)
    dt = torch.from_numpy(rng_t.lognormal(6, 0.5, 51_200).astype(np.float32)).to(dev)
    zt = torch.zeros((7, 5), device=dev)
    d_t, l_t = mo.moments_and_labels(ft, dt, zt)
    agree.check("kernel trace shape N=51200 F=7", d_t, l_t, *moments_and_labels_ref(ft, dt, zt))
    timing["trace_shape"] = moments_timing(ft, dt, zt, WIDTH_EB, (d_t, l_t))
    return timing


def moments_bound(N: int, F: int) -> dict:
    """The least time for one call: events read once (8 B), labels written
    once (1 B), the (F,5) table read and the delta written once, over the
    memory rate, against MOMENTS_OPS_PER_EVENT float32 operations per event."""
    nbytes = N * (4 + 4 + 1) + 2 * F * 5 * 4
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    ops_ms = N * MOMENTS_OPS_PER_EVENT / H100_F32_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations", "bytes": nbytes}


def graph_ms(fn, calls: int):
    """CUDA-event ms per call over ``calls`` calls of ``fn`` captured in one
    CUDA graph and replayed, so the host's enqueue is not in the time; and
    the output of the last call, as the replay left it."""
    import torch

    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        for _ in range(3):  # the stream's workspace is made before the capture
            fn()
    s.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        for _ in range(calls):
            out = fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls, out


def moments_floor(ctas: int):
    """Launchers of the empty kernel of the moments kernel's geometry
    (``ctas`` CTAs in clusters of 8, 256 threads): a bare ctypes call on the
    stream current now, and one that reads the current stream at each call
    (for a graph capture)."""
    import ctypes

    import torch

    from repro_torch.kernels import _build

    fn = _build.library("moments").moments_launch_floor_launch
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def bare():
        if fn(ctas, stream):
            raise RuntimeError("moments_launch_floor failed to launch")

    def current():
        if fn(ctas, torch.cuda.current_stream().cuda_stream):
            raise RuntimeError("moments_launch_floor failed to launch")

    return bare, current


def moments_timing(f, d, prev, eb: int, want) -> dict:
    """The moments kernel at one shape: CUDA-event ms per call over 200
    calls, the same over 200 calls in one CUDA graph (whose last output must
    equal ``want`` bitwise), the plain version's ms, host enqueue and the
    share of it in the input checks, device ms per launch (torch.profiler),
    the launch floor of its geometry (device, bare host launch, in a graph),
    and the bound."""
    import torch

    from repro_torch.kernels import moments as mo
    from repro_torch.kernels.ref import moments_and_labels_ref

    N, F = f.shape[0], prev.shape[0]
    ctas = mo.grid(N, eb)[2]
    launch = lambda: mo.moments_and_labels(f, d, prev, block_events=eb)  # noqa: E731
    in_graph, (d_g, l_g) = graph_ms(launch, calls=200)
    if not (torch.equal(d_g.view(torch.int32), want[0].view(torch.int32))
            and torch.equal(l_g, want[1])):
        raise AssertionError(f"moments N={N} F={F}: the kernel in a CUDA graph gave other "
                             f"results than launched alone")
    bare, current = moments_floor(ctas)
    t = {
        "N": N, "F": F, "block_events": eb, "ctas": ctas,
        "ms": cuda_ms(launch, iters=200),
        "graph_ms": in_graph,
        "plain_ms": cuda_ms(lambda: moments_and_labels_ref(f, d, prev), iters=20),
        "host_ms": host_ms(launch, iters=200),
        "host_check_ms": host_ms(lambda: mo._check(f, d, prev, eb), iters=200),  # part of host_ms
        "device_ms": device_ms_by_kernel(launch, iters=20),
        "floor": {"device_ms": device_ms_by_kernel(bare, iters=20),
                  "host_ms": host_ms(bare, iters=200),
                  "graph_ms": graph_ms(current, calls=200)[0]},
        **moments_bound(N, F),
    }
    us = lambda ms: f"{ms * 1e3:.2f}"  # noqa: E731
    by_kernel = lambda dev_ms: (", ".join(f"{k} {us(v)}" for k, v in dev_ms.items())  # noqa: E731
                                or "not measured (no device time recorded)")
    log(f"kernel: N={N} F={F} ({ctas} CTAs): {us(t['ms'])} us/call by CUDA events, "
        f"{us(t['graph_ms'])} us/call in a CUDA graph of 200 (output bitwise equal), plain "
        f"{us(t['plain_ms'])} us, bound {t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}: "
        f"{t['bytes']} B); host enqueue {us(t['host_ms'])} us/call, of which input checks "
        f"{us(t['host_check_ms'])} us; device (torch.profiler, us/launch): "
        f"{by_kernel(t['device_ms'])}; launch floor: device {by_kernel(t['floor']['device_ms'])}, "
        f"bare ctypes launch {us(t['floor']['host_ms'])} us host, "
        f"{us(t['floor']['graph_ms'])} us/launch in a CUDA graph; library: no single PyTorch "
        f"call computes this function")
    return t


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
class OutputAgreement:
    """Largest kernel-vs-plain errors over every comparison of one kernel's
    outputs; the relative error is taken where the plain output is at least
    0.01."""

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


def phase_flash(dev, agree: OutputAgreement) -> dict:
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref

    def compare(what, case, seed, kv_len=None):
        q, k, v = _flash_inputs(dev, case, seed)
        kw = dict(causal=case[6], window=case[7], cap=case[8], kv_len=kv_len)
        got, want = ops.flash_attention(q, k, v, **kw), flash_attention_ref(q, k, v, **kw)
        agree.check(what, got, want, FLASH_TOL[case[9]])
        return q, k, v, got, float((got.float() - want.float()).abs().max())

    for i, case in enumerate(FLASH_CASES):
        compare(f"flash case {i} {case}", case, case[5] + case[1] + case[3])
    for dtype in ("float32", "bfloat16"):
        compare(f"flash kv_len=77 {dtype}", (1, 64, 128, 2, 2, 64, False, 0, 0.0, dtype), 1,
                kv_len=77)
    compare("flash kv_len=0 bfloat16", (1, 64, 128, 2, 2, 64, False, 0, 0.0, "bfloat16"), 1,
            kv_len=0)  # no live key: every row gives 0
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
    log(f"flash: {len(FLASH_CASES)} test shapes, kv_len=77 (f32, bf16) and 0 (bf16), "
        f"{len(FLASH_RAGGED)} ragged shapes "
        f"and {FLASH_SWEEP} random shapes within 2e-5 (f32) / 2e-2 (bf16) of the plain version")

    f32_err = compare("flash full width float32", FLASH_FULL[:9] + ("float32",), SEED)[-1]
    q, k, v, out, _ = compare("flash full width", FLASH_FULL, SEED)
    again = fa.flash_attention(q, k, v, causal=True)
    if not torch.equal(out.view(torch.int16), again.view(torch.int16)):
        raise AssertionError("flash: two launches on the same input gave different results")
    log(f"flash: full width {FLASH_FULL} ok (and in float32 within 2e-5, max abs err "
        f"{f32_err:.3g}), two launches bitwise equal")
    del q, k, v, out, again
    for arch, case in FLASH_MODELS.items():
        err = compare(f"flash {arch} {case}", case, SEED)[-1]
        log(f"flash: {arch} attention at one wave {case} within 2e-2, max abs err {err:.3g}")
    log(f"flash: every comparison: max abs err {agree.max_abs:.3g}, max rel err "
        f"{agree.max_rel:.3g}")

    built = flash_build_facts()
    instances = {}
    for dtype in ("bfloat16", "float32"):
        timing = flash_timing(dev, FLASH_FULL[:9] + (dtype,))
        timing["sass"] = {hd: f["sass"] for hd, f in built[dtype].items()}
        timing["ptxas"] = {hd: f["ptxas"] for hd, f in built[dtype].items()}
        instances[dtype] = timing
        log(f"flash[{dtype}]: full width kernel {timing['ms'] * 1e3:.1f} us/call, "
            f"scaled_dot_product_attention {timing['library_ms'] * 1e3:.1f} us (in turns: "
            + ", ".join(f"{n} {t * 1e3:.1f}" for n, t in zip(
                ("kernel", "sdpa", "sdpa", "kernel"), timing["turns_ms"]))
            + f"; max abs diff to the kernel {timing['library_max_abs_diff']:.3g}), plain "
            f"{timing['plain_ms'] * 1e3:.1f} us, bound {timing['bound_ms'] * 1e3:.2f} us "
            f"({timing['bound_by']}: {timing['flops'] / 1e9:.2f} GFLOP, "
            f"{timing['bytes'] / 1e6:.1f} MB); host enqueue {timing['host_ms'] * 1e3:.1f} us "
            f"(its input checks {timing['host_check_ms'] * 1e3:.1f} us); "
            "device by kernel (torch.profiler, us/launch): "
            + (", ".join(f"{n} {m * 1e3:.1f}" for n, m in timing["device_ms"].items())
               or "not measured (no device time recorded)")
            + "; scaled_dot_product_attention's: "
            + (", ".join(f"{n} {m * 1e3:.1f}" for n, m in timing["library_device_ms"].items())
               or "not measured (no device time recorded)"))
        for hd in sorted(built[dtype]):
            log(f"flash[{dtype}] hd {hd}: ptxas {timing['ptxas'][hd]}; SASS "
                + ", ".join(f"{op} {n}" for op, n in timing["sass"][hd].items()))
    return {**instances["bfloat16"], "instances": instances}


_FLASH_INSTANCE = re.compile(r"flash_fwd_(wgmma_bf16|simt_f32)ILi(\d+)E")
_FLASH_DTYPE = {"wgmma_bf16": "bfloat16", "simt_f32": "float32"}
_SASS_OP = re.compile(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", re.M)


def sass_by_function(name: str) -> dict:
    """{function name: SASS opcode counts} of the built library of
    ``csrc/<name>.cu`` (``cuobjdump -sass``, beside nvcc)."""
    from repro_torch.kernels import _build

    cuobjdump = Path(_build.nvcc()).parent / "cuobjdump"
    sass = run_text([str(cuobjdump), "-sass", str(_build.target(name))])
    out = {}
    for chunk in re.split(r"\n\s*Function : ", sass)[1:]:
        function, _, body = chunk.partition("\n")
        out[function.strip()] = Counter(_SASS_OP.findall(body))
    return out


def ptxas_lines(name: str, function: str) -> str:
    """The ``-Xptxas -v`` lines (registers, spills) of the kernel whose
    mangled name holds ``function``, in the build log of ``csrc/<name>.cu``."""
    from repro_torch.kernels import _build

    lines, current = [], False
    for line in _build.build_log(name).splitlines():
        if "Compiling entry function" in line:
            current = function in line
        elif current and ("registers" in line or "spill" in line):
            lines.append(line.replace("ptxas info    :", "").strip())
    return "; ".join(lines)


def moments_build_facts() -> dict:
    """The moments kernel's ptxas line and SASS counts.  Raises if it spills
    or lacks the cluster barrier or distributed-shared-memory accesses."""
    ptxas = ptxas_lines("moments", "moments_cluster")
    spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ptxas)
    if spills is None or int(spills[1]) or int(spills[2]):
        raise AssertionError(f"moments: the kernel spills or has no ptxas line: {ptxas}")
    ops = next((c for f, c in sass_by_function("moments").items() if "moments_cluster" in f),
               None)
    if ops is None:
        raise AssertionError("moments: no moments_cluster in the library's SASS")
    sass = {**{op: ops[op] for op in MOMENTS_SASS}, "total": sum(ops.values())}
    missing = [what for what, names in MOMENTS_SASS_NEEDS.items()
               if not any(ops[op] for op in names)]
    if missing:
        raise AssertionError(f"moments: SASS lacks {missing}: {dict(ops)}")
    return {"ptxas": ptxas, "sass": sass}


def flash_build_facts() -> dict:
    """{dtype: {hd: {"ptxas": its -Xptxas -v line, "sass": instruction counts}}}
    of every instance in the built flash library.  Raises if an instance is
    missing, spills, or (bf16) lacks HGMMA (wgmma) or UTMALDG (TMA loads)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    facts, current = {}, None
    for line in _build.build_log("flash_attention").splitlines():
        m = _FLASH_INSTANCE.search(line)
        if "Compiling entry function" in line and m:
            current = facts.setdefault(_FLASH_DTYPE[m.group(1)], {}).setdefault(
                int(m.group(2)), {"ptxas": [], "sass": {}})
        elif current is not None and ("registers" in line or "spill" in line):
            current["ptxas"].append(line.replace("ptxas info    :", "").strip())
    for function, ops in sass_by_function("flash_attention").items():
        m = _FLASH_INSTANCE.search(function)
        if m:
            facts[_FLASH_DTYPE[m.group(1)]][int(m.group(2))]["sass"] = {
                **{op: ops[op] for op in FLASH_SASS}, "total": sum(ops.values())}
    for dtype in ("bfloat16", "float32"):
        for hd in fa.HEAD_DIMS:
            f = facts.get(dtype, {}).get(hd)
            if f is None or not f["sass"]:
                raise AssertionError(f"flash: no {dtype} hd {hd} instance in the ptxas log or SASS")
            f["ptxas"] = "; ".join(f["ptxas"])
            spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", f["ptxas"])
            if spills is None or int(spills[1]) or int(spills[2]):
                raise AssertionError(f"flash: {dtype} hd {hd} spills or has no ptxas line: "
                                     f"{f['ptxas']}")
            if dtype == "bfloat16" and not (f["sass"]["HGMMA"] and f["sass"]["UTMALDG"]):
                raise AssertionError(f"flash: bf16 hd {hd} SASS lacks HGMMA or UTMALDG: "
                                     f"{f['sass']}")
    return facts


def flash_timing(dev, case) -> dict:
    """One instance at ``case`` (causal, no window or cap): CUDA-event ms per
    call in turns with scaled_dot_product_attention (kernel, SDPA, SDPA,
    kernel), the plain version's ms, host enqueue ms, device ms per launch of
    the kernel and of SDPA's kernels (torch.profiler) and the bound.  Where
    the host enqueue exceeds the device time, the CUDA-event time is the
    host's, and the device times are the ones to compare."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels.ref import flash_attention_ref

    q, k, v = _flash_inputs(dev, case, SEED)
    launch = lambda: fa.flash_attention(q, k, v, causal=True)  # noqa: E731
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # (B, heads, S, hd)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=True, enable_gqa=True)
    lib_diff = float((library().transpose(1, 2).float() - launch().float()).abs().max())
    turns = [cuda_ms(fn, iters=20) for fn in (launch, library, library, launch)]
    return {
        "ms": (turns[0] + turns[3]) / 2,
        "library_ms": (turns[1] + turns[2]) / 2,
        "turns_ms": turns,
        "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, causal=True), iters=5),
        "host_ms": host_ms(launch, iters=20),
        "host_check_ms": host_ms(lambda: fa._check(q, k, v), iters=200),  # part of host_ms
        "device_ms": device_ms_by_kernel(launch, iters=5),
        "library_device_ms": device_ms_by_kernel(library, iters=5),
        "library_max_abs_diff": lib_diff,
        **flash_bound(case),
    }


# --------------------------------------------------------------------- scan
def _scan_inputs(dev, shape, seed):
    """a = exp(-U(0.05, 2)), b and C ~ N(0, 1), as tests/test_kernels.py draws them."""
    import torch

    B, S, di, st = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.empty((B, S, di, st), device=dev).uniform_(0.05, 2.0, generator=g).neg_().exp_()
    b = torch.randn((B, S, di, st), generator=g, device=dev)
    C = torch.randn((B, S, st), generator=g, device=dev)
    return a, b, C


def scan_bound(shape) -> dict:
    """The least time for one call at ``shape``: a and b read once, C read
    once, y and h_last written once over the memory rate, against
    SCAN_OPS_PER_STATE float32 operations per state element and step."""
    B, S, di, st = shape
    nbytes = 4 * (2 * B * S * di * st + B * S * st + B * S * di + B * di * st)
    flops = float(SCAN_OPS_PER_STATE * B * S * di * st)
    ops_ms, bytes_ms = flops / H100_F32_OPS_PER_S * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def phase_scan(dev, agree: OutputAgreement) -> dict:
    import torch

    from repro_torch.kernels import mamba_scan as ms
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mamba_scan_ref

    h_equal = []  # the kernel's state against the plain version's, bitwise

    def compare(what, shape, seed):
        a, b, C = _scan_inputs(dev, shape, seed)
        y, h = ops.mamba_scan(a, b, C)
        y_p, h_p = mamba_scan_ref(a, b, C)
        agree.check(f"{what} y", y, y_p, SCAN_TOL)
        agree.check(f"{what} h_last", h, h_p, SCAN_TOL)
        h_equal.append(torch.equal(h, h_p))
        return a, b, C, y, h

    for i, shape in enumerate(SCAN_CASES):
        compare(f"scan case {i} {shape}", shape, i)
    for shape in SCAN_RAGGED:
        compare(f"scan ragged {shape}", shape, sum(shape))
    rng = np.random.default_rng(SEED)
    for i in range(SCAN_SWEEP):
        shape = (int(rng.integers(1, 5)), int(rng.integers(1, 300)), int(rng.integers(1, 400)),
                 int(rng.integers(1, 33)))
        compare(f"scan sweep {i} {shape}", shape, 100 + i)
    log(f"scan: {len(SCAN_CASES)} test shapes, {len(SCAN_RAGGED)} ragged shapes and "
        f"{SCAN_SWEEP} random shapes within {SCAN_TOL} of the plain version")

    a, b, C, y, h = compare(f"scan full width {SCAN_FULL}", SCAN_FULL, SEED)
    y2, h2 = ms.mamba_scan(a, b, C)
    if not (torch.equal(y.view(torch.int32), y2.view(torch.int32))
            and torch.equal(h.view(torch.int32), h2.view(torch.int32))):
        raise AssertionError("scan: two launches on the same input gave different results")
    if not all(h_equal):  # both round a*h and +b apart: the states must agree exactly
        raise AssertionError(f"scan: h_last differs from the plain version's in "
                             f"{h_equal.count(False)} of {len(h_equal)} shapes")
    log(f"scan: full width {SCAN_FULL} ok, two launches bitwise equal; max abs err "
        f"{agree.max_abs:.3g}, max rel err {agree.max_rel:.3g}; h_last bitwise equal to the "
        f"plain version's in all {len(h_equal)} shapes")
    del y2, h2

    launch = lambda: ms.mamba_scan(a, b, C)  # noqa: E731
    timing = {
        "ms": cuda_ms(launch, iters=20),
        "plain_ms": cuda_ms(lambda: mamba_scan_ref(a, b, C), iters=2, warmup=1),
        "host_ms": host_ms(launch, iters=20),
        "device_ms": device_ms_by_kernel(launch, iters=5),
        **scan_bound(SCAN_FULL),
    }
    log(f"scan: full width kernel {timing['ms'] * 1e3:.1f} us/call, plain "
        f"{timing['plain_ms'] * 1e3:.1f} us, bound {timing['bound_ms'] * 1e3:.1f} us "
        f"({timing['bound_by']}: {timing['bytes'] / 1e9:.3f} GB, {timing['flops'] / 1e9:.2f} "
        f"GFLOP); host enqueue {timing['host_ms'] * 1e3:.1f} us; device by kernel "
        f"(torch.profiler, us/launch): "
        + (", ".join(f"{n} {m * 1e3:.1f}" for n, m in timing["device_ms"].items())
           or "not measured (no device time recorded)")
        + "; library: no single PyTorch call computes this function")
    return timing


# ------------------------------------------------ main paths C, D: serve
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


def phase_serve(dev, arch: str, kernel: str, bf16_smokes=()) -> dict:
    """Serve ``arch`` at its published width through ``kernel``, which must
    launch once per layer per prefill wave while no other kernel launches;
    then hold the float32 smoke model of ``arch``, and the bf16 smoke model
    of each of ``bf16_smokes``, on the card against the CPU."""
    import torch

    from repro_torch import configs
    from repro_torch.launch.serve import serve
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params

    gc.collect()  # an earlier serve path's tensors are gone: free their cache
    torch.cuda.empty_cache()
    tag = f"serve[{arch}]"
    cfg = configs.get_config(arch)
    params = init_params(cfg, SEED, dev)
    param_bytes = sum(t.numel() * t.element_size() for t in
                      [params["embed"], params["final_ln"]]
                      + [x for layer in params["layers"] for x in layer.values()])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    out = serve(arch=arch, smoke=False, seed=SEED, params=params, device=dev, **SERVE)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    waves = -(-SERVE["n_requests"] // SERVE["batch"])
    want = {name: (cfg.n_layers * waves if name == kernel else 0) for name in counts}
    mon = out["monitor"]
    if out["requests"] != SERVE["n_requests"] or \
            out["tokens"] != SERVE["n_requests"] * SERVE["max_new"]:
        raise AssertionError(f"{tag}: {out['requests']} requests, {out['tokens']} tokens")
    if mon["frames"] <= 0 or mon["events"] <= 0:
        raise AssertionError(f"{tag}: empty monitor summary {mon}")
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want} ({kernel} once per "
                             f"layer per wave: {cfg.n_layers} layers x {waves} waves)")
    log(f"{tag}: full width, {cfg.n_params():,} parameters ({param_bytes / 1e9:.2f} "
        f"GB float32 master); {out['requests']} requests, {out['tokens']} tokens in "
        f"{serve_s:.2f} s, {out['tok_per_s']:.1f} tok/s; peak memory {peak / 1e9:.2f} GB; "
        f"launches {counts}; monitor frames {mon['frames']} events "
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
        raise AssertionError(f"{tag}: non-finite prefill logits")
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
        raise AssertionError(f"{tag}: non-finite decode logits")
    _, cache = prefill()
    prof_prefill = device_breakdown(prefill)
    prof_decode = device_breakdown(lambda: M.decode_step(cfg, cparams, cache, nxt))
    log(f"{tag}: prefill {prefill_ms:.2f} ms per wave of {SERVE['batch']} x "
        f"{SERVE['prompt_len']} tokens, decode {decode_ms:.2f} ms per step of "
        f"{SERVE['batch']} tokens (CUDA events, steps after the serve run)")
    for name, prof in (("prefill", prof_prefill), ("decode step", prof_decode)):
        log(f"{tag}: {name} traced: {prof['host_ops']} top-level aten ops, wall "
            f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms, idle share "
            + (f"{prof['idle_share']:.3f}" if prof["idle_share"] is not None
               else "not measured")
            + "; top kernels (ms): "
            + ", ".join(f"{n} {m:.3f}" for n, m in prof["top"].items()))
    del cparams, cache, logits

    smoke = {f"{a}/{dtype}": smoke_card_vs_cpu(dev, a, dtype, tag)
             for a, dtype in [(arch, "float32")] + [(a, "bfloat16") for a in bf16_smokes]}
    return {"counts": counts, "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "tok_per_s": out["tok_per_s"], "peak_bytes": peak, "param_bytes": param_bytes,
            "prefill_idle_share": prof_prefill["idle_share"],
            "decode_idle_share": prof_decode["idle_share"], "smoke": smoke}


def smoke_card_vs_cpu(dev, arch: str, dtype: str, tag: str) -> dict:
    """The smoke model of ``arch`` in ``dtype``, prefill of 40 tokens and 4
    decode steps, on the card (kernels) and on the CPU (plain versions), from
    the same weights, the logits held together at SMOKE_TOL[dtype].

    In bf16 every attention call of the card run is held at FLASH_TOL
    against the plain version on its own inputs, and the card runs once more
    with attention through the plain version on the card, the baseline
    of what the card's other bf16 arithmetic does.  Where that baseline is
    itself beyond SMOKE_TOL of the CPU somewhere (a rounding flip amplified
    by the model), the kernel's run may not exceed the baseline's largest
    difference by more than the tolerance's 2e-2; elsewhere it is held
    elementwise."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params

    smoke = dataclasses.replace(configs.smoke(arch), compute_dtype=getattr(torch, dtype))
    p_cpu = M.compute_params(smoke, init_params(smoke, SEED, "cpu"))
    p_dev = {**{k: v.to(dev) for k, v in p_cpu.items() if k != "layers"},
             "layers": [{k: v.to(dev) for k, v in layer.items()} for layer in p_cpu["layers"]]}
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, smoke.vocab, (2, 44)).astype(np.int32))

    def logits_of(p, attention=None):
        wrapper = ops._fa.flash_attention
        if attention is not None:
            ops._fa.flash_attention = attention
        try:
            t = toks.to(p["embed"].device)
            logits, cache = M.prefill(smoke, p, {"tokens": t[:, :40]}, max_seq=44)
            outs = [logits[..., :smoke.vocab].float().cpu()]
            for i in range(40, 44):
                logits, cache = M.decode_step(smoke, p, cache, t[:, i:i + 1])
                outs.append(logits[..., :smoke.vocab].float().cpu())
        finally:
            ops._fa.flash_attention = wrapper
        return torch.cat(outs, dim=1)

    calls = OutputAgreement()  # every attention call of the bf16 card run
    kernel = ops._fa.flash_attention

    def recorded(q, k, v, **kw):
        got = kernel(q, k, v, **kw)
        calls.check(f"{tag}: {smoke.name} attention {tuple(q.shape)}", got,
                    flash_attention_ref(q, k, v, **kw), FLASH_TOL[dtype])
        return got

    cpu = logits_of(p_cpu)
    card = logits_of(p_dev, recorded if dtype == "bfloat16" else None)
    tol = SMOKE_TOL[dtype]
    err = float((card - cpu).abs().max())
    beyond = lambda run: int(((run - cpu).abs() > tol["atol"] + tol["rtol"] * cpu.abs()).sum())  # noqa: E731
    out = {"max_abs_diff": err, "beyond_tol": beyond(card)}
    if dtype == "float32":
        np.testing.assert_allclose(card.numpy(), cpu.numpy(), **tol,
                                   err_msg=f"{tag}: float32 smoke {smoke.name} logits, card vs CPU")
        log(f"{tag}: float32 smoke {smoke.name} prefill(40) + 4 decode steps, card (kernel) vs "
            f"CPU (plain): logits within rtol {tol['rtol']} / atol {tol['atol']}, max abs diff "
            f"{err:.3g}")
        return out

    base = logits_of(p_dev, flash_attention_ref)
    base_err = float((base - cpu).abs().max())
    out.update(base_max_abs_diff=base_err, base_beyond_tol=beyond(base),
               attention_max_abs_err=calls.max_abs)
    if out["base_beyond_tol"] == 0:
        np.testing.assert_allclose(card.numpy(), cpu.numpy(), **tol,
                                   err_msg=f"{tag}: bf16 smoke {smoke.name} logits, card vs CPU")
        held = f"elementwise within rtol {tol['rtol']} / atol {tol['atol']}"
    elif err > base_err + tol["atol"]:
        raise AssertionError(f"{tag}: bf16 smoke {smoke.name}: card (kernel) vs CPU max abs "
                             f"diff {err:.3g} exceeds the card's plain-attention baseline "
                             f"{base_err:.3g} by more than {tol['atol']}")
    else:
        held = (f"within the card's plain-attention baseline + {tol['atol']} (the baseline "
                f"itself is beyond the elementwise tolerance somewhere)")
    log(f"{tag}: bf16 smoke {smoke.name} prefill(40) + 4 decode steps, card (kernel) vs CPU "
        f"(plain): logits {held}: max abs diff {err:.3g}, {out['beyond_tol']} of {cpu.numel()} "
        f"beyond the elementwise tolerance; card with plain attention vs CPU {base_err:.3g}, "
        f"{out['base_beyond_tol']} beyond; every in-model attention call within "
        f"{FLASH_TOL[dtype]} of the plain version (max abs err {calls.max_abs:.3g}); "
        f"largest logit {float(cpu.abs().max()):.3g}")
    return out


# ---------------------------------------------------------------- refusals
def phase_refusals(dev) -> None:
    """The card's own limits stay refusals on the card and only there: an F
    beyond a block's shared memory (moments) and a bf16 view off a 16-byte
    boundary (flash's TMA) raise for CUDA tensors without a launch, and the
    same inputs on the CPU take the plain versions."""
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moments as mo
    from repro_torch.kernels.ref import flash_attention_ref, moments_and_labels_ref

    fids = torch.zeros(16, dtype=torch.int32)
    durs = torch.ones(16)
    table = torch.zeros((20000, 5))
    shifted = torch.zeros(1 * 64 * 2 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 64, 2, 64)
    kv = torch.zeros((1, 64, 1, 64), dtype=torch.bfloat16)
    before = read_counts()
    for what, call, match in (
            ("moments F 20000", lambda d: mo.moments_and_labels(
                fids.to(d), durs.to(d), table.to(d)), "exceeds a block's"),
            ("flash misaligned bf16", lambda d: fa.flash_attention(
                torch.zeros(shifted.numel() + 1, dtype=torch.bfloat16, device=d)[1:]
                .view(shifted.shape), kv.to(d), kv.to(d)), "16-byte boundary")):
        try:
            call(dev)
        except ValueError as e:
            if match not in str(e):
                raise
        else:
            raise AssertionError(f"refusals: {what} was not refused on the card")
    if read_counts() != before:
        raise AssertionError("refusals: a refused call launched a kernel")
    got_t, _ = mo.moments_and_labels(fids, durs, table)
    want_t, _ = moments_and_labels_ref(fids, durs, table, 6.0, 10.0, 0)
    if not torch.equal(got_t, want_t) or not torch.equal(
            fa.flash_attention(shifted, kv, kv), flash_attention_ref(shifted, kv, kv)):
        raise AssertionError("refusals: the CPU did not take the plain versions")
    log("refusals: on the card moments F 20000 and a misaligned bf16 flash view raise "
        "without a launch; on the CPU both take the plain versions")


# -------------------------------------------------------------------- train
def train_opts():
    from repro_torch.launch.steps import StepOptions
    from repro_torch.optim.adamw import OptConfig

    return StepOptions(**{**TRAIN_OPTS, "opt": OptConfig(**TRAIN_OPTS["opt"])})


def _timed_train_steps(TR, record):
    """Patch ``TR.build_train_step`` so that each step the driver takes is
    timed with CUDA events and its metrics kept (read after the run)."""
    import torch

    real = TR.build_train_step

    def build(*args, **kw):
        step = real(*args, **kw)

        def timed(state, batch):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, metrics = step(state, batch)
            end.record()
            record.append((start, end, metrics))
            return state, metrics

        return timed

    TR.build_train_step = build
    return real


def phase_train(dev) -> dict:
    """Main path E: repro_torch.launch.train.train on gemma-2b at its
    published width (TRAIN), monitored, through the normal entry point; then
    one traced step outside the driver (idle share, top kernels), one
    full-width 2-layer float32 step on the card against the CPU, and the
    exact-resume check on the smoke model."""
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import DataShard, SyntheticStream, to_device
    from repro_torch.export.chrome_trace import validate_trace
    from repro_torch.launch import steps as TS
    from repro_torch.launch import train as TR

    opts = train_opts()

    gc.collect()  # the serve paths' tensors are gone: free their cache
    torch.cuda.empty_cache()
    tag = f"train[{TRAIN['arch']}]"
    cfg = configs.get_config(TRAIN["arch"])
    steps, B, S = TRAIN["steps"], TRAIN["global_batch"], TRAIN["seq"]
    record = []
    real = _timed_train_steps(TR, record)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        zero_counts()
        try:
            out = TR.train(arch=TRAIN["arch"], smoke=False, steps=steps, global_batch=B, seq=S,
                           monitor_dir=tmp, export_trace=True, seed=0, opts=opts,
                           log_every=1, device=dev)
        finally:
            TR.build_train_step = real
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        written = sorted(os.listdir(tmp))
        with open(os.path.join(tmp, "trace.json")) as f:
            trace_counts = validate_trace(json.load(f))
    hist, mon = out["history"], out["monitor"]
    losses = [h["loss"] for h in hist]
    gnorms = [float(m["grad_norm"]) for _, _, m in record]
    event_ms = [a.elapsed_time(b) for a, b, _ in record]
    host_ms = [h["time_s"] * 1e3 for h in hist]
    if [h["step"] for h in hist] != list(range(steps)) or len(record) != steps:
        raise AssertionError(f"{tag}: steps {[h['step'] for h in hist]}, {len(record)} timed")
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"{tag}: non-finite loss or grad norm: {losses} {gnorms}")
    ln_v = math.log(cfg.vocab)
    if abs(losses[0] - ln_v) > TRAIN_LOSS0_ATOL:
        raise AssertionError(f"{tag}: step-0 loss {losses[0]:.4f} is not within "
                             f"{TRAIN_LOSS0_ATOL} of ln V = {ln_v:.4f}")
    if any(counts.values()):
        raise AssertionError(f"{tag}: port kernels launched on the train path: {counts}")
    want_files = ["history.json", "provenance.jsonl", "stream.jsonl", "trace.json", "viz.json"]
    if written != want_files:
        raise AssertionError(f"{tag}: monitor dir holds {written}, expected {want_files}")
    if mon["frames"] != steps or mon["events"] != 6 * steps:  # 3 spans per step
        raise AssertionError(f"{tag}: monitor saw {mon['frames']} frames, {mon['events']} "
                             f"events for {steps} steps")
    later_host = float(np.mean(host_ms[1:]))
    later_event = float(np.mean(event_ms[1:]))
    tok_per_s = B * S / (later_host / 1e3)
    log(f"{tag}: full width, {cfg.n_params():,} parameters; global batch {B} x seq {S}, "
        f"remat {opts.remat}, ce_chunk {opts.ce_chunk}, {steps} steps")
    for i in range(steps):
        log(f"{tag}: step {i} loss {losses[i]:.4f} grad_norm {gnorms[i]:.4f} host "
            f"{host_ms[i]:.1f} ms, CUDA events {event_ms[i]:.1f} ms")
    log(f"{tag}: steps 1-{steps - 1}: host {later_host:.1f} ms, CUDA events "
        f"{later_event:.1f} ms per step, {tok_per_s:.0f} tokens/s (host); step-0 loss "
        f"{losses[0]:.4f} vs ln V {ln_v:.4f}; peak memory {peak / 1e9:.2f} GB; "
        f"port kernel launches {counts} (expected 0: training runs the plain versions)")
    log(f"{tag}: monitor wrote {written}; frames {mon['frames']} events {mon['events']} "
        f"anomalies {mon['anomalies']} stragglers {mon['stragglers']}; trace.json "
        f"{trace_counts}")

    # One traced step outside the driver, same configuration, a fresh state.
    del out, record
    gc.collect()
    torch.cuda.empty_cache()
    step_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, None, B, opts), opts)
    state = TS.make_train_state(cfg, 0, device=dev)
    batch = to_device(SyntheticStream(cfg, DataShard(0, 1, B), S).batch_at(0), dev)
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], batch)

    one_step()
    prof = device_breakdown(one_step)
    del holder, state, batch, step_fn
    log(f"{tag}: one step traced: {prof['host_ops']} top-level aten ops, wall "
        f"{prof['wall_ms']:.1f} ms, device busy {prof['device_ms']:.1f} ms, idle share "
        + (f"{prof['idle_share']:.3f}" if prof["idle_share"] is not None else "not measured")
        + "; top kernels (ms): " + ", ".join(f"{n} {m:.3f}" for n, m in prof["top"].items()))
    gc.collect()
    torch.cuda.empty_cache()
    parity = train_card_vs_cpu(dev, tag)
    resume = train_resume_on_card(dev, tag)
    return {"counts": counts, "losses": losses, "grad_norms": gnorms, "host_ms": host_ms,
            "event_ms": event_ms, "step_ms": later_event, "step_host_ms": later_host,
            "tok_per_s": tok_per_s, "peak_bytes": peak, "idle_share": prof["idle_share"],
            "device_ms": prof["device_ms"], "wall_ms": prof["wall_ms"],
            "card_vs_cpu": parity, "resume": resume}


def train_card_vs_cpu(dev, tag: str) -> dict:
    """One build_train_step step of gemma-2b at its published width cut to
    TRAIN_PARITY's layers, in float32, from one seed's params on the CPU
    copied to the card: loss, grad norm and params after the step, card vs
    CPU, at TRAIN_PARITY's tolerances."""
    import torch

    from repro_torch import configs
    from repro_torch import tree as T
    from repro_torch.launch import steps as TS

    cfg = dataclasses.replace(configs.get_config(TRAIN["arch"]),
                              n_layers=TRAIN_PARITY["n_layers"], compute_dtype=torch.float32)
    Bp, Sp = TRAIN_PARITY["batch"], TRAIN_PARITY["seq"]
    opts = train_opts()
    step_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, None, Bp, opts), opts)
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab, (Bp, Sp + 1))
    batch = {"tokens": torch.from_numpy(tokens[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(tokens[:, 1:].astype(np.int32))}
    cpu_state = TS.make_train_state(cfg, SEED, device="cpu")
    before = {name: t.clone() for name, t in T.paths(cpu_state["params"])}
    dev_state = T.map(lambda t: t.to(dev, copy=True), cpu_state)
    t0 = time.perf_counter()
    dev_state, dev_m = step_fn(dev_state, {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu_state, cpu_m = step_fn(cpu_state, batch)
    cpu_s = time.perf_counter() - t0
    tol = TRAIN_PARITY
    for name in ("loss", "grad_norm"):
        got, want = float(dev_m[name]), float(cpu_m[name])
        if not abs(got - want) <= tol[f"{name}_rtol"] * abs(want):
            raise AssertionError(f"{tag}: card vs CPU {name} {got} vs {want} beyond rtol "
                                 f"{tol[f'{name}_rtol']}")
    lr = float(cpu_m["lr"])
    worst, n_off, n_all = 0.0, 0, 0
    for (name, want), got in zip(T.paths(cpu_state["params"]), T.leaves(dev_state["params"])):
        got = got.cpu()
        err = (got - want).abs()
        off = err > tol["params_atol"] + tol["params_rtol"] * want.abs()
        n_off += int(off.sum())
        n_all += want.numel()
        worst = max(worst, float(err.max()))
        moved = (want - before[name]).abs().max()
        if float(err.max()) > 2 * lr * (1 + float(before[name].abs().max())) or \
                not bool(torch.isfinite(got).all()) or float(moved) == 0.0:
            raise AssertionError(f"{tag}: card vs CPU {name}: max abs diff "
                                 f"{float(err.max())} (lr {lr}), moved {float(moved)}")
    if n_off > tol["params_off_share"] * n_all:
        raise AssertionError(f"{tag}: card vs CPU params: {n_off} of {n_all} beyond rtol "
                             f"{tol['params_rtol']} / atol {tol['params_atol']}")
    log(f"{tag}: card vs CPU, one float32 step at full width cut to {cfg.n_layers} layers "
        f"({cfg.n_params():,} parameters), batch {Bp} x {Sp}: loss {float(dev_m['loss']):.6f} "
        f"vs {float(cpu_m['loss']):.6f}, grad norm {float(dev_m['grad_norm']):.6f} vs "
        f"{float(cpu_m['grad_norm']):.6f}; params after the step: {n_off} of {n_all} beyond "
        f"rtol {tol['params_rtol']} / atol {tol['params_atol']} (at most a share of "
        f"{tol['params_off_share']}), max abs diff {worst:.3g} (lr {lr:.3g}); card "
        f"{card_s:.2f} s, CPU {cpu_s:.2f} s")
    return {"loss": float(dev_m["loss"]), "cpu_loss": float(cpu_m["loss"]),
            "params_beyond_tol": n_off, "params": n_all, "max_abs_diff": worst}


def train_resume_on_card(dev, tag: str) -> dict:
    """tests/test_training.py:63 on the card: crash at step 12, resume from
    the step-10 checkpoint, the final loss of an uninterrupted run at rtol
    1e-5."""
    from repro_torch.launch.train import train

    kw = dict(arch=TRAIN["arch"], steps=20, global_batch=4, seq=32, ckpt_interval=5,
              log_every=100, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        full = train(ckpt_dir=os.path.join(tmp, "a"), **kw)
        try:
            train(ckpt_dir=os.path.join(tmp, "b"), fail_at=12, **kw)
        except RuntimeError as e:
            if "injected node failure" not in str(e):
                raise
        else:
            raise AssertionError(f"{tag}: fail_at=12 did not fail")
        resumed = train(ckpt_dir=os.path.join(tmp, "b"), **kw)
    if resumed["history"][0]["step"] != 10:
        raise AssertionError(f"{tag}: resumed at step {resumed['history'][0]['step']}, not 10")
    a, b = full["final_loss"], resumed["final_loss"]
    if not abs(a - b) <= 1e-5 * abs(a):
        raise AssertionError(f"{tag}: exact resume on the card: final loss {b} after the "
                             f"restart vs {a} uninterrupted, beyond rtol 1e-5")
    log(f"{tag}: exact resume on the card (smoke, 20 steps, failure at 12, resumed from "
        f"step 10): final loss {b:.8f} vs {a:.8f} uninterrupted (rtol 1e-5)")
    return {"final_loss": a, "resumed_final_loss": b}


# ------------------------------------------------------------ train, socket
@contextlib.contextmanager
def archived_monitor(store, seen: dict):
    """For one run: every frame a ChimbukoMonitor ingests is also written to
    ``store`` (a FrameStore; None writes nothing); ``seen`` receives the
    monitor, the host seconds of each ingest (the monitor's cost to the
    training loop, outside the driver's step time), and at close the PS
    snapshot and function registry (read before the shards go away)."""
    from repro_torch.trace.monitor import ChimbukoMonitor

    real_ingest, real_close = ChimbukoMonitor.ingest, ChimbukoMonitor.close
    seen["ingest_s"] = []

    def ingest(self, frame, *args, **kw):
        seen["monitor"] = self
        if store is not None:
            store.write(frame)
        t0 = time.perf_counter()
        try:
            return real_ingest(self, frame, *args, **kw)
        finally:
            seen["ingest_s"].append(time.perf_counter() - t0)

    def close(self):
        if self is seen.get("monitor") and "snapshot" not in seen:
            seen["snapshot"] = self.ps.snapshot().table.copy()
            seen["registry"] = self.registry
        return real_close(self)

    ChimbukoMonitor.ingest, ChimbukoMonitor.close = ingest, close
    try:
        yield seen
    finally:
        ChimbukoMonitor.ingest, ChimbukoMonitor.close = real_ingest, real_close


@contextlib.contextmanager
def timed_spawn(out: list):
    """Time each ``resolve_endpoints`` call the driver makes (the worker pool's
    spawn, handshakes included)."""
    from repro_torch.launch import shard_server

    real = shard_server.resolve_endpoints

    def timed(*args, **kw):
        t0 = time.perf_counter()
        try:
            return real(*args, **kw)
        finally:
            out.append(time.perf_counter() - t0)

    shard_server.resolve_endpoints = timed
    try:
        yield out
    finally:
        shard_server.resolve_endpoints = real


def _step_means(hist, record, skip):
    """Mean host and CUDA-event ms over the steps not in ``skip``."""
    keep = [i for i in range(len(hist)) if i not in skip]
    host = float(np.mean([hist[i]["time_s"] * 1e3 for i in keep]))
    event = float(np.mean([record[i][0].elapsed_time(record[i][1]) for i in keep]))
    return host, event


def replay_through_pool(store, registry, out_dir: str, kills=()) -> dict:
    """Replay an archive through two supervised shard worker processes with a
    PS write-ahead log (tests/test_fault.py:_chaos_run's configuration);
    ``kills`` are (frame ordinal, worker) SIGKILLs after that frame's ingest.
    Returns the PS snapshot, the summary, the provenance files' bytes, the
    pool's restarts and, per kill, the respawn seconds and the frames
    ingested while that worker was down."""
    import threading

    from repro_torch.core import offline
    from repro_torch.core.provenance import shard_paths
    from repro_torch.fault.chaos import kill_process
    from repro_torch.fault.policy import RetryPolicy
    from repro_torch.launch.shard_server import ShardServerPool
    from repro_torch.trace.monitor import ChimbukoMonitor

    kill_at = dict(kills)
    events = []  # per kill: {"t_kill", "t_up", "frames_down"}
    state = {"n": 0}
    real_ingest = ChimbukoMonitor.ingest
    with ShardServerPool(TRAIN_SOCKET["shards"], kind="both", supervise=True,
                         supervise_poll=0.05) as pool:

        def watch(ev, target):
            while pool.restarts < target:
                time.sleep(0.002)
            ev["t_up"] = time.perf_counter()

        def ingest(self, frame, *args, **kw):
            for ev in events:
                if "t_up" not in ev:
                    ev["frames_down"] += 1
            out = real_ingest(self, frame, *args, **kw)
            state["n"] += 1
            if state["n"] in kill_at:
                # each kill takes a live worker: the previous one is back first
                deadline = time.perf_counter() + 60
                while any("t_up" not in ev for ev in events):
                    if time.perf_counter() > deadline:
                        raise AssertionError("train_socket: a killed worker was never "
                                             f"respawned (restarts {pool.restarts})")
                    time.sleep(0.002)
                ev = {"t_kill": time.perf_counter(), "frames_down": 0,
                      "worker": kill_at[state["n"]], "after_frame": state["n"]}
                kill_process(pool.procs[kill_at[state["n"]]])
                events.append(ev)
                threading.Thread(target=watch, args=(ev, len(events)), daemon=True).start()
            return out

        ChimbukoMonitor.ingest = ingest
        t0 = time.perf_counter()
        try:
            mon = offline.replay(
                store, registry=registry, num_funcs=TRAIN_MONITOR["num_funcs"],
                prov_path=os.path.join(out_dir, "prov.jsonl"),
                ps_transport="socket", provdb_transport="socket",
                shard_endpoints=pool.endpoints, ps_wal_dir=os.path.join(out_dir, "wal"),
                fault_policy=RetryPolicy(retries=8, base_delay=0.05),
                run_info={"timestamp": 0.0}, **TRAIN_MONITOR["kw"])
        finally:
            ChimbukoMonitor.ingest = real_ingest
        seconds = time.perf_counter() - t0
        snap = mon.ps.snapshot().table.copy()
        summary = mon.summary()
        mon.close()
        deadline = time.perf_counter() + 60
        while any("t_up" not in ev for ev in events):
            if time.perf_counter() > deadline:
                raise AssertionError(f"train_socket: a killed worker was never respawned "
                                     f"(restarts {pool.restarts}, kills {len(events)})")
            time.sleep(0.01)
        restarts = pool.restarts
    files = {}
    for path in shard_paths(os.path.join(out_dir, "prov.jsonl"), TRAIN_SOCKET["shards"]):
        with open(path, "rb") as f:
            files[os.path.basename(path)] = f.read()
    return {"snapshot": snap, "summary": summary, "files": files, "restarts": restarts,
            "seconds": seconds, "kills": [
                {"after_frame": ev["after_frame"], "worker": ev["worker"],
                 "respawn_s": ev["t_up"] - ev["t_kill"], "frames_down": ev["frames_down"]}
                for ev in events]}


def phase_train_socket(dev, path_e: dict) -> dict:
    """Main path F: path E's training run with the monitor's PS and
    provenance DB in two supervised shard worker processes (socket
    transports, a PS write-ahead log), against a local-transport run of the
    same configuration (F-a); the frames the socket run's monitor ingested
    are archived and replayed offline with local transports (F-b) and, twice,
    through a supervised worker pool, once with two seed-chosen SIGKILLs
    (F-c)."""
    import torch

    from repro_torch.core import offline
    from repro_torch.core.provenance import static_provenance
    from repro_torch.fault.chaos import ChaosStream
    from repro_torch.launch import train as TR
    from repro_torch.trace.stream import FrameStore

    opts = train_opts()
    tag = f"train_socket[{TRAIN['arch']}]"
    steps, B, S = TRAIN_SOCKET["steps"], TRAIN["global_batch"], TRAIN["seq"]
    straggler = TRAIN_SOCKET["inject_straggler_at"]
    common = dict(arch=TRAIN["arch"], smoke=False, steps=steps, global_batch=B, seq=S,
                  seed=0, opts=opts, log_every=steps, export_trace=True,
                  inject_straggler_at=straggler, provdb_shards=TRAIN_SOCKET["shards"],
                  device=dev)
    gc.collect()  # path E's tensors are gone: free their cache before path F
    torch.cuda.empty_cache()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        # The local-transport run first: it is F-a's reference, and it warms
        # the allocator and cuBLAS, so the socket run's first step is not an
        # outlier in the statistics its straggler is judged against.
        for name, kw in (("local", {}), ("socket", dict(
                ps_transport="socket", provdb_transport="socket",
                shard_endpoints=f"spawn:{TRAIN_SOCKET['shards']}", supervise=True,
                ps_wal=os.path.join(tmp, "wal")))):
            record, spawn_s, seen = [], [], {}
            store = FrameStore(os.path.join(tmp, f"frames_{name}"))
            real = _timed_train_steps(TR, record)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            mon_dir = os.path.join(tmp, f"mon_{name}")
            zero_counts()
            try:
                with archived_monitor(store if kw else None, seen), timed_spawn(spawn_s):
                    out = TR.train(monitor_dir=mon_dir, **common, **kw)
            finally:
                TR.build_train_step = real
            torch.cuda.synchronize()
            counts = read_counts()
            runs[name] = dict(out=out, record=record, counts=counts, spawn_s=spawn_s,
                              seen=seen, store=store, dir=mon_dir,
                              files=sorted(os.listdir(mon_dir)),
                              peak=torch.cuda.max_memory_allocated(dev))
            del out
            gc.collect()
        loc, sock = runs["local"], runs["socket"]
        hist, mon = sock["out"]["history"], sock["out"]["monitor"]

        # (F-a) the transports do not move the workload
        losses = [h["loss"] for h in hist]
        ref = [h["loss"] for h in loc["out"]["history"]]
        if len(losses) != steps or len(sock["record"]) != steps:
            raise AssertionError(f"{tag}: {len(losses)} steps, {len(sock['record'])} timed")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{tag}: non-finite loss: {losses}")
        off = [i for i, (a, b) in enumerate(zip(losses, ref))
               if not abs(a - b) <= TRAIN_SOCKET["loss_rtol"] * abs(b)]
        if off:
            raise AssertionError(f"{tag}: losses at steps {off} differ from the local run "
                                 f"beyond rtol {TRAIN_SOCKET['loss_rtol']}: {losses} vs {ref}")
        if (mon["ps_transport"], mon["provdb_transport"]) != ("socket", "socket"):
            raise AssertionError(f"{tag}: summary shows ps_transport {mon['ps_transport']}, "
                                 f"provdb_transport {mon['provdb_transport']}")
        if mon["anomalies"] < 1 or mon["frames"] != steps:
            raise AssertionError(f"{tag}: {mon['frames']} frames, {mon['anomalies']} "
                                 f"anomalies (expected {steps} frames and at least one "
                                 f"anomaly: the straggler at step {straggler})")
        if any(sock["counts"].values()) or any(loc["counts"].values()):
            raise AssertionError(f"{tag}: port kernels launched: {sock['counts']}, "
                                 f"{loc['counts']}")
        wal = sorted(os.listdir(os.path.join(tmp, "wal")))
        if wal != [f"ps_shard{s}.wal" for s in range(TRAIN_SOCKET["shards"])]:
            raise AssertionError(f"{tag}: the PS write-ahead log holds {wal}")
        skip = {0, straggler}
        host_s, event_s = _step_means(hist, sock["record"], skip)
        host_l, event_l = _step_means(loc["out"]["history"], loc["record"], skip)
        for i in range(steps):
            log(f"{tag}: step {i} loss {losses[i]:.4f} (local {ref[i]:.4f}) host "
                f"{hist[i]['time_s'] * 1e3:.1f} ms, CUDA events "
                f"{sock['record'][i][0].elapsed_time(sock['record'][i][1]):.1f} ms")
        log(f"{tag}: {steps} steps, straggler injected at step {straggler}; steps other "
            f"than 0 and {straggler}: socket host {host_s:.1f} ms, CUDA events {event_s:.1f} "
            f"ms per step, {B * S / (host_s / 1e3):.0f} tokens/s; local host {host_l:.1f} ms, "
            f"CUDA events {event_l:.1f} ms, {B * S / (host_l / 1e3):.0f} tokens/s; path E "
            f"(steps 1-{TRAIN['steps'] - 1}) host {path_e['step_host_ms']:.1f} ms, CUDA "
            f"events {path_e['step_ms']:.1f} ms, {path_e['tok_per_s']:.0f} tokens/s; peak "
            f"memory socket {sock['peak'] / 1e9:.2f} GB, local {loc['peak'] / 1e9:.2f} GB, "
            f"path E {path_e['peak_bytes'] / 1e9:.2f} GB")
        ingest_ms = {n: 1e3 * float(np.mean(r["seen"]["ingest_s"][1:])) for n, r in runs.items()}
        log(f"{tag}: monitor ingest per frame (host, outside the driver's step time; frames "
            f"1-{steps - 1}): socket {ingest_ms['socket']:.2f} ms, local "
            f"{ingest_ms['local']:.2f} ms; step and ingest together: socket "
            f"{B * S / ((host_s + ingest_ms['socket']) / 1e3):.0f} tokens/s, local "
            f"{B * S / ((host_l + ingest_ms['local']) / 1e3):.0f} tokens/s")
        log(f"{tag}: losses equal the local run's within rtol {TRAIN_SOCKET['loss_rtol']}; "
            f"{TRAIN_SOCKET['shards']} supervised workers spawned in {sock['spawn_s'][0]:.3f} s; "
            f"summary ps_transport {mon['ps_transport']} provdb_transport "
            f"{mon['provdb_transport']}, frames {mon['frames']} events {mon['events']} "
            f"anomalies {mon['anomalies']} provenance_records {mon['provenance_records']} "
            f"stragglers {mon['stragglers']} ps_shard_pushes {mon['ps_shard_pushes']} health "
            f"{mon['health']}; local run anomalies {loc['out']['monitor']['anomalies']}; "
            f"monitor dir {sock['files']}; WAL {wal}; port kernel launches "
            f"{sock['counts']} (expected 0)")

        # (F-b) offline equals online
        store, seen = sock["store"], sock["seen"]
        registry = seen["registry"]
        n_frames = sum(len(store.steps(r)) for r in store.ranks())
        if n_frames != steps:
            raise AssertionError(f"{tag}: archived {n_frames} frames of {steps}")
        t0 = time.perf_counter()
        off_mon = offline.replay(store, registry=registry, num_funcs=TRAIN_MONITOR["num_funcs"],
                                 ps_shards=TRAIN_SOCKET["shards"],
                                 provdb_shards=TRAIN_SOCKET["shards"], **TRAIN_MONITOR["kw"])
        replay_s = time.perf_counter() - t0
        off_sum = off_mon.summary()
        off_snap = off_mon.ps.snapshot().table
        off_mon.close()
        live = seen["snapshot"]
        if (off_sum["events"], off_sum["anomalies"]) != (mon["events"], mon["anomalies"]):
            raise AssertionError(f"{tag}: offline replay gives events {off_sum['events']} "
                                 f"anomalies {off_sum['anomalies']}, live {mon['events']} "
                                 f"{mon['anomalies']}")
        if off_snap.shape != live.shape or not np.allclose(off_snap[:, :3], live[:, :3],
                                                           rtol=1e-9, atol=0.0):
            raise AssertionError(f"{tag}: offline PS snapshot differs from the live one "
                                 f"beyond rtol 1e-9")
        log(f"{tag}: (F-b) offline replay of the {n_frames} archived frames, local "
            f"transports: events {off_sum['events']} anomalies {off_sum['anomalies']} as "
            f"live; PS snapshot columns n, mean, M2 within rtol 1e-9 of the live one; "
            f"{replay_s:.3f} s ({n_frames / replay_s:.1f} frames/s)")

        # (F-c) kills are invisible in the results
        static_provenance()  # settle lazy env effects before both headers
        cs = ChaosStream(TRAIN_SOCKET["chaos_seed"])
        half = n_frames // 2
        kills = [(1 + cs.below(half - 1), cs.below(TRAIN_SOCKET["shards"])),
                 (half + cs.below(half - 1), cs.below(TRAIN_SOCKET["shards"]))]
        ref_dir, kill_dir = os.path.join(tmp, "ref"), os.path.join(tmp, "kill")
        os.makedirs(ref_dir)
        os.makedirs(kill_dir)
        clean = replay_through_pool(store, registry, ref_dir)
        faulted = replay_through_pool(store, registry, kill_dir, kills)
    if faulted["restarts"] < 1:
        raise AssertionError(f"{tag}: the supervisor never respawned a killed worker")
    if faulted["snapshot"].tobytes() != clean["snapshot"].tobytes():
        raise AssertionError(f"{tag}: the PS snapshot after the kills differs from the "
                             f"no-fault replay's")
    if set(faulted["files"]) != set(clean["files"]) or not clean["files"] or any(
            faulted["files"][n] != clean["files"][n] for n in clean["files"]):
        raise AssertionError(f"{tag}: provenance files differ after the kills: "
                             f"{sorted(clean['files'])} vs {sorted(faulted['files'])}")
    if not faulted["summary"]["anomalies"] == clean["summary"]["anomalies"] > 0:
        raise AssertionError(f"{tag}: anomalies {faulted['summary']['anomalies']} after the "
                             f"kills, {clean['summary']['anomalies']} without")
    for k in faulted["kills"]:
        log(f"{tag}: (F-c) SIGKILL of worker {k['worker']} after frame {k['after_frame']}: "
            f"respawned in {k['respawn_s']:.3f} s, {k['frames_down']} frames ingested "
            f"while it was down")
    log(f"{tag}: (F-c) replay through 2 supervised workers with a WAL: no fault "
        f"{clean['seconds']:.3f} s, two kills {faulted['seconds']:.3f} s "
        f"({n_frames / faulted['seconds']:.1f} frames/s), restarts {faulted['restarts']}; PS "
        f"snapshot bytes and {sorted(clean['files'])} byte-identical; anomalies "
        f"{clean['summary']['anomalies']} in both")
    return {"counts": sock["counts"], "losses": losses, "local_losses": ref,
            "step_ms": event_s, "step_host_ms": host_s, "tok_per_s": B * S / (host_s / 1e3),
            "local_step_ms": event_l, "local_step_host_ms": host_l,
            "peak_bytes": sock["peak"], "spawn_s": sock["spawn_s"][0], "ingest_ms": ingest_ms,
            "anomalies": mon["anomalies"], "replay_s": replay_s,
            "chaos": {"clean_s": clean["seconds"], "faulted_s": faulted["seconds"],
                      "restarts": faulted["restarts"], "kills": faulted["kills"]}}


# --------------------------------------------------------------------- main
def main() -> int:
    import torch

    t_start = time.perf_counter()
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
    flash_agree = OutputAgreement()
    flash = phase_flash(dev, flash_agree)
    scan_agree = OutputAgreement()
    scan = phase_scan(dev, scan_agree)
    phase_refusals(dev)

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0,
                                world_size=1)
        try:
            trace = phase_trace(dev, dist.group.WORLD)
        finally:
            dist.destroy_process_group()
    width = phase_width(dev, agree)
    served = phase_serve(dev, "gemma-2b", "flash_attention",
                         bf16_smokes=("gemma-2b", "gemma2-2b"))
    served_ssm = phase_serve(dev, "falcon-mamba-7b", "mamba_scan")
    trained = phase_train(dev)
    trained_socket = phase_train_socket(dev, trained)

    paths = {"trace": trace["counts"], "width": width["counts"], "serve": served["counts"],
             "serve_ssm": served_ssm["counts"], "train": trained["counts"],
             "train_socket": trained_socket["counts"]}
    needs = {"trace": "moments_and_labels", "width": "moments_and_labels",
             "serve": "flash_attention", "serve_ssm": "mamba_scan"}
    for path, name in needs.items():
        if paths[path][name] <= 0:
            raise AssertionError(f"main path {path} never launched {name}: {paths[path]}")

    def by_path(name):
        return {path: c[name] for path, c in paths.items()}

    def serve_numbers(run):
        return {k: run[k] for k in ("prefill_ms", "decode_ms", "tok_per_s", "peak_bytes",
                                    "param_bytes", "prefill_idle_share", "decode_idle_share")}

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
        "graph_ms": timing["graph_ms"],
        "host_check_ms": timing["host_check_ms"],
        "floor": timing["floor"],
        "ctas": timing["ctas"],
        "ptxas": timing["ptxas"],
        "sass": timing["sass"],
        "two_streams_bitwise_equal": True,  # phase_kernel raised otherwise
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
        "instances": {dtype: {key: inst[key] for key in (
            "ms", "turns_ms", "device_ms", "host_ms", "host_check_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_device_ms", "sass", "ptxas")}
            for dtype, inst in flash["instances"].items()},
        "serve": serve_numbers(served),
        "smoke": served["smoke"],
    }, {
        "name": "mamba_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:28",
        "launches": sum(by_path("mamba_scan").values()),
        "launches_by_path": by_path("mamba_scan"),
        "max_abs_err": scan_agree.max_abs,
        "max_rel_err": scan_agree.max_rel,
        "ms": scan["ms"],
        "plain_ms": scan["plain_ms"],
        "bound_ms": scan["bound_ms"],
        "bound_by": scan["bound_by"],
        "library_ms": None,
        "shape": dict(zip(("B", "S", "d_inner", "d_state"), SCAN_FULL)),
        "host_ms": scan["host_ms"],
        "device_ms": scan["device_ms"],
        "h_last_bitwise_equal": True,  # phase_scan raised otherwise
        "serve_ssm": serve_numbers(served_ssm),
    }]
    log(f"trace precision {trace['precision']:.4f} recall {trace['recall']:.4f}; "
        f"build {env['build_s']:.2f} s; wall {time.perf_counter() - t_start:.1f} s")
    log(env["smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
