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
           the attention shapes of gemma2-2b, h2o-danube3-4b,
           granite-moe-1b-a400m (hd 64, GQA 16:8), minicpm3-4b (MLA: qk 96,
           v 64, H = KV = 40, through ops.flash_attention's padding to hd 128)
           and qwen2-vl-2b (hd 128, GQA 12:2) at one wave, the last three
           also timed beside scaled_dot_product_attention, with their
           bounds on the unpadded work;
           both dtypes go through tensor-core instances (wgmma, TMA): bf16
           directly, float32 as split TF32 after its prologue kernel.  Each
           instance's SASS instruction counts (HGMMA and UTMALDG required)
           and ptxas line (no spills; the prologue's too; no other kernel in
           the library), determinism checks (float32 at the gemma-2b,
           granite-moe and qwen2-vl-2b waves, bf16 at full width), and
           timings of both dtypes at full width, and of float32 at hd 64
           and 128 too, in turns with one scaled_dot_product_attention call
           (a yardstick only; float32 with TF32 off), with the float32
           split-TF32 bound beside the CUDA-core one;
  scan     the selective-scan kernel against its plain PyTorch version on
           the card: the repo's 4 test shapes, ragged shapes (S 1 and 77, d_inner
           no multiple of a CTA's channels, d_state 1, 3, 4, 8 and 32), 40
           random shapes and the full-width falcon-mamba-7b prefill shape
           (B 4, S 1024, d_inner 8192, d_state 16), with a determinism check
           and timings;
  stage    the staging kernel (a = exp(dt*A), b = (dt*x)*B) bitwise against
           the plain staging (kernels.ref.mamba_stage_ref) on the card at
           falcon-mamba-7b's and jamba's layer shapes cut to B 2, path D's
           wave (B 4, S 1024), jamba's serving wave (B 4, S 4096) and
           falcon-mamba-7b's (B 32, S 1024), ragged d_inner, S 1, d_state
           1, 5, 8 and 32, bf16 and float32; timed at falcon-mamba-7b's
           serving wave against its byte bound and against the plain
           staging;
  serve    main path C: repro_torch.launch.serve at gemma-2b's published
           width (8 requests of 1024 prompt tokens, 32 new tokens each, in
           waves of 4) with the port's ChimbukoMonitor; then the float32
           gemma-2b smoke model through prefill and decode on the card (the
           kernel) and on the CPU (the plain version), logits held together,
           and the same in bf16 for the gemma-2b and gemma2-2b smoke models;
  prefill_f32  main path O: gemma-2b at its published width with
           compute_dtype float32 (TF32 off), 2 prefill waves of 4 x 1024
           tokens through the float32 flash instance (36 launches), logits
           held against the same prefill with the plain attention on the card
           at float32's smoke tolerance, ms per wave;
  serve_ssm  main path D: the same traffic and checks on falcon-mamba-7b at
           its published width (64 Mamba layers, no attention), whose every
           prefill layer runs the staging and the scan kernels;
  serve_moe  main path G: the same traffic on granite-moe-1b-a400m at its
           published width (24 layers, 32 experts, top-8; flash at hd 64)
           under a monitor with the live viz gateway (viz_serve=0), a
           WebSocket viewer and an HTTP poller attached while it runs; then
           the viewer's frame count = the gateway's broadcasts = the frames
           ingested, every view equal to VizServer's, /trace its bytes, 304
           on a repeat GET, the port closed after monitor.close(), the cost
           of one broadcast, the smoke models card vs CPU (float32, bf16),
           moe_block bitwise repeatable at the prefill wave's shape, and the
           prefill's device time by kernel class (MoE dispatch vs GEMMs);
  serve (minicpm3-4b)  main path H: path C's traffic on minicpm3-4b at its
           published width (62 MLA layers: prefill attention through the
           flash kernel with v padded like q/k, decode on the latent cache);
           the smoke models card vs CPU with v head dim 16 below qk 24;
  serve_vl main path I: the serve of examples/serve_monitored_torch.py on
           qwen2-vl-2b at its published width (M-RoPE, the vision stub) with
           path C's traffic and the example's monitor settings, after the
           example itself on the card; one full-width prefill wave whose
           batch carries visual_embeds and pos3; the smoke models card vs CPU
           with visual_embeds and pos3;
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
  train_audio  main path J: repro_torch.launch.train.train on hubert-xlarge
           at its published width (48 bidirectional layers on the stream's
           frame embeddings) with path E's options, 4 steps, monitored: no
           port kernel launched; one traced step; one float32 step cut to 2
           layers card vs CPU;
  K        the cost model, in three parts: (K-a, first, on the host) each
           path's cell dry-run on the meta device by launch.dryrun (a 4 x
           1024 prefill wave and decode step for C, D, G, H, I, a train step
           for E and J) and qwen3-moe-30b-a3b and jamba-v0.1-52b at full
           width, whose train steps must not fit in 80 GB; (K-c, last, over
           the NCCL group) launch.steps.make_dp_train_step on gemma-2b at
           full width, int8 compression off then on, at the largest batch
           the dry run fits: step-0 loss against build_train_step, quantize
           card vs CPU bitwise, one all-reduce per parameter leaf, the
           reduction's device time; (K-b) mfu beside every timed path and
           the dry run's peak beside the measured one;
  L        sequence and expert parallelism, over the same NCCL group: (L-a)
           gemma2-2b at its published width (26 layers, local window 4096,
           softcaps 50 and 30), 4 prompts of 4608 tokens and 32 greedy
           steps, once on one device (prefill through the flash kernel at
           window 4096 and softcap 50), once with attention through the
           plain version (the baseline), once on a one-rank mesh with
           seq_shard (the sequence-parallel prefill and the sharded
           decodes): logits held within the baseline + 2e-2, the greedy
           choices compared, hidden_states at 4 x 4096 with and without the
           mesh; times, mfu, peaks, collectives; (L-b) four virtual ranks of
           each sharded body at full width, one layer each, composed with
           the model's own local functions and merge code against the
           unsharded function: falcon-mamba-7b's mixer (the scan kernel per
           shard from h0 = 0), gemma2-2b's local and global decode attention
           at positions 4608-4639, minicpm3-4b's sequence-parallel prefill
           attention and sharded decode, qwen3-moe-30b-a3b's MoE layer (128
           experts as 4 x 32); device times beside the unsharded calls;
  M        the train step on a mesh, over the same NCCL group: (M-a) path E's
           run (gemma-2b at full width, its seed, batches and options) on a
           one-rank (1, 1) mesh, its state placed by
           launch.sharding.param_shardings with fsdp: the step-0 loss against
           path E's at rtol 1e-5, every loss within 0.35 of path E's
           (relative), step times, tokens/s, peak memory and mfu beside path
           E's; one float32 step with seq_shard of gemma-2b,
           granite-moe-1b-a400m, falcon-mamba-7b and minicpm3-4b, each cut to
           2 layers, against the same step without a mesh (path K-c's
           criterion); no port kernel launched (training runs the plain
           versions, as JAX does);
  N        serving with the weights and caches placed across ranks, over the
           same NCCL group: (N-a i) the dry run of gemma-2b x train_4k and
           jamba-v0.1-52b x decode_32k on JAX's 256-rank mesh and
           qwen3-moe-30b-a3b x prefill_32k on its 512-rank mesh, rank 0
           counted in a child process with its own fake process group:
           per-device peak, FLOPs, wire bytes; (ii) falcon-mamba-7b's decode
           layer at full width as four virtual ranks of the tensor-parallel
           Mamba decode (its state split over d_inner) against mamba_decode,
           after a 1024-token prefill of 4 rows, device times beside the
           unsharded step's; (iii) jamba-v0.1-52b at its published width cut
           to one period (8 layers, 26.6 GB of bf16 weights) served by
           launch.serve on a one-rank (1, 1) mesh with path C's traffic, the
           weights built placed leaf by leaf, the caches by cache_shardings'
           rule; its logits held against the same weights unplaced on one
           device within the plain baseline + 2e-2 (prefill launches flash
           and the scan);

    python3 chip_smoke.py --m-ranks 4   # path M-b on four cards, one process
                                        # each: gemma-2b on a (2, 2) mesh with
                                        # fsdp and seq_shard, 6 steps against
                                        # one device's, saved after step 3,
                                        # restored onto (1, 4), steps 3-5 again
    python3 chip_smoke.py --n-ranks 4   # path N-b on four cards, one process
                                        # each: jamba-v0.1-52b and
                                        # qwen3-moe-30b-a3b served whole on
                                        # (1, 4) (experts split four ways) with
                                        # path C's traffic; jamba's one period
                                        # on (1, 4) against one device

then the script's wall time, the path K, L, M and N JSON lines, the card's name and
power limit, one JSON line describing every ported kernel, and last
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

from repro_torch.launch.roofline import HW  # noqa: E402  (imports no torch)

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
H100_BYTES_PER_S = HW["hbm_bw"]  # HBM3, NVIDIA H100 SXM data sheet: 3.35e12
H100_F32_OPS_PER_S = HW["peak_flops_f32"]  # float32 outside the tensor cores: 67e12
H100_BF16_OPS_PER_S = HW["peak_flops"]  # bf16 dense tensor cores: 989e12
H100_TF32_OPS_PER_S = HW["peak_flops_tf32"]  # TF32 dense tensor cores: 495e12
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
FLASH_F32 = {"gemma-2b": FLASH_FULL[:9] + ("float32",)}  # the float32 instance, timed too
FLASH_MODELS = {  # the other bf16 configs' attention at one wave (configs/*.py)
    "gemma2-2b": (4, 1024, 1024, 8, 4, 256, True, 4096, 50.0, "bfloat16"),
    "h2o-danube3-4b": (4, 1024, 1024, 32, 8, 120, True, 4096, 0.0, "bfloat16"),
}
FLASH_MOE = (4, 1024, 1024, 16, 8, 64, True, 0, 0.0, "bfloat16")  # granite-moe prefill wave
# minicpm3-4b's MLA prefill wave: q/k at qk 64 + 32 = 96, v at FLASH_MLA_DV, H = KV = 40;
# ops.flash_attention pads all three to hd 128 and crops the output to 64
FLASH_MLA = (4, 1024, 1024, 40, 40, 96, True, 0, 0.0, "bfloat16")
FLASH_MLA_DV = 64
FLASH_VL = (4, 1024, 1024, 12, 2, 128, True, 0, 0.0, "bfloat16")  # qwen2-vl-2b prefill wave
FLASH_F32.update({"granite-moe-1b-a400m": FLASH_MOE[:9] + ("float32",),  # hd 64
                  "qwen2-vl-2b": FLASH_VL[:9] + ("float32",)})  # hd 128
# The kernels of one flash call on the profiler's list: the attention kernel
# (counted against the wrapper's launches) and float32's split prologue.
FLASH_CALL_KERNELS = ("flash_fwd", "flash_kv_split")
# gemma2-2b's prefill in path L-a: 4 x 4608 tokens, past the local layers' window
FLASH_GEMMA2 = (4, 4608, 4608, 8, 4, 256, True, 4096, 50.0, "bfloat16")
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
STAGE_CASES = [  # (B, S, d_inner, d_state, compute dtype): bitwise against the plain staging
    (2, 1024, 8192, 16, "bfloat16"), (2, 4096, 8192, 16, "bfloat16"),  # falcon-mamba, jamba
    (4, 1024, 8192, 16, "bfloat16"),  # path D's wave
    (4, 4096, 8192, 16, "bfloat16"),  # jamba's serving wave (perfbench's doc-4k): 2.1e9 elements
    (2, 1024, 8192, 16, "float32"), (2, 33, 50, 16, "bfloat16"), (3, 1, 64, 16, "bfloat16"),
    (1, 20, 9, 1, "bfloat16"), (2, 12, 5, 5, "float32"), (2, 7, 24, 8, "float32"),
    (1, 12, 5, 32, "bfloat16")]
STAGE_FULL = (32, 1024, 8192, 16)  # falcon-mamba-7b's serving wave (perfbench's score-1k):
# 4.3e9 elements, bitwise too
STAGE_EQUAL_CHUNK = 2**28  # elements compared at a time (the full wave's a alone is 17 GB)
SERVE = dict(n_requests=8, batch=4, prompt_len=1024, max_new=32)
# Path O: the float32 flash instance inside a model: gemma-2b at its
# published width with compute_dtype float32 (TF32 off), path C's two waves
# of 4 x 1024-token prompts, prefill only.
PREFILL_F32 = dict(arch="gemma-2b", waves=2, batch=4, prompt_len=1024)
SERVE_MOE = "granite-moe-1b-a400m"  # path G: the one MoE config whose float32 masters fit
SERVE_MLA = "minicpm3-4b"  # path H: 62 MLA layers
SERVE_VL = "qwen2-vl-2b"  # path I: M-RoPE and the vision stub, served by the example's twin
SERVE_VL_EXAMPLE = "examples/serve_monitored_torch.py"
# The smoke models' card-vs-CPU checks take these changes to configs.smoke: its
# MLA config has v_head_dim equal to its qk dim (8 + 8), which hides the v padding.
SMOKE_REPLACE = {SERVE_MLA: dict(qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)}
# Path G's live viewers: the HTTP views polled while serve runs, and the
# per-frame cost of a broadcast timed over this many publishes afterwards.
VIZ_POLLED = ("/", "/dashboard", "/series?rank=0", "/metrics")
VIZ_POLL_S = 0.1
VIZ_PUBLISHES = 200
# Kernel-name classes of a MoE prefill's device time (torch.profiler names
# on the H100: cuBLAS GEMMs are nvjet/xmma/cutlass kernels).
DEVICE_CLASSES = (("flash", FLASH_CALL_KERNELS),
                  ("gemm", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
                  ("sort", ("sort",)),
                  ("index", ("index", "gather", "scatter")),
                  ("scan", ("scan", "cum")))
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
# Path J: hubert-xlarge (the audio stub, a bidirectional encoder) trained at its
# published width on the stream's frame embeddings with path E's options.
TRAIN_AUDIO = dict(arch="hubert-xlarge", steps=4, global_batch=4, seq=1024)
TRAIN_LOSS0_ATOL = 2.0  # step 0 near ln V: random weights give near-uniform logits
# Path K: the cost model.  K-a dry-runs each card path's cell on the meta
# device (launch.dryrun), with the shapes registered at run time as
# tests/test_dryrun.py:92 registers mini_train: one serving wave of paths C,
# D, G, H and I (its prefill, and a decode step on its 1024-slot cache) and a
# train step of paths E and J; and, dry only, the two configs whose float32
# masters exceed the card.  K-b puts the roofline share (mfu = model_flops /
# (seconds x 989e12)) beside every timed path, and the dry run's predicted
# peak beside the measured one.  K-c runs the data-parallel step.
DRYRUN_SHAPES = {"k_prefill": (1024, 4, "prefill"), "k_decode": (1024, 4, "decode"),
                 "k_train": (1024, 4, "train")}  # name: (seq, global batch, mode)
DRYRUN_PATHS = (("C", "gemma-2b", ("k_prefill", "k_decode")),
                ("D", "falcon-mamba-7b", ("k_prefill", "k_decode")),
                ("G", SERVE_MOE, ("k_prefill", "k_decode")),
                ("H", SERVE_MLA, ("k_prefill", "k_decode")),
                ("I", SERVE_VL, ("k_prefill", "k_decode")),
                ("E", TRAIN["arch"], ("k_train",)),
                ("J", TRAIN_AUDIO["arch"], ("k_train",)),
                ("dry", "qwen3-moe-30b-a3b", ("k_prefill", "k_train")),
                ("dry", "jamba-v0.1-52b", ("k_prefill", "k_train")))
# K-c: make_dp_train_step on gemma-2b at its published width over the
# one-rank NCCL group, int8 compression off then on, DP["steps"] steps each,
# at the first of DP["batches"] rows x DP["seq"] whose dry run fits in 80 GB.
# Its step-0 loss against build_train_step without remat at the card's
# exact-resume rtol; the quantisation error per element within
# tests/test_misc.py:31's 0.51 of its block's scale.
DP = dict(arch="gemma-2b", steps=4, seq=1024, batches=(4, 2, 1), ce_chunk=512,
          loss_rtol=1e-5, quant_slack=0.51, opt=TRAIN_OPTS["opt"])
# The card-vs-CPU step: float32 (TF32 off), full width cut to 2 layers.  Loss
# and grad norm at float32 sums' tolerances; Adam's first step moves each
# weight by about lr * sign(g), so an element whose tiny gradient changes
# sign between the two summation orders moves by up to 2 lr the other way:
# a share of 1e-4 of the elements may miss rtol 1e-4 / atol 1e-6 (never by
# more than 2 lr).
TRAIN_PARITY = dict(n_layers=2, batch=1, seq=64, loss_rtol=1e-5, grad_norm_rtol=1e-4,
                    params_rtol=1e-4, params_atol=1e-6, params_off_share=1e-4)
# Path L: sequence and expert parallelism.  L-a serves gemma2-2b at full
# width twice (one device; a one-rank mesh with seq_shard); L-b composes four
# virtual ranks of each sharded body at full width, one layer each.
SEQ_PAR = dict(arch="gemma2-2b", batch=4, prompt_len=4608, max_new=32, hidden_seq=4096)
SEQ_BODIES = dict(ranks=4, mamba=("falcon-mamba-7b", 4, 1024), decode=("gemma2-2b", 4, 4608, 32),
                  mla=("minicpm3-4b", 4, 1024, 8), moe=("qwen3-moe-30b-a3b", 4, 1024))
SEQ_TOL = 2e-2  # the card's bf16 smoke tolerance, beyond the plain-attention baseline (ROADMAP §3)
# Path M: the train step on a mesh, its state placed by param_shardings.
# M-a: path E's run (its seed, batches and options, fsdp) on a one-rank (1, 1)
# mesh over the NCCL group, seq_shard off: its step-0 loss against path E's
# (build_train_step without a mesh on the same state and batch) at the card's
# exact-resume rtol, every loss within tests/test_training.py:112's relative
# 0.35 of path E's; then one float32 step with seq_shard on for each of
# MESH_PARITY at full width cut to TRAIN_PARITY's layers, against the same
# step without a mesh by TRAIN_PARITY (K-c).  M-b (--m-ranks N, N cards):
# gemma-2b on a (2, N/2) mesh with fsdp and seq_shard, its losses within
# tests/test_elastic.py:66's 5e-2 of the one-device run; a save after step
# 3, a restore onto (1, N) and steps 3-5 within the same bound of the
# uninterrupted run.
MESH_PARITY = ("gemma-2b", "granite-moe-1b-a400m", "falcon-mamba-7b", "minicpm3-4b")
MESH_LOSS_RTOL = 0.35  # tests/test_training.py:112: two runs' losses, relative
MESH_RANKS = dict(save_after=3, loss_atol=5e-2)  # tests/test_elastic.py:66
# Path N: serving with the weights and caches placed across ranks.  N-a (the
# one-card run): (i) the dry run of MESH_DRY's cells on JAX's production
# meshes, in a child process that owns a fake process group; (ii) TP_DECODE:
# falcon-mamba-7b's decode layer at full width as four virtual ranks of the
# tensor-parallel Mamba decode against mamba_decode; (iii) SERVE_MESH at its
# published width cut to one period, served by launch.serve on a one-rank
# (1, 1) NCCL mesh (weights by placed_compute_params, caches by
# cache_shardings' rule) with SERVE's traffic, its logits held against the
# same weights unplaced on one device within the plain baseline + SEQ_TOL.
# N-b (--n-ranks N, N cards): MESH_SERVE_ARCHS served whole on (1, N), and
# (iii) on N ranks against one device.
MESH_DRY = (("gemma-2b", "train_4k", "single"), ("jamba-v0.1-52b", "decode_32k", "single"),
            ("qwen3-moe-30b-a3b", "prefill_32k", "multi"))
TP_DECODE = dict(arch="falcon-mamba-7b", ranks=4, batch=4, prompt_len=1024, steps=8)
SERVE_MESH = "jamba-v0.1-52b"
MESH_SERVE_ARCHS = ("jamba-v0.1-52b", "qwen3-moe-30b-a3b")
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
    from repro_torch.kernels import mamba_stage as mst
    from repro_torch.kernels import moments as mo

    return {"moments_and_labels": mo, "flash_attention": fa, "mamba_scan": ms,
            "mamba_stage": mst}


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
                  "flash_attention": ("flash_fwd",), "mamba_scan": ("mamba_scan_fwd",),
                  "mamba_stage": ("mamba_stage_ab",)}


def _profile(fn, calls: int):
    """Profile ``calls`` calls of ``fn`` after a warm-up cycle of as many, so
    that the recorded cycle loses nothing to the profiler's start.  Returns
    {kernel name[:120]: (device ms, launches)}, the host wall ms of the
    recorded cycle, the wrapper counts' rise over it, and (top-level aten
    ops, host waits on the device) per call."""
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
    by_kernel = kernel_times(prof.key_averages())
    ops = sum(1 for e in prof.events() if e.name.startswith("aten::") and not (
        e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::")))
    # host waits on the device: every *Synchronize call but the cycle's own
    # two (the profiler adds one more of its own: a path that never waits reads 1)
    syncs = sum(1 for e in prof.events() if "Synchronize" in e.name) - 2
    return by_kernel, wall_ms, launched, (ops / calls, syncs / calls)


def kernel_times(averages) -> dict:
    """{kernel name[:120]: (device ms, launches)} from the profiler's
    ``key_averages()``: device events only, without the schedule's own
    range and without the device-side copies of the program's
    record_function ranges (user annotations), which span kernels and would
    count their time twice."""
    by_kernel = {}
    for ev in averages:
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0)
        if us > 0 and str(getattr(ev, "device_type", "")).endswith("CUDA") and \
                not getattr(ev, "is_user_annotation", False) and \
                not ev.key.startswith("ProfilerStep"):
            ms, n = by_kernel.get(ev.key[:120], (0.0, 0))
            by_kernel[ev.key[:120]] = (ms + us / 1e3, n + ev.count)
    return by_kernel


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


def _flash_inputs(dev, case, seed, dv=None):
    """q, k (head dim hd) and v (head dim ``dv``, default hd) at ``case``."""
    import torch

    B, Sq, Sk, H, KV, hd, _, _, _, dtype = case
    rng = np.random.default_rng(seed)
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    return [torch.from_numpy(rng.normal(0, 1, s).astype(np.float32)).to(dev, dt)
            for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, dv or hd))]


def flash_bound(case, dv=None) -> dict:
    """The least time for one call at ``case``: the QK^T (head dim hd) and PV
    (head dim ``dv``, default hd) products of the live (query, key) pairs
    over the fastest rate that computes them to the case's type (bf16 tensor
    cores; float32 as split TF32, three TF32 products of each pair on the
    tensor cores, the float32 instance's arithmetic), against each input
    read once and the output written once over the memory rate; unpadded,
    as the function needs them (MLA's padding to a kernel width is not
    counted).  In float32 also ``cuda_core_ms``, the same products on the
    CUDA cores' float32 rate against the same bytes."""
    B, Sq, Sk, H, KV, hd, causal, window, _, dtype = case
    dv = dv or hd
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    live = np.ones((Sq, Sk), bool)
    if causal:
        live &= k <= q
    if window > 0:
        live &= (q - k) < window
    flops = 2.0 * (hd + dv) * B * H * float(live.sum())  # 2 per multiply-add, two products
    itemsize = 2 if dtype == "bfloat16" else 4
    nbytes = itemsize * (B * Sq * H * (hd + dv) + B * Sk * KV * (hd + dv))
    rate = H100_BF16_OPS_PER_S if dtype == "bfloat16" else H100_TF32_OPS_PER_S / 3
    ops_ms, bytes_ms = flops / rate * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    out = {"flops": flops, "bytes": nbytes, "ops_ms": ops_ms, "bytes_ms": bytes_ms,
           "bound_ms": max(ops_ms, bytes_ms),
           "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}
    if dtype == "float32":
        out["cuda_core_ms"] = max(flops / H100_F32_OPS_PER_S * 1e3, bytes_ms)
    return out


def phase_flash(dev, agree: OutputAgreement) -> dict:
    import torch

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref

    def compare(what, case, seed, kv_len=None, dv=None):
        q, k, v = _flash_inputs(dev, case, seed, dv)
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

    f32_errs = {}
    for arch, case in FLASH_F32.items():
        q, k, v, out, f32_errs[arch] = compare(f"flash {arch} float32 {case}", case, SEED)
        again = fa.flash_attention(q, k, v, causal=True)
        if not torch.equal(out.view(torch.int32), again.view(torch.int32)):
            raise AssertionError(f"flash: {arch}'s shape in float32: two launches on the same "
                                 "input gave different results")
        del q, k, v, out, again
    log("flash: float32 (split TF32) at one wave of "
        + ", ".join(f"{arch} {case[:6]} within 2e-5, max abs err {f32_errs[arch]:.3g}"
                    for arch, case in FLASH_F32.items())
        + "; two launches bitwise equal at each")
    q, k, v, out, _ = compare("flash full width", FLASH_FULL, SEED)
    again = fa.flash_attention(q, k, v, causal=True)
    if not torch.equal(out.view(torch.int16), again.view(torch.int16)):
        raise AssertionError("flash: two launches on the same input gave different results")
    log(f"flash: full width {FLASH_FULL} ok, two launches bitwise equal")
    del q, k, v, out, again
    for arch, case in FLASH_MODELS.items():
        err = compare(f"flash {arch} {case}", case, SEED)[-1]
        log(f"flash: {arch} attention at one wave {case} within 2e-2, max abs err {err:.3g}")
    q, k, v, out, err = compare(f"flash {SERVE_MOE} {FLASH_MOE}", FLASH_MOE, SEED)
    again = fa.flash_attention(q, k, v, causal=True)
    if not torch.equal(out.view(torch.int16), again.view(torch.int16)):
        raise AssertionError(f"flash: {SERVE_MOE}'s shape: two launches gave different results")
    log(f"flash: {SERVE_MOE} attention at one wave {FLASH_MOE} (hd 64, GQA 16:8) within "
        f"2e-2, max abs err {err:.3g}, two launches bitwise equal")
    del q, k, v, out, again
    q, k, v, out, err = compare(f"flash {SERVE_MLA} {FLASH_MLA} v {FLASH_MLA_DV}", FLASH_MLA, SEED,
                                dv=FLASH_MLA_DV)
    again = ops.flash_attention(q, k, v, causal=True)
    if tuple(out.shape) != FLASH_MLA[:2] + (FLASH_MLA[3], FLASH_MLA_DV) or \
            not torch.equal(out.view(torch.int16), again.view(torch.int16)):
        raise AssertionError(f"flash: {SERVE_MLA}'s shape: output {tuple(out.shape)}, or two "
                             "calls gave different results")
    log(f"flash: {SERVE_MLA} MLA attention at one wave {FLASH_MLA} (qk 96, v {FLASH_MLA_DV}, "
        f"H = KV = 40) through ops.flash_attention (q, k, v padded to hd "
        f"{ops.padded_head_dim(FLASH_MLA[5])}, the output cropped) within 2e-2, max abs err "
        f"{err:.3g}, two calls bitwise equal")
    del q, k, v, out, again
    err = compare(f"flash {SERVE_VL} {FLASH_VL}", FLASH_VL, SEED)[-1]
    log(f"flash: {SERVE_VL} attention at one wave {FLASH_VL} (hd 128, GQA 12:2) within 2e-2, "
        f"max abs err {err:.3g}")
    err = compare(f"flash gemma2-2b {FLASH_GEMMA2}", FLASH_GEMMA2, SEED)[-1]
    log(f"flash: gemma2-2b's path L-a prefill {FLASH_GEMMA2} (window 4096, softcap 50) within "
        f"2e-2, max abs err {err:.3g}")
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
            f"{timing['bytes'] / 1e6:.1f} MB)"
            + (f", CUDA-core bound {timing['cuda_core_ms'] * 1e3:.2f} us"
               if "cuda_core_ms" in timing else "")
            + f"; host enqueue {timing['host_ms'] * 1e3:.1f} us "
            f"(its input checks {timing['host_check_ms'] * 1e3:.1f} us); "
            "device by kernel (torch.profiler, us/launch): "
            + (", ".join(f"{n} {m * 1e3:.1f}" for n, m in timing["device_ms"].items())
               or "not measured (no device time recorded)")
            + f" (the call's kernels {_us(timing['device_call_ms'])} us)"
            + "; scaled_dot_product_attention's: "
            + (", ".join(f"{n} {m * 1e3:.1f}" for n, m in timing["library_device_ms"].items())
               or "not measured (no device time recorded)"))
        for hd in sorted(built[dtype]):
            log(f"flash[{dtype}] hd {hd}: ptxas {timing['ptxas'][hd]}; SASS "
                + ", ".join(f"{op} {n}" for op, n in timing["sass"][hd].items()))
    log(f"flash[float32] prologue flash_kv_split_tf32: ptxas {built['prologue']['ptxas']}"
        + "".join(f"; ptxas says: {w}" for w in built["warnings"]))
    shapes = {"moe": (SERVE_MOE, flash_timing(dev, FLASH_MOE)),
              "mla": (SERVE_MLA, flash_timing(dev, FLASH_MLA, dv=FLASH_MLA_DV)),
              "vl": (SERVE_VL, flash_timing(dev, FLASH_VL)),
              "gemma2": ("gemma2-2b", flash_timing(dev, FLASH_GEMMA2)),
              "moe_f32": (SERVE_MOE, flash_timing(dev, FLASH_F32[SERVE_MOE])),
              "vl_f32": (SERVE_VL, flash_timing(dev, FLASH_F32[SERVE_VL]))}
    for arch, t in shapes.values():
        log_flash_shape(arch, t)
    return {**instances["bfloat16"], "instances": instances, "f32_errs": f32_errs,
            **{key: t for key, (_, t) in shapes.items()}}


def _us(ms) -> str:
    return "not measured" if ms is None else f"{ms * 1e3:.1f}"


def flash_call_device_ms(device_ms: dict):
    """Device ms of one flash call: its kernels (FLASH_CALL_KERNELS) summed
    over the profile's per-launch times; None where nothing was recorded."""
    parts = [ms for name, ms in device_ms.items() if any(k in name for k in FLASH_CALL_KERNELS)]
    return sum(parts) if parts else None


def log_flash_shape(arch: str, t: dict) -> None:
    """One model shape's flash timing (flash_timing) as one line."""
    case = t["case"]
    what = "ops.flash_attention (pads, kernel) and the crop's copy" if t["dv"] != case[5] \
        else "kernel"
    log(f"flash[{arch}]: {case} v {t['dv']}: {what} {t['ms'] * 1e3:.1f} us/call, "
        f"scaled_dot_product_attention {t['library_ms'] * 1e3:.1f} us"
        + ("" if t["library_same_function"] else " (causal, no window or softcap)")
        + " (in turns: "
        + ", ".join(f"{n} {x * 1e3:.1f}" for n, x in zip(
            ("kernel", "sdpa", "sdpa", "kernel"), t["turns_ms"]))
        + f"; max abs diff to the kernel {t['library_max_abs_diff']:.3g}), plain "
        f"{t['plain_ms'] * 1e3:.1f} us, bound {t['bound_ms'] * 1e3:.2f} us "
        f"({t['bound_by']}: {t['flops'] / 1e9:.2f} GFLOP, {t['bytes'] / 1e6:.1f} MB; "
        f"the bytes alone {t['bytes_ms'] * 1e3:.2f} us"
        + (f"; CUDA cores {t['cuda_core_ms'] * 1e3:.2f} us" if "cuda_core_ms" in t else "")
        + f"); host enqueue "
        f"{t['host_ms'] * 1e3:.1f} us (its input checks {t['host_check_ms'] * 1e3:.1f} us); "
        "device by kernel (torch.profiler, us/launch): "
        + (", ".join(f"{n} {m * 1e3:.1f}" for n, m in t["device_ms"].items())
           or "not measured (no device time recorded)")
        + f" (the call's flash kernels {_us(t['device_call_ms'])} us)"
        + "; scaled_dot_product_attention's: "
        + (", ".join(f"{n} {m * 1e3:.1f}" for n, m in t["library_device_ms"].items())
           or "not measured (no device time recorded)"))


_FLASH_INSTANCE = re.compile(r"flash_fwd_(wgmma_bf16|wgmma_f32)ILi(\d+)E")
_FLASH_DTYPE = {"wgmma_bf16": "bfloat16", "wgmma_f32": "float32"}
_FLASH_PROLOGUE = "flash_kv_split_tf32"
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
    of every instance in the built flash library, "prologue": the float32
    split kernel's, and "warnings": ptxas's wgmma warnings.  Raises if an
    instance or the prologue is missing or spills, if an instance lacks
    HGMMA (wgmma) or UTMALDG (TMA loads), or if any other kernel is left in
    the library (the float32 CUDA-core instance it replaced)."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    log_text = _build.build_log("flash_attention")
    facts, current = {"prologue": {"ptxas": []}}, None
    for line in log_text.splitlines():
        m = _FLASH_INSTANCE.search(line)
        if "Compiling entry function" in line and m:
            current = facts.setdefault(_FLASH_DTYPE[m.group(1)], {}).setdefault(
                int(m.group(2)), {"ptxas": [], "sass": {}})
        elif "Compiling entry function" in line:
            current = facts["prologue"] if _FLASH_PROLOGUE in line else None
        elif current is not None and ("registers" in line or "spill" in line):
            current["ptxas"].append(line.replace("ptxas info    :", "").strip())
    notes = Counter()  # ptxas's notes on wgmma (C75xx: serialised, or fences injected)
    for line in log_text.splitlines():
        code, m = re.search(r"\(C75\d\d\)", line), _FLASH_INSTANCE.search(line)
        if code and "GMMA" in line.upper():
            where = f"{_FLASH_DTYPE[m.group(1)]} hd {m.group(2)}" if m else "?"
            notes[f"{code[0]} {line.split(code[0], 1)[1].split(' in around')[0].strip()} "
                  f"({where})"] += 1
    facts["warnings"] = [f"{text} x {n}" for text, n in sorted(notes.items())]
    others = []
    for function, ops in sass_by_function("flash_attention").items():
        m = _FLASH_INSTANCE.search(function)
        if m:
            facts[_FLASH_DTYPE[m.group(1)]][int(m.group(2))]["sass"] = {
                **{op: ops[op] for op in FLASH_SASS}, "total": sum(ops.values())}
        elif _FLASH_PROLOGUE not in function:
            others.append(function)
    if others:
        raise AssertionError(f"flash: the library holds kernels other than the instances and "
                             f"the prologue: {others}")
    for f in [facts["prologue"]] + [facts.get(dtype, {}).get(hd) for dtype in
                                    ("bfloat16", "float32") for hd in fa.HEAD_DIMS]:
        if f is None or ("sass" in f and not f["sass"]) or not f["ptxas"]:
            raise AssertionError("flash: an instance or the prologue is missing from the "
                                 f"ptxas log or SASS: {sorted(facts)}")
        f["ptxas"] = "; ".join(f["ptxas"])
        spills = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", f["ptxas"])
        if spills is None or int(spills[1]) or int(spills[2]):
            raise AssertionError(f"flash: a kernel spills or has no ptxas line: {f['ptxas']}")
        if "sass" in f and not (f["sass"]["HGMMA"] and f["sass"]["UTMALDG"]):
            raise AssertionError(f"flash: an instance's SASS lacks HGMMA or UTMALDG: "
                                 f"{f['sass']}")
    return facts


def flash_timing(dev, case, dv=None) -> dict:
    """One instance at ``case`` (its mask, window and softcap): CUDA-event ms
    per call in turns with scaled_dot_product_attention (kernel, SDPA, SDPA,
    kernel), the plain version's ms, host enqueue ms, device ms per launch of
    each kernel of the call (float32: the split prologue and the attention
    kernel, summed in ``device_call_ms``) and of SDPA's kernels
    (torch.profiler; float32 SDPA with TF32 off, as phase_env's parity mode
    leaves it for the whole run) and the bound.  SDPA
    takes no window or softcap: where the case has one, it computes the
    causal attention of the same shape (``library_same_function`` False), a
    yardstick of the shape only.  Where
    the host enqueue exceeds the device time, the CUDA-event time is the
    host's, and the device times are the ones to compare.  With a v head dim
    ``dv`` below q/k's (MLA), the call timed is what the model runs:
    ops.flash_attention (its pads, the kernel) and the copy that crops the
    output, each a kernel of its own in the device times; the bound counts
    the unpadded work."""
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref

    q, k, v = _flash_inputs(dev, case, SEED, dv)
    dv = v.shape[-1]
    mask = dict(causal=case[6], window=case[7], cap=case[8])
    if dv == case[5]:
        launch = lambda: fa.flash_attention(q, k, v, **mask)  # noqa: E731
        checked = (q, k, v)
    else:
        launch = lambda: ops.flash_attention(q, k, v, **mask).contiguous()  # noqa: E731
        width = ops.padded_head_dim(case[5])
        checked = tuple(F.pad(t, (0, width - t.shape[-1])) for t in (q, k, v))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))  # (B, heads, S, hd)
    library = lambda: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, is_causal=case[6], enable_gqa=True)
    lib_diff = float((library().transpose(1, 2).float() - launch().float()).abs().max())
    turns = [cuda_ms(fn, iters=20) for fn in (launch, library, library, launch)]
    library_device_ms = device_ms_by_kernel(library, iters=5)
    device_ms = device_ms_by_kernel(launch, iters=5)
    return {
        "case": case,
        "dv": dv,
        "ms": (turns[0] + turns[3]) / 2,
        "library_ms": (turns[1] + turns[2]) / 2,
        "library_same_function": case[7] == 0 and case[8] == 0.0,
        "turns_ms": turns,
        "plain_ms": cuda_ms(lambda: flash_attention_ref(q, k, v, **mask), iters=5),
        "host_ms": host_ms(launch, iters=20),
        "host_check_ms": host_ms(lambda: fa._check(*checked), iters=200),  # part of host_ms
        "device_ms": device_ms,
        "device_call_ms": flash_call_device_ms(device_ms),
        "library_device_ms": library_device_ms,
        "library_max_abs_diff": lib_diff,
        **flash_bound(case, dv),
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


# -------------------------------------------------------------------- stage
def stage_bound(shape, item_bytes: int) -> dict:
    """The least time for one staging call at ``shape``: dt and x (B,S,di)
    and B (B,S,st) in the compute dtype (``item_bytes`` each) and A (di,st)
    float32 read once, a and b (B,S,di,st) float32 written once, over the
    memory rate (its exps and products take a fraction of that)."""
    B, S, di, st = shape
    nbytes = item_bytes * (2 * B * S * di + B * S * st) + 4 * (di * st + 2 * B * S * di * st)
    return {"bytes": nbytes, "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_by": "bytes"}


def stage_equal(tag: str, got, want) -> None:
    """Raise unless the staged a and b ``got`` equal ``want`` bit for bit,
    compared STAGE_EQUAL_CHUNK elements at a time, so that the check itself
    allocates little beside tensors of 17 GB."""
    import torch

    for name, g, w in zip("ab", got, want):
        if g.shape != w.shape:
            raise AssertionError(f"{tag}: {name} is {tuple(g.shape)}, the plain {tuple(w.shape)}")
        gi, wi = g.view(torch.int32).reshape(-1), w.view(torch.int32).reshape(-1)
        bad, ulp = 0, 0
        for i in range(0, gi.numel(), STAGE_EQUAL_CHUNK):
            gc_, wc_ = gi[i:i + STAGE_EQUAL_CHUNK], wi[i:i + STAGE_EQUAL_CHUNK]
            if not torch.equal(gc_, wc_):
                bad += int((gc_ != wc_).sum())
                ulp = max(ulp, int((gc_.long() - wc_.long()).abs().max()))
        if bad:
            raise AssertionError(f"{tag}: {name} differs from the plain staging in {bad} "
                                 f"elements, by at most {ulp} ulp")


def phase_stage(dev) -> dict:
    """The staging kernel bitwise against the plain staging at STAGE_CASES
    and at STAGE_FULL; at STAGE_FULL in bf16 its time (CUDA events), device
    time (torch.profiler, launches held against the wrapper's count) and
    host enqueue beside its byte bound, and the plain staging's time and
    device time by kernel."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mamba_stage_ref

    def inputs(shape, dtype, seed):
        """Δt as softplus gives it, x and B ~ N(0, 1), A = -exp(A_log) with
        Mamba's A_log = log(1..st)."""
        B, S, di, st = shape
        g = torch.Generator(device=dev).manual_seed(seed)
        dt = F.softplus(torch.randn((B, S, di), generator=g, device=dev) - 2)
        x = torch.randn((B, S, di), generator=g, device=dev)
        Bm = torch.randn((B, S, st), generator=g, device=dev)
        A = -torch.arange(1, st + 1, dtype=torch.float32, device=dev).repeat(di, 1)
        return dt.to(dtype), x.to(dtype), Bm.to(dtype), A

    for i, (*shape, dtype) in enumerate(STAGE_CASES + [(*STAGE_FULL, "bfloat16")]):
        gc.collect()
        torch.cuda.empty_cache()
        args = inputs(shape, getattr(torch, dtype), SEED + i)
        got = ops.mamba_stage(*args)
        stage_equal(f"stage {tuple(shape)} {dtype}", got, mamba_stage_ref(*args))
        del args, got
    log(f"stage: {len(STAGE_CASES) + 1} shapes bitwise equal to the plain staging (a and b), "
        f"the serving wave {STAGE_FULL} ({math.prod(STAGE_FULL):.3g} elements) included")

    gc.collect()
    torch.cuda.empty_cache()
    args = inputs(STAGE_FULL, torch.bfloat16, SEED)
    launch = lambda: ops.mamba_stage(*args)  # noqa: E731
    plain = lambda: mamba_stage_ref(*args)  # noqa: E731
    timing = {"ms": cuda_ms(launch, iters=10), "host_ms": host_ms(launch, iters=10),
              "device_ms": device_ms_by_kernel(launch, iters=3),
              **stage_bound(STAGE_FULL, 2)}
    timing["plain_ms"] = cuda_ms(plain, iters=3, warmup=1)
    plain_by_kernel, _, _ = profiled(plain, 1)
    timing["plain_device_ms"] = {k: ms for k, (ms, _) in plain_by_kernel.items()}
    timing["bound_share"] = timing["bound_ms"] / timing["ms"]
    log(f"stage: full width {STAGE_FULL} bf16: kernel {timing['ms']:.3f} ms/call, "
        f"{100 * timing['bound_share']:.1f} % of its bound {timing['bound_ms']:.3f} ms (bytes: "
        f"{timing['bytes'] / 1e9:.2f} GB); host enqueue {timing['host_ms'] * 1e3:.1f} us; device "
        f"by kernel (torch.profiler, ms/launch): "
        + (", ".join(f"{n} {m:.3f}" for n, m in timing["device_ms"].items())
           or "not measured (no device time recorded)")
        + f"; the plain staging {timing['plain_ms']:.3f} ms/call, device (ms): "
        + (", ".join(f"{n} {m:.3f}" for n, m in timing["plain_device_ms"].items())
           or "not measured"))
    del args
    gc.collect()
    torch.cuda.empty_cache()
    return timing


# ------------------------------------------------ main paths C, D: serve
def device_breakdown(fn) -> dict:
    """One profiled call of ``fn``: device ms by kernel (top 8), the sum, the
    host wall ms around it, the share of that wall time the device spent in
    no kernel (one stream, so kernels do not overlap), the number of
    top-level aten ops the host dispatched and the launches by kernel (each
    port kernel's equal to its wrapper's count, or ``profiled`` raises)."""
    by_kernel, wall_ms, (ops, syncs) = profiled(fn, 1)
    busy = sum(ms for ms, _ in by_kernel.values())
    top = dict(sorted(((k, ms) for k, (ms, _) in by_kernel.items()), key=lambda kv: -kv[1])[:8])
    return {"wall_ms": wall_ms, "device_ms": busy, "top": top, "host_ops": int(ops),
            "host_syncs": int(syncs),
            "idle_share": (1.0 - busy / wall_ms) if busy > 0 else None,
            "by_kernel": {k: ms for k, (ms, _) in by_kernel.items()},
            "launches": {k: n for k, (_, n) in by_kernel.items()}}


def step_peak_bytes(dev, fn):
    """(max_memory_allocated over one call of ``fn``, the bytes allocated
    before it): path K-b's measured peak.  ``fn``'s result is dropped."""
    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(dev), held


def device_classes(by_kernel: dict) -> dict:
    """Device ms by DEVICE_CLASSES (a kernel in the first class one of whose
    name parts it holds), the rest as "elementwise"."""
    out = {name: 0.0 for name, _ in DEVICE_CLASSES}
    out["elementwise"] = 0.0
    for kernel, ms in by_kernel.items():
        low = kernel.lower()
        cls = next((name for name, parts in DEVICE_CLASSES if any(p in low for p in parts)),
                   "elementwise")
        out[cls] += ms
    return out


def phase_serve(dev, arch: str, kernels: tuple, bf16_smokes=(), monitor=None) -> dict:
    """Serve ``arch`` at its published width through ``kernels``, each of
    which must launch once per layer per prefill wave while no other kernel
    launches;
    then hold the float32 smoke model of ``arch``, and the bf16 smoke model
    of each of ``bf16_smokes``, on the card against the CPU.  ``monitor``
    is passed to serve (default: serve's own)."""
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
    out = serve(arch=arch, smoke=False, seed=SEED, params=params, device=dev,
                monitor=monitor, **SERVE)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    waves = -(-SERVE["n_requests"] // SERVE["batch"])
    want = {name: (cfg.n_layers * waves if name in kernels else 0) for name in counts}
    mon = out["monitor"]
    if out["requests"] != SERVE["n_requests"] or \
            out["tokens"] != SERVE["n_requests"] * SERVE["max_new"]:
        raise AssertionError(f"{tag}: {out['requests']} requests, {out['tokens']} tokens")
    if mon["frames"] <= 0 or mon["events"] <= 0:
        raise AssertionError(f"{tag}: empty monitor summary {mon}")
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want} ({kernels} once per "
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
        log(f"{tag}: {name} traced: {prof['host_ops']} top-level aten ops, "
            f"{prof['host_syncs']} host waits on the device (Synchronize calls), wall "
            f"{prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms, idle share "
            + (f"{prof['idle_share']:.3f}" if prof["idle_share"] is not None
               else "not measured")
            + "; top kernels (ms): "
            + ", ".join(f"{n} {m:.3f}" for n, m in prof["top"].items()))
    del cache, logits
    # Path K-b: the peak of one prefill wave as the dry run's k_prefill cell
    # runs it (compute weights and the prompts live, no decode slots)
    prefill_peak, held = step_peak_bytes(dev, lambda: M.prefill(cfg, cparams, {"tokens": toks}))
    log(f"{tag}: one prefill wave without decode slots: peak memory {prefill_peak / 1e9:.3f} "
        f"GB, of which {held / 1e9:.3f} GB held before it (the compute weights and prompts)")
    vision = vision_prefill(tag, cfg, cparams, dev, max_seq) \
        if cfg.modality == "vision_stub" else None
    del cparams

    smoke = {f"{a}/{dtype}": smoke_card_vs_cpu(dev, a, dtype, tag)
             for a, dtype in [(arch, "float32")] + [(a, "bfloat16") for a in bf16_smokes]}
    return {"counts": counts, "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "tok_per_s": out["tok_per_s"], "peak_bytes": peak, "param_bytes": param_bytes,
            "prefill_idle_share": prof_prefill["idle_share"],
            "decode_idle_share": prof_decode["idle_share"], "smoke": smoke,
            "prefill_by_kernel": prof_prefill["by_kernel"], "vision": vision,
            "prefill_peak_bytes": prefill_peak, "prefill_held_bytes": held}


def phase_prefill_f32(dev) -> dict:
    """Path O: PREFILL_F32's waves through models.model.prefill in float32
    at full width: one float32 flash launch per layer per wave (counts set
    to 0 just before, read just after) and no other kernel; each wave's
    logits held against the same prefill with attention through the plain
    version on the card, at SMOKE_TOL["float32"]; ms per wave (CUDA events)
    in the counted run, then once more, beside the plain attention's; one
    wave traced (torch.profiler): its flash launches against the wrapper's
    count, the device time of its flash kernels and the idle share."""
    import torch

    from repro_torch import configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params

    gc.collect()
    torch.cuda.empty_cache()
    P = PREFILL_F32
    tag = f"prefill_f32[{P['arch']}]"
    cfg = dataclasses.replace(configs.get_config(P["arch"]), compute_dtype=torch.float32)
    cparams = M.compute_params(cfg, init_params(cfg, SEED, dev))
    g = torch.Generator(device=dev).manual_seed(SEED)
    waves = [torch.randint(0, cfg.vocab, (P["batch"], P["prompt_len"]), generator=g,
                           device=dev, dtype=torch.int32) for _ in range(P["waves"])]

    def timed(toks):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        logits = M.prefill(cfg, cparams, {"tokens": toks})[0]
        end.record()
        end.synchronize()
        return logits[..., :cfg.vocab].float(), start.elapsed_time(end)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    runs = [timed(t) for t in waves]
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    again_ms = [timed(t)[1] for t in waves]
    prof = device_breakdown(lambda: M.prefill(cfg, cparams, {"tokens": waves[0]}))
    kernel = ops._fa.flash_attention
    ops._fa.flash_attention = flash_attention_ref
    try:
        plain = [timed(t) for t in waves]
    finally:
        ops._fa.flash_attention = kernel
    want = {name: (cfg.n_layers * P["waves"] if name == "flash_attention" else 0)
            for name in counts}
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want} (float32 flash once "
                             f"per layer per wave: {cfg.n_layers} layers x {P['waves']} waves)")
    traced = {part: sum(n for k, n in prof["launches"].items() if part in k)
              for part in FLASH_CALL_KERNELS}
    if traced != {part: cfg.n_layers for part in FLASH_CALL_KERNELS}:
        raise AssertionError(f"{tag}: the traced wave launched {traced}, expected "
                             f"{cfg.n_layers} of each (one flash call per layer)")
    flash_ms = sum(ms for k, ms in prof["by_kernel"].items()
                   if any(part in k for part in FLASH_CALL_KERNELS))
    tol = SMOKE_TOL["float32"]
    diffs = []
    for i, ((got, _), (ref, _)) in enumerate(zip(runs, plain)):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{tag}: wave {i}: non-finite logits")
        err = (got - ref).abs()
        beyond = int((err > tol["atol"] + tol["rtol"] * ref.abs()).sum())
        if beyond:
            raise AssertionError(f"{tag}: wave {i}: {beyond} logits beyond rtol {tol['rtol']} / "
                                 f"atol {tol['atol']} of the plain attention's, max abs diff "
                                 f"{float(err.max()):.3g}")
        diffs.append(float(err.max()))
    ms = [m for _, m in runs]
    plain_ms = [m for _, m in plain]
    log(f"{tag}: float32 at full width ({cfg.n_layers} layers, d {cfg.d_model}, H "
        f"{cfg.n_heads}, KV {cfg.n_kv_heads}, hd {cfg.head_dim}), {P['waves']} waves of "
        f"{P['batch']} x {P['prompt_len']} tokens: launches {counts}; ms per wave "
        + ", ".join(f"{m:.2f}" for m in ms) + " (counted run), "
        + ", ".join(f"{m:.2f}" for m in again_ms) + " (again); with the plain attention "
        + ", ".join(f"{m:.2f}" for m in plain_ms) + "; last-position logits within rtol "
        f"{tol['rtol']} / atol {tol['atol']} of the plain attention's, max abs diff "
        + ", ".join(f"{d:.3g}" for d in diffs)
        + f" (largest logit {max(float(r.abs().max()) for r, _ in plain):.3g}); peak memory "
        f"{peak / 1e9:.2f} GB")
    log(f"{tag}: one wave traced: launches {traced} (the wrapper's count {cfg.n_layers}), "
        f"wall {prof['wall_ms']:.2f} ms, device busy {prof['device_ms']:.2f} ms, of which "
        f"flash {flash_ms:.2f} ms, idle share "
        + (f"{prof['idle_share']:.3f}" if prof["idle_share"] is not None else "not measured")
        + "; top kernels (ms): " + ", ".join(f"{n} {m:.3f}" for n, m in prof["top"].items()))
    del cparams, runs, plain
    return {"counts": counts, "ms_per_wave": ms, "again_ms_per_wave": again_ms,
            "plain_ms_per_wave": plain_ms, "max_abs_diff": diffs, "peak_bytes": peak,
            "traced_launches": traced, "traced_device_ms": prof["device_ms"],
            "traced_flash_ms": flash_ms, "idle_share": prof["idle_share"]}


def vision_prefill(tag: str, cfg, cparams, dev, max_seq: int) -> dict:
    """One prefill wave of a vision-stub model at full width whose batch
    carries the port's synthetic_batch ``visual_embeds`` (the first quarter
    of each prompt) and M-RoPE ``pos3``: one flash launch per layer and no
    other kernel, finite logits, and its time (CUDA events)."""
    import torch

    from repro_torch.data.pipeline import synthetic_batch
    from repro_torch.models import model as M

    batch = synthetic_batch(cfg, SERVE["batch"], SERVE["prompt_len"], seed=SEED, device=dev)
    del batch["labels"]
    prefill = lambda: M.prefill(cfg, cparams, batch, max_seq=max_seq)  # noqa: E731
    zero_counts()
    logits, _ = prefill()
    torch.cuda.synchronize()
    counts = read_counts()
    want = {name: (cfg.n_layers if name == "flash_attention" else 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{tag}: vision prefill launches {counts}, expected {want}")
    if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
        raise AssertionError(f"{tag}: non-finite logits from the vision prefill")
    del logits
    ms = cuda_ms(prefill, iters=3, warmup=1)
    n_vis = batch["visual_embeds"].shape[1]
    log(f"{tag}: vision prefill of {SERVE['batch']} x {SERVE['prompt_len']} tokens, the first "
        f"{n_vis} of each replaced by visual_embeds, M-RoPE pos3 (t, h, w) up to "
        f"{tuple(int(x) for x in batch['pos3'].amax(dim=(1, 2)).tolist())}: launches {counts}, "
        f"logits finite, {ms:.2f} ms per wave (CUDA events)")
    return {"counts": counts, "ms": ms, "visual_tokens": n_vis}


def smoke_card_vs_cpu(dev, arch: str, dtype: str, tag: str) -> dict:
    """The smoke model of ``arch`` (with SMOKE_REPLACE's changes) in
    ``dtype``, prefill of 40 tokens and 4 decode steps, on the card
    (kernels) and on the CPU (plain versions), from the same weights, the
    logits held together at SMOKE_TOL[dtype].  A vision-stub model's prefill
    batch carries seeded ``visual_embeds`` over its first quarter and the
    M-RoPE ``pos3`` of data.pipeline.make_pos3.

    In bf16 every attention call of the card run is held at FLASH_TOL
    against the plain version on its own inputs, and the card runs once more
    with attention through the plain version on the card, the baseline
    of what the card's other bf16 arithmetic does.  Where that baseline is
    itself beyond SMOKE_TOL of the CPU somewhere (a rounding flip amplified
    by the model), the kernel's run may not exceed the baseline's largest
    difference by more than the tolerance's 2e-2; elsewhere it is held
    elementwise.

    A MoE model's routing is a discrete choice: a one-ulp difference in a
    router logit at a near-tie picks another expert, and the token's row
    then differs by far more than any rounding tolerance.  So for a MoE
    model the card's kernel run goes first and records each moe_block
    call's top-k experts, the other runs replay them (with their own
    routing weights), and the logits are held by the rule above; the CPU
    run without the replay is reported beside it, with the number of
    routing choices the replay overrode."""
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import make_pos3, vis_tokens
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import MOE as MOE_MLP, init_params

    smoke = dataclasses.replace(configs.smoke(arch), compute_dtype=getattr(torch, dtype),
                                **SMOKE_REPLACE.get(arch, {}))
    name = smoke.name + "".join(f" {k}={v}" for k, v in SMOKE_REPLACE.get(arch, {}).items())
    p_cpu = M.compute_params(smoke, init_params(smoke, SEED, "cpu"))
    p_dev = {**{k: v.to(dev) for k, v in p_cpu.items() if k != "layers"},
             "layers": [{k: v.to(dev) for k, v in layer.items()} for layer in p_cpu["layers"]]}
    rng = np.random.default_rng(SEED)
    toks = torch.from_numpy(rng.integers(0, smoke.vocab, (2, 44)).astype(np.int32))
    extra = {}
    if smoke.modality == "vision_stub":
        n_vis = vis_tokens(40)
        extra = {"visual_embeds": torch.from_numpy(
                     rng.normal(0, 1, (2, n_vis, smoke.d_model)).astype(np.float32)),
                 "pos3": torch.from_numpy(make_pos3(2, 40, n_vis))}

    route, routes, overridden = MOE._route, [], []

    def recording(p, xt, k):  # the card's kernel run: keep each call's experts
        probs, vals, ids = route(p, xt, k)
        routes.append(ids.cpu())
        return probs, vals, ids

    def pinned(p, xt, k):  # the other runs: the card's experts, their own weights
        probs, _, own = route(p, xt, k)
        ids = routes[len(overridden)].to(xt.device)
        overridden.append(int((ids != own).sum()))
        return probs, probs.gather(-1, ids), ids

    def logits_of(p, attention=None, router=route):
        wrapper = ops._fa.flash_attention
        if attention is not None:
            ops._fa.flash_attention = attention
        overridden.clear()
        MOE._route = router
        try:
            t = toks.to(p["embed"].device)
            batch = {"tokens": t[:, :40], **{k: x.to(t.device) for k, x in extra.items()}}
            logits, cache = M.prefill(smoke, p, batch, max_seq=44)
            outs = [logits[..., :smoke.vocab].float().cpu()]
            for i in range(40, 44):
                logits, cache = M.decode_step(smoke, p, cache, t[:, i:i + 1])
                outs.append(logits[..., :smoke.vocab].float().cpu())
        finally:
            ops._fa.flash_attention = wrapper
            MOE._route = route
        return torch.cat(outs, dim=1)

    calls = OutputAgreement()  # every attention call of the bf16 card run
    kernel = ops._fa.flash_attention

    def recorded(q, k, v, **kw):
        got = kernel(q, k, v, **kw)
        calls.check(f"{tag}: {name} attention {tuple(q.shape)}", got,
                    flash_attention_ref(q, k, v, **kw), FLASH_TOL[dtype])
        return got

    moe = smoke.mlp_has(MOE_MLP)
    card = logits_of(p_dev, recorded if dtype == "bfloat16" else None,
                     recording if moe else route)
    replay = pinned if moe else route
    cpu = logits_of(p_cpu, router=replay)
    tol = SMOKE_TOL[dtype]
    err = float((card - cpu).abs().max())
    beyond = lambda run: int(((run - cpu).abs() > tol["atol"] + tol["rtol"] * cpu.abs()).sum())  # noqa: E731
    out = {"max_abs_diff": err, "beyond_tol": beyond(card)}
    if moe:
        out.update(routing_choices=sum(int(r.numel()) for r in routes),
                   routing_overridden=sum(overridden))
        free = logits_of(p_cpu)
        out.update(unpinned_max_abs_diff=float((card - free).abs().max()))
        log(f"{tag}: {dtype} smoke {name}: the CPU run replays the card's "
            f"{out['routing_choices']} top-k choices, {out['routing_overridden']} of which "
            f"differ from its own; without the replay card vs CPU max abs diff "
            f"{out['unpinned_max_abs_diff']:.3g}")
    if dtype == "float32":
        np.testing.assert_allclose(card.numpy(), cpu.numpy(), **tol,
                                   err_msg=f"{tag}: float32 smoke {name} logits, card vs CPU")
        log(f"{tag}: float32 smoke {name} prefill(40) + 4 decode steps, card (kernel) vs "
            f"CPU (plain): logits within rtol {tol['rtol']} / atol {tol['atol']}, max abs diff "
            f"{err:.3g}")
        return out

    base = logits_of(p_dev, flash_attention_ref, replay)
    base_err = float((base - cpu).abs().max())
    out.update(base_max_abs_diff=base_err, base_beyond_tol=beyond(base),
               attention_max_abs_err=calls.max_abs)
    if moe:
        # What one bf16 ulp of attention rounding does to this model: the
        # CPU run with the plain attention's outputs moved one ulp up (down)
        # at a seeded 30 % of elements.  The baseline is the larger of this
        # and the card's plain-attention run.
        def one_ulp(sign):
            def attention(q, k, v, **kw):
                o = flash_attention_ref(q, k, v, **kw)
                g = torch.Generator().manual_seed(SEED + o.numel())
                moved = torch.nextafter(o, torch.full_like(o, sign * math.inf))
                return torch.where(torch.rand(o.shape, generator=g) < 0.3, moved, o)
            return attention
        ulp_err = max(float((logits_of(p_cpu, one_ulp(sign), replay) - cpu).abs().max())
                      for sign in (1, -1))
        out.update(one_ulp_max_abs_diff=ulp_err)
        base_err = max(base_err, ulp_err)
    if out["base_beyond_tol"] == 0 and not moe:
        np.testing.assert_allclose(card.numpy(), cpu.numpy(), **tol,
                                   err_msg=f"{tag}: bf16 smoke {name} logits, card vs CPU")
        held = f"elementwise within rtol {tol['rtol']} / atol {tol['atol']}"
    elif err > base_err + tol["atol"]:
        raise AssertionError(f"{tag}: bf16 smoke {name}: card (kernel) vs CPU max abs "
                             f"diff {err:.3g} exceeds the baseline {base_err:.3g} by more "
                             f"than {tol['atol']}")
    else:
        held = (f"within the baseline + {tol['atol']} (the card's plain-attention run"
                + (f", or the CPU's with attention one ulp off: {ulp_err:.3g}" if moe else "")
                + ")")
    log(f"{tag}: bf16 smoke {name} prefill(40) + 4 decode steps, card (kernel) vs CPU "
        f"(plain): logits {held}: max abs diff {err:.3g}, {out['beyond_tol']} of {cpu.numel()} "
        f"beyond the elementwise tolerance; card with plain attention vs CPU "
        f"{out['base_max_abs_diff']:.3g}, "
        f"{out['base_beyond_tol']} beyond; every in-model attention call within "
        f"{FLASH_TOL[dtype]} of the plain version (max abs err {calls.max_abs:.3g}); "
        f"largest logit {float(cpu.abs().max()):.3g}")
    return out


# ------------------------------------------------------------- serve, MoE
def http_get(endpoint, target: str, headers=()):
    """One GET on a fresh connection -> (status, lower-cased headers, body)."""
    import http.client

    conn = http.client.HTTPConnection(*endpoint, timeout=30)
    try:
        conn.request("GET", target, headers=dict(headers))
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


class Viewer:
    """A WebSocket viewer of the gateway's ``/ws`` on a thread of its own,
    counting the ``frame`` messages it receives."""

    def __init__(self, endpoint):
        import base64
        import socket
        import threading

        from repro_torch.viz import ws as W

        self.sock = socket.create_connection(endpoint, timeout=30)
        key = base64.b64encode(os.urandom(16)).decode()
        self.sock.sendall((f"GET /ws HTTP/1.1\r\nHost: smoke\r\nUpgrade: websocket\r\n"
                           f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                           f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise AssertionError("viewer: the gateway closed during the upgrade")
            buf += chunk
        head, _, rest = buf.partition(b"\r\n\r\n")
        if not head.startswith(b"HTTP/1.1 101"):
            raise AssertionError(f"viewer: upgrade refused: {head[:80]!r}")
        self.dec = W.WSDecoder(require_mask=False)
        self.kinds = Counter(json.loads(m.data)["type"] for m in self.dec.feed(rest))
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        import socket

        self.sock.settimeout(0.1)
        while not self.stop.is_set():
            try:
                data = self.sock.recv(1 << 16)
            except socket.timeout:
                continue
            if not data:
                break
            for m in self.dec.feed(data):
                self.kinds[json.loads(m.data)["type"]] += 1

    def close(self):
        self.stop.set()
        self.thread.join(timeout=10)
        self.sock.close()
        if self.thread.is_alive():
            raise AssertionError("viewer: the reader thread did not stop")


class Poller:
    """GETs every VIZ_POLLED view in turn on a thread of its own until
    ``done()`` holds or it is stopped; keeps each answer's status."""

    def __init__(self, endpoint, done):
        import threading

        self.endpoint, self.done, self.statuses = endpoint, done, Counter()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        while not self.stop.is_set() and not self.done():
            for target in VIZ_POLLED:
                self.statuses[(target, http_get(self.endpoint, target)[0])] += 1
            self.stop.wait(VIZ_POLL_S)

    def close(self):
        self.stop.set()
        self.thread.join(timeout=30)
        if self.thread.is_alive():
            raise AssertionError("poller: the thread did not stop")


def check_gateway(tag: str, mon, viewer) -> dict:
    """Path G's gateway checks after serve: every frame reached the viewer,
    every view equals VizServer's on the same monitor, ``/trace`` its bytes,
    a repeat GET answers 304; then the cost of one broadcast."""
    from repro_torch.viz.server import VizServer

    gw, viz = mon.viz_gateway, VizServer(mon)
    deadline = time.monotonic() + 30
    while viewer.kinds["frame"] < mon.frames_ingested and time.monotonic() < deadline:
        time.sleep(0.01)
    if not viewer.kinds["frame"] == gw.broadcasts == mon.frames_ingested > 0:
        raise AssertionError(f"{tag}: the viewer got {dict(viewer.kinds)}, the gateway made "
                             f"{gw.broadcasts} broadcasts, the monitor ingested "
                             f"{mon.frames_ingested} frames")
    rank, step = sorted(mon.kept)[-1]
    t0, t1 = 0, 1 << 62
    views = {"/dashboard": viz.rank_dashboard(), f"/series?rank={rank}": viz.frame_series(rank),
             f"/function?rank={rank}&step={step}": viz.function_view(rank, step),
             f"/callstack?rank={rank}&t0={t0}&t1={t1}": viz.call_stack_view(rank, t0, t1),
             "/provenance": viz.provenance_view()}
    for target, want in views.items():
        st, hdrs, body = http_get(gw.endpoint, target)
        if st != 200 or json.loads(body) != json.loads(json.dumps(want)):
            raise AssertionError(f"{tag}: {target} answered {st}, not VizServer's view")
        if http_get(gw.endpoint, target, [("If-None-Match", hdrs["etag"])])[0] != 304:
            raise AssertionError(f"{tag}: a repeat GET of {target} did not answer 304")
    st, hdrs, trace = http_get(gw.endpoint, "/trace")
    if st != 200 or hdrs.get("transfer-encoding") != "chunked" or trace != viz.trace():
        raise AssertionError(f"{tag}: /trace ({st}) is not VizServer(monitor).trace()'s bytes")
    before = viewer.kinds["frame"]
    t = time.perf_counter()
    for i in range(VIZ_PUBLISHES):
        gw.publish_frame(rank, step + 1 + i, 0)
    publish_us = (time.perf_counter() - t) * 1e6 / VIZ_PUBLISHES
    t = time.perf_counter()
    while viewer.kinds["frame"] < before + VIZ_PUBLISHES and time.perf_counter() - t < 30:
        time.sleep(0.001)
    delivered_us = (time.perf_counter() - t) * 1e6 / VIZ_PUBLISHES
    if viewer.kinds["frame"] != before + VIZ_PUBLISHES:
        raise AssertionError(f"{tag}: {viewer.kinds['frame'] - before} of {VIZ_PUBLISHES} "
                             "extra broadcasts reached the viewer")
    return {"frames": mon.frames_ingested, "views": sorted(views), "trace_bytes": len(trace),
            "publish_us": publish_us, "drain_us": delivered_us}


def phase_serve_moe(dev) -> dict:
    """Main path G: SERVE_MOE served at its published width with path C's
    traffic under a monitor with the live viz gateway, a WebSocket viewer
    and an HTTP poller attached while it runs; the gateway checks after;
    the float32 and bf16 smoke models card vs CPU; moe_block bitwise
    repeatable on the card at the prefill wave's shape; and the prefill's
    device time by kernel class (the MoE dispatch against its GEMMs)."""
    import socket

    import torch

    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.common import init_params
    from repro_torch.trace.monitor import ChimbukoMonitor

    tag = f"serve_moe[{SERVE_MOE}]"
    mon = ChimbukoMonitor(num_funcs=16, min_samples=8, viz_serve=0)  # serve's own settings
    endpoint = mon.viz_gateway.endpoint
    waves = -(-SERVE["n_requests"] // SERVE["batch"])  # serve ingests one frame per wave
    viewer, poller = Viewer(endpoint), Poller(endpoint, lambda: mon.frames_ingested >= waves)
    try:
        served = phase_serve(dev, SERVE_MOE, ("flash_attention",), bf16_smokes=(SERVE_MOE,),
                             monitor=mon)
        poller.close()
        bad = {k: n for k, n in poller.statuses.items() if k[1] != 200}
        if bad or not poller.statuses:
            raise AssertionError(f"{tag}: the poller's GETs during serve: {dict(poller.statuses)}")
        viz = check_gateway(tag, mon, viewer)
    finally:
        poller.close()
        viewer.close()
        mon.close()
    try:
        socket.create_connection(endpoint, timeout=2).close()
    except OSError:
        pass
    else:
        raise AssertionError(f"{tag}: the gateway's port is still open after monitor.close()")
    polls = sum(poller.statuses.values())
    log(f"{tag}: live viz gateway: a WebSocket viewer received {viz['frames']} frame messages "
        f"= the gateway's broadcasts = the frames ingested; {polls} GETs of "
        f"{', '.join(VIZ_POLLED)} during serve, all 200; {', '.join(viz['views'])} equal "
        f"VizServer's views and answer 304 to a repeat GET; /trace ({viz['trace_bytes']} "
        f"bytes, chunked) equals VizServer(monitor).trace(); the port is closed after "
        f"monitor.close(); one broadcast: {viz['publish_us']:.1f} us of host time to publish, "
        f"{viz['drain_us']:.1f} us per message to reach the viewer ({VIZ_PUBLISHES} in a row)")

    cfg = configs.get_config(SERVE_MOE)
    classes = device_classes(served.pop("prefill_by_kernel"))
    busy = sum(classes.values())
    log(f"{tag}: prefill device time by kernel class (ms, share of {busy:.3f} ms busy): "
        + ", ".join(f"{c} {ms:.3f} ({ms / busy:.3f})" for c, ms in classes.items()))
    # moe_block at the prefill wave's shape, one layer's weights, twice
    gc.collect()
    torch.cuda.empty_cache()
    layer = M.compute_params(cfg, init_params(dataclasses.replace(cfg, n_layers=1), SEED, dev))
    p = {k: layer["layers"][0][k][0] for k in MOE.KEYS}
    del layer
    g = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn((SERVE["batch"], SERVE["prompt_len"], cfg.d_model), generator=g,
                    device=dev).to(cfg.compute_dtype)
    a, b = MOE.moe_block(p, x, cfg), MOE.moe_block(p, x, cfg)
    if not torch.equal(a.view(torch.int16), b.view(torch.int16)) or \
            not bool(torch.isfinite(a).all()):
        raise AssertionError(f"{tag}: two moe_block calls on the same input differ")
    block_ms = cuda_ms(lambda: MOE.moe_block(p, x, cfg), iters=10)
    block = device_classes(device_breakdown(lambda: MOE.moe_block(p, x, cfg))["by_kernel"])
    N = SERVE["batch"] * SERVE["prompt_len"]
    log(f"{tag}: moe_block at ({SERVE['batch']}, {SERVE['prompt_len']}, {cfg.d_model}) bf16, "
        f"E {cfg.moe_experts} top-{cfg.moe_topk}, capacity {MOE.capacity(cfg, N)}: two calls "
        f"bitwise equal; {block_ms:.3f} ms per call (CUDA events); device ms by class: "
        + ", ".join(f"{c} {ms:.3f}" for c, ms in block.items()))
    del a, b, x, p
    return {**served, "viz": viz, "prefill_classes": classes, "moe_block_ms": block_ms,
            "moe_block_classes": block}


# ------------------------------------------------- serve, MLA and M-RoPE
def load_example(path: str):
    """A script under examples/ as a module (its main() is not run)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(Path(path).stem, ROOT / path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_serve_vl(dev) -> dict:
    """Main path I: the serve of examples/serve_monitored_torch.py (the
    port's twin of examples/serve_monitored.py) on SERVE_VL at its published
    width with path C's traffic, under a monitor with the example's
    settings, its per-phase profile printed; then a vision prefill and the
    smoke models card vs CPU (phase_serve).  First the example itself, as a
    user runs it on cuda:0 (its smoke traffic), outside the path's count."""
    import io

    from repro_torch.trace.monitor import ChimbukoMonitor

    tag = f"serve_vl[{SERVE_VL}]"
    example = load_example(SERVE_VL_EXAMPLE)
    printed = io.StringIO()
    argv = sys.argv
    sys.argv = [SERVE_VL_EXAMPLE, "--device", str(dev)]
    try:
        with contextlib.redirect_stdout(printed):
            example.main()
    finally:
        sys.argv = argv
    first = printed.getvalue().splitlines()[:2]
    want = (f"requests={example.TRAFFIC['n_requests']} "
            f"tokens={example.TRAFFIC['n_requests'] * example.TRAFFIC['max_new']}")
    if len(first) < 2 or not first[1].startswith(want):
        raise AssertionError(f"{tag}: {SERVE_VL_EXAMPLE} printed {first}")
    log(f"{tag}: {SERVE_VL_EXAMPLE} --device {dev} (smoke, {example.TRAFFIC['n_requests']} "
        f"requests): {first[1]}")
    mon = ChimbukoMonitor(**example.MONITOR)
    try:
        served = phase_serve(dev, SERVE_VL, ("flash_attention",), bf16_smokes=(SERVE_VL,),
                             monitor=mon)
        profile = example.profile(mon)
    finally:
        mon.close()
    log(f"{tag}: the example's monitor {example.MONITOR}; its per-phase profile (us): "
        + ("; ".join(line.strip() for line in profile) or
           "no line, as the JAX example prints none (ROADMAP.md section 3)"))
    return {**served, "profile": profile}


def phase_train_audio(dev) -> dict:
    """Main path J: repro_torch.launch.train.train on TRAIN_AUDIO's arch
    (the audio stub: frame embeddings in, a bidirectional encoder) at its
    published width on the SyntheticStream's embeds with path E's options,
    monitored: losses, step times, tokens/s, peak memory, no port kernel
    launched (training runs the plain attention, as JAX does); one traced
    step; one float32 step cut to 2 layers, card vs CPU."""
    import torch

    from repro_torch import configs
    from repro_torch.data.pipeline import DataShard, SyntheticStream, to_device
    from repro_torch.launch import steps as TS
    from repro_torch.launch import train as TR

    gc.collect()
    torch.cuda.empty_cache()
    arch, steps = TRAIN_AUDIO["arch"], TRAIN_AUDIO["steps"]
    B, S = TRAIN_AUDIO["global_batch"], TRAIN_AUDIO["seq"]
    tag = f"train_audio[{arch}]"
    cfg = configs.get_config(arch)
    opts = train_opts()
    record = []
    real = _timed_train_steps(TR, record)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    with tempfile.TemporaryDirectory() as tmp:
        zero_counts()
        try:
            out = TR.train(arch=arch, smoke=False, steps=steps, global_batch=B, seq=S,
                           monitor_dir=tmp, seed=0, opts=opts, log_every=1, device=dev)
        finally:
            TR.build_train_step = real
        torch.cuda.synchronize()
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
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
    if mon["frames"] != steps:
        raise AssertionError(f"{tag}: monitor saw {mon['frames']} frames for {steps} steps")
    later_host = float(np.mean(host_ms[1:]))
    later_event = float(np.mean(event_ms[1:]))
    tok_per_s = B * S / (later_host / 1e3)
    log(f"{tag}: full width, {cfg.n_params():,} parameters ({cfg.n_layers} non-causal layers, "
        f"d {cfg.d_model}, hd {cfg.head_dim}); global batch {B} x seq {S} frame embeddings, "
        f"remat {opts.remat}, ce_chunk {opts.ce_chunk}, {steps} steps")
    for i in range(steps):
        log(f"{tag}: step {i} loss {losses[i]:.4f} grad_norm {gnorms[i]:.4f} host "
            f"{host_ms[i]:.1f} ms, CUDA events {event_ms[i]:.1f} ms")
    log(f"{tag}: steps 1-{steps - 1}: host {later_host:.1f} ms, CUDA events "
        f"{later_event:.1f} ms per step, {tok_per_s:.0f} tokens/s (host); step-0 loss "
        f"{losses[0]:.4f} vs ln V {ln_v:.4f}; peak memory {peak / 1e9:.2f} GB; port kernel "
        f"launches {counts} (expected 0: training runs the plain versions); monitor frames "
        f"{mon['frames']} events {mon['events']}")

    del out, record
    gc.collect()
    torch.cuda.empty_cache()
    step_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, None, B, opts), opts)
    holder = {"state": TS.make_train_state(cfg, 0, device=dev)}
    batch = to_device(SyntheticStream(cfg, DataShard(0, 1, B), S).batch_at(0), dev)

    def one_step():
        holder["state"], _ = step_fn(holder["state"], batch)

    one_step()
    step_peak, _ = step_peak_bytes(dev, one_step)
    prof = device_breakdown(one_step)
    del holder, batch, step_fn
    log(f"{tag}: one step traced: {prof['host_ops']} top-level aten ops, wall "
        f"{prof['wall_ms']:.1f} ms, device busy {prof['device_ms']:.1f} ms, idle share "
        + (f"{prof['idle_share']:.3f}" if prof["idle_share"] is not None else "not measured")
        + "; top kernels (ms): " + ", ".join(f"{n} {m:.3f}" for n, m in prof["top"].items())
        + f"; one step's peak memory {step_peak / 1e9:.3f} GB")
    gc.collect()
    torch.cuda.empty_cache()
    parity = train_card_vs_cpu(dev, tag, arch)
    return {"counts": counts, "losses": losses, "grad_norms": gnorms, "step_ms": later_event,
            "step_host_ms": later_host, "tok_per_s": tok_per_s, "peak_bytes": peak,
            "step_peak_bytes": step_peak, "idle_share": prof["idle_share"],
            "card_vs_cpu": parity}


# ---------------------------------------------------------------- refusals
def phase_refusals(dev) -> None:
    """The card's own limits stay refusals on the card and only there: an F
    beyond a block's shared memory (moments) and a bf16 or float32 view off
    a 16-byte boundary (flash's TMA) raise for CUDA tensors without a launch, and the
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
                .view(shifted.shape), kv.to(d), kv.to(d)), "16-byte boundary"),
            ("flash misaligned float32", lambda d: fa.flash_attention(
                torch.zeros(shifted.numel() + 1, device=d)[1:].view(shifted.shape),
                kv.float().to(d), kv.float().to(d)), "16-byte boundary")):
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
    log("refusals: on the card moments F 20000 and misaligned bf16 and float32 flash views "
        "raise without a launch; on the CPU both take the plain versions")


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
    step_peak, _ = step_peak_bytes(dev, one_step)
    prof = device_breakdown(one_step)
    del holder, state, batch, step_fn
    log(f"{tag}: one step traced: {prof['host_ops']} top-level aten ops, wall "
        f"{prof['wall_ms']:.1f} ms, device busy {prof['device_ms']:.1f} ms, idle share "
        + (f"{prof['idle_share']:.3f}" if prof["idle_share"] is not None else "not measured")
        + "; top kernels (ms): " + ", ".join(f"{n} {m:.3f}" for n, m in prof["top"].items())
        + f"; one step's peak memory {step_peak / 1e9:.3f} GB")
    gc.collect()
    torch.cuda.empty_cache()
    parity = train_card_vs_cpu(dev, tag)
    resume = train_resume_on_card(dev, tag)
    return {"counts": counts, "losses": losses, "grad_norms": gnorms, "host_ms": host_ms,
            "event_ms": event_ms, "step_ms": later_event, "step_host_ms": later_host,
            "tok_per_s": tok_per_s, "peak_bytes": peak, "idle_share": prof["idle_share"],
            "step_peak_bytes": step_peak, "device_ms": prof["device_ms"],
            "wall_ms": prof["wall_ms"],
            "card_vs_cpu": parity, "resume": resume}


def train_card_vs_cpu(dev, tag: str, arch: str = TRAIN["arch"]) -> dict:
    """One build_train_step step of ``arch`` at its published width cut to
    TRAIN_PARITY's layers, in float32, from one seed's params on the CPU
    copied to the card: loss, grad norm and params after the step, card vs
    CPU, at TRAIN_PARITY's tolerances.  An audio-stub model steps on seeded
    frame embeddings."""
    import torch

    from repro_torch import tree as T
    from repro_torch.launch import steps as TS

    cfg, batch = parity_inputs(arch)
    opts = train_opts()
    step_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, None, TRAIN_PARITY["batch"], opts),
                                  opts)
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
    n_off, n_all, worst, lr = held_step(f"{tag}: card vs CPU", dev_m, cpu_m,
                                        T.leaves(dev_state["params"]), cpu_state["params"], before)
    log(f"{tag}: card vs CPU, one float32 step at full width cut to {cfg.n_layers} layers "
        f"({cfg.n_params():,} parameters), batch {TRAIN_PARITY['batch']} x "
        f"{TRAIN_PARITY['seq']}: loss {float(dev_m['loss']):.6f} "
        f"vs {float(cpu_m['loss']):.6f}, grad norm {float(dev_m['grad_norm']):.6f} vs "
        f"{float(cpu_m['grad_norm']):.6f}; params after the step: {n_off} of {n_all} beyond "
        f"rtol {tol['params_rtol']} / atol {tol['params_atol']} (at most a share of "
        f"{tol['params_off_share']}), max abs diff {worst:.3g} (lr {lr:.3g}); card "
        f"{card_s:.2f} s, CPU {cpu_s:.2f} s")
    return {"loss": float(dev_m["loss"]), "cpu_loss": float(cpu_m["loss"]),
            "params_beyond_tol": n_off, "params": n_all, "max_abs_diff": worst}


def parity_inputs(arch: str):
    """(``arch`` at its published width cut to TRAIN_PARITY's layers in
    float32, one seeded batch of TRAIN_PARITY's shape on the CPU); an
    audio-stub model steps on seeded frame embeddings."""
    import torch

    from repro_torch import configs

    cfg = dataclasses.replace(configs.get_config(arch),
                              n_layers=TRAIN_PARITY["n_layers"], compute_dtype=torch.float32)
    Bp, Sp = TRAIN_PARITY["batch"], TRAIN_PARITY["seq"]
    rng = np.random.default_rng(SEED)
    if cfg.modality == "audio_stub":
        return cfg, {"embeds": torch.from_numpy(
                         rng.normal(0, 1, (Bp, Sp, cfg.d_model)).astype(np.float32)),
                     "labels": torch.from_numpy(
                         rng.integers(0, cfg.vocab, (Bp, Sp)).astype(np.int32))}
    tokens = rng.integers(0, cfg.vocab, (Bp, Sp + 1))
    return cfg, {"tokens": torch.from_numpy(tokens[:, :-1].astype(np.int32)),
                 "labels": torch.from_numpy(tokens[:, 1:].astype(np.int32))}


def held_step(what: str, got_m: dict, want_m: dict, got_params: list, want_params, before: dict):
    """One train step against another by TRAIN_PARITY (K-c): loss and grad
    norm at their rtols; each parameter leaf after the step (``got_params``
    in leaf order, any device, against ``want_params``' tree) finite, moved
    from ``before`` and within 2 lr (1 + its largest magnitude), and at most
    a share of the elements beyond rtol / atol.  -> (elements beyond, all,
    largest abs diff, lr); raises on a miss."""
    import torch

    from repro_torch import tree as T

    tol = TRAIN_PARITY
    for name in ("loss", "grad_norm"):
        got, want = float(got_m[name]), float(want_m[name])
        if not abs(got - want) <= tol[f"{name}_rtol"] * abs(want):
            raise AssertionError(f"{what}: {name} {got} vs {want} beyond rtol "
                                 f"{tol[f'{name}_rtol']}")
    lr = float(want_m["lr"])
    worst, n_off, n_all = 0.0, 0, 0
    for (name, want), got in zip(T.paths(want_params), got_params):
        got, want = got.to(want.device), want
        err = (got - want).abs()
        off = err > tol["params_atol"] + tol["params_rtol"] * want.abs()
        n_off += int(off.sum())
        n_all += want.numel()
        worst = max(worst, float(err.max()))
        moved = (want - before[name]).abs().max()
        if float(err.max()) > 2 * lr * (1 + float(before[name].abs().max())) or \
                not bool(torch.isfinite(got).all()) or float(moved) == 0.0:
            raise AssertionError(f"{what} {name}: max abs diff {float(err.max())} (lr {lr}), "
                                 f"moved {float(moved)}")
    if n_off > tol["params_off_share"] * n_all:
        raise AssertionError(f"{what} params: {n_off} of {n_all} beyond rtol "
                             f"{tol['params_rtol']} / atol {tol['params_atol']}")
    return n_off, n_all, worst, lr


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


# ------------------------------------------------------------ path K: cost model
def phase_dryrun() -> dict:
    """Path K-a: each card path's cell (DRYRUN_PATHS) dry-run on the meta
    device by launch.dryrun.run_cell: the config's model FLOPs, the counted
    FLOPs, bytes and transcendentals, the predicted argument and peak bytes
    and fits_80gb_hbm.  The two dry-only configs' train cells must not fit:
    their float32 masters alone exceed the card."""
    from repro_torch import configs
    from repro_torch.launch import dryrun as D

    for name, (seq, batch, mode) in DRYRUN_SHAPES.items():
        configs.SHAPES[name] = configs.ShapeCell(name, seq, batch, mode)
    opts_kw = {k: v for k, v in TRAIN_OPTS.items() if k != "opt"}
    out = {}
    for path, arch, shapes in DRYRUN_PATHS:
        for shape in shapes:
            tag = f"dryrun[{path} {arch} {shape}]"
            rec = D.run_cell(arch, shape, opts_kw=opts_kw)
            if rec["status"] != "ok":
                raise AssertionError(f"{tag}: {rec}")
            m, c, roof = rec["memory"], rec["cost"], rec["roofline"]
            if not (c["flops"] > 0 and c["bytes_accessed"] > 0
                    and m["peak_bytes"] >= m["argument_size_in_bytes"] > 0):
                raise AssertionError(f"{tag}: empty count {c} {m}")
            if path == "dry" and shape == "k_train" and m["fits_80gb_hbm"]:
                raise AssertionError(f"{tag}: a {rec['n_params']:,}-parameter train state "
                                     f"fits in 80 GB: {m}")
            log(f"{tag}: model_flops {rec['model_flops_global']:.4e}; counted flops "
                f"{c['flops']:.4e} (model/counted {roof['model_vs_hlo_flops']:.3f}), bytes "
                f"accessed {c['bytes_accessed']:.4e} (op by op, unfused), transcendentals "
                f"{c['transcendentals']:.4e}, {rec['aten_ops']} aten ops; predicted argument "
                f"{m['argument_size_in_bytes'] / 1e9:.3f} GB, peak {m['peak_bytes'] / 1e9:.3f} "
                f"GB, fits_80gb_hbm {m['fits_80gb_hbm']}; roofline bound "
                f"{roof['step_time_lower_bound_s'] * 1e3:.3f} ms ({roof['dominant']}); "
                f"counted in {rec['compile_s']:.2f} s of host time")
            out[(path, arch, shape)] = rec
    return out


def phase_roofline(dry: dict, timed: dict, smi: str) -> dict:
    """Path K-b: mfu = model_flops / (seconds x HW["peak_flops"]) beside
    every timed path (prefill per wave, decode per step, train step), the
    card's name and power limit on each line; and the dry run's predicted
    peak beside the measured max_memory_allocated, with their ratio."""
    from repro_torch import configs
    from repro_torch.launch import roofline as R

    out = {}
    for path, arch, run in timed["serve"]:
        cfg = configs.get_config(arch)
        B, S = SERVE["batch"], SERVE["prompt_len"]
        for mode, ms in (("prefill", run["prefill_ms"]), ("decode", run["decode_ms"])):
            mf = R.model_flops(cfg, mode, B, S)
            share = R.mfu(cfg, mode, B, S, ms / 1e3)
            what = "per wave" if mode == "prefill" else "per step"
            log(f"mfu[{path} {arch}]: {mode} {ms:.2f} ms {what}, model_flops {mf:.4e} -> mfu "
                f"{share:.4f} of {HW['peak_flops']:.3g} FLOP/s ({smi})"
                + ("; model_flops counts the unembedding at every position, the port's "
                   "prefill at the last one only" if mode == "prefill" else ""))
            out[f"{path}/{mode}"] = {"ms": ms, "model_flops": mf, "mfu": share}
        pred = dry[(path, arch, "k_prefill")]["memory"]["peak_bytes"]
        got = run["prefill_peak_bytes"]
        log(f"mem[{path} {arch}]: one prefill wave, predicted peak {pred / 1e9:.3f} GB, "
            f"measured {got / 1e9:.3f} GB (max_memory_allocated), predicted/measured "
            f"{pred / got:.3f}")
        out[f"{path}/prefill"].update(predicted_peak=pred, measured_peak=got)
    for path, arch, run in timed["train"]:
        cfg = configs.get_config(arch)
        B, S = run["batch"], run["seq"]
        mf = R.model_flops(cfg, "train", B, S)
        for clock, ms in (("CUDA events", run["step_ms"]), ("host", run["step_host_ms"])):
            if ms is None:
                continue
            log(f"mfu[{path} {arch}]: train step {ms:.1f} ms ({clock}), {B} x {S} tokens, "
                f"model_flops {mf:.4e} -> mfu {R.mfu(cfg, 'train', B, S, ms / 1e3):.4f} "
                f"({smi})")
        entry = {"ms": run["step_ms"], "host_ms": run["step_host_ms"], "model_flops": mf,
                 "mfu": R.mfu(cfg, "train", B, S, run["step_ms"] / 1e3)}
        if run.get("predicted_peak") is not None:
            pred, got = run["predicted_peak"], run["step_peak_bytes"]
            log(f"mem[{path} {arch}]: one train step, predicted peak {pred / 1e9:.3f} GB, "
                f"measured {got / 1e9:.3f} GB (max_memory_allocated over the step; "
                f"{run['peak_bytes'] / 1e9:.3f} GB over the whole run), predicted/measured "
                f"{pred / got:.3f}")
            entry.update(predicted_peak=pred, measured_peak=got)
        out[f"{path}/train"] = entry
    return out


def phase_dp(dev) -> dict:
    """Path K-c: launch.steps.make_dp_train_step on DP["arch"] at its
    published width over the one-rank NCCL group, compression off then on,
    DP["steps"] steps each, at the first batch of DP["batches"] whose dry
    run (make_dp_cell on the meta device) fits in 80 GB.  Checks: step-0
    loss equal to build_train_step without remat on the same batch; quantize
    of a float32 gradient leaf bitwise equal on the card and on the CPU,
    each element's error within DP["quant_slack"] of its block's scale; one
    all-reduce per parameter leaf per step and one for the loss, their
    bytes by roofline.collective_bytes; no port kernel launched."""
    import torch

    import torch.distributed as dist

    from repro_torch import compat, configs
    from repro_torch import tree as T
    from repro_torch.data.pipeline import DataShard, SyntheticStream, to_device
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import roofline as R
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params
    from repro_torch.optim import compression as C
    from repro_torch.optim.adamw import OptConfig

    gc.collect()
    torch.cuda.empty_cache()
    tag = f"train_dp[{DP['arch']}]"
    cfg = configs.get_config(DP["arch"])
    S, opt = DP["seq"], OptConfig(**DP["opt"])
    mesh = compat.make_mesh((1,), ("data",), device=dev)
    zero_counts()
    preds = {}
    for b in DP["batches"]:
        rec = D.count(TS.make_dp_cell(cfg, b, S, mesh, True, DP["ce_chunk"], opt))
        preds[b] = rec["peak_bytes"]
        log(f"{tag}: dry run of the DP cell at {b} x {S} (compression on, no remat): "
            f"argument {rec['argument_size_in_bytes'] / 1e9:.3f} GB, predicted peak "
            f"{rec['peak_bytes'] / 1e9:.3f} GB, fits_80gb_hbm "
            f"{rec['peak_bytes'] < R.HW['hbm_bytes']}; {rec['collectives']['all-reduce']['count']:.0f} "
            f"all-reduces recorded")
        if rec["peak_bytes"] < R.HW["hbm_bytes"]:
            B = b
            break
    else:
        raise AssertionError(f"{tag}: no batch of {DP['batches']} fits: {preds}")
    why = ("it fits" if B == DP["batches"][0] else
           f"the dry run puts {DP['batches'][0]} x {S} at "
           f"{preds[DP['batches'][0]] / 1e9:.1f} GB, above 80 GB; {B} x {S} is the largest "
           f"of {DP['batches'][1:]} that fits")
    log(f"{tag}: batch {B} x {S}: {why}")
    batch = to_device(SyntheticStream(cfg, DataShard(0, 1, B), S).batch_at(0), dev)

    # the reference: one build_train_step step without remat, same batch
    ref_opts = TS.StepOptions(remat="none", ce_chunk=DP["ce_chunk"], opt=opt)
    ref_step = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, None, B, ref_opts), ref_opts)
    ref_loss = float(ref_step(TS.make_train_state(cfg, 0, device=dev), batch)[1]["loss"])
    del ref_step
    gc.collect()
    torch.cuda.empty_cache()

    runs = {}
    for compress in (False, True):
        name = "int8" if compress else "plain"
        step, init_err = TS.make_dp_train_step(cfg, mesh, opt, compress, DP["ce_chunk"])
        state = TS.make_train_state(cfg, 0, device=dev)
        err = init_err(state["params"])
        leaves = T.leaves(state["params"])
        param_bytes = sum(t.numel() * t.element_size() for t in leaves)
        if any(t.device != torch.device(dev) for t in leaves + T.leaves(err) + list(batch.values())):
            raise AssertionError(f"{tag}: a tensor of the DP step is off the card")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        rec = compat.CollectiveRecorder()
        losses, ms = [], []
        for s in range(DP["steps"]):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            if s == 0:
                with rec:
                    state, err, m = step(state, err, batch)
            else:
                state, err, m = step(state, err, batch)
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
            losses.append(float(m["loss"]))
        peak = torch.cuda.max_memory_allocated(dev)
        coll = R.collective_bytes(rec.collectives)
        ar = coll["all-reduce"]
        if ar["count"] != len(leaves) + 1 or ar["result_bytes"] != param_bytes + 4 or \
                any(v["count"] for k, v in coll.items() if k != "all-reduce"):
            raise AssertionError(f"{tag}[{name}]: collectives {coll}, expected "
                                 f"{len(leaves) + 1} all-reduces of {param_bytes + 4} bytes")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"{tag}[{name}]: non-finite losses {losses}")
        if abs(losses[0] - ref_loss) > DP["loss_rtol"] * abs(ref_loss):
            raise AssertionError(f"{tag}[{name}]: step-0 loss {losses[0]!r} against "
                                 f"build_train_step's {ref_loss!r}, rtol {DP['loss_rtol']}")
        step_ms = float(np.median(ms[1:]))
        log(f"{tag}[{name}]: {DP['steps']} steps of {B} x {S}, losses "
            + ", ".join(f"{x:.4f}" for x in losses)
            + f"; step-0 loss {losses[0]!r} = build_train_step's {ref_loss!r} (rtol "
            f"{DP['loss_rtol']}); CUDA events per step " + ", ".join(f"{x:.1f}" for x in ms)
            + f" ms, steps 1-{DP['steps'] - 1}: median {step_ms:.1f} ms, mean "
            f"{float(np.mean(ms[1:])):.1f} ms; peak memory "
            f"{peak / 1e9:.3f} GB (predicted {preds[B] / 1e9:.3f} GB with compression); "
            f"collectives per step: {ar['count']:.0f} all-reduces, {ar['result_bytes']:.0f} "
            f"result bytes, {ar['wire_bytes']:.0f} wire bytes (ring estimate)")
        runs[name] = {"losses": losses, "step_ms": step_ms, "event_ms": ms, "peak_bytes": peak,
                      "collectives": ar}
        del state, err, m, step, leaves
        gc.collect()
        torch.cuda.empty_cache()

    # the reduction's own device time, compressed and plain, over tensors
    # of the gradients' shapes (the parameters), as the step's loop runs it
    params = init_params(cfg, 0, dev)
    grads = T.leaves(params)
    errs = [torch.zeros_like(t) for t in grads]
    group, one = mesh.get_group(), torch.full((), 1.0, device=dev)

    def plain_pass():
        for g in grads:
            dist.all_reduce(g, group=group)
            g.div_(one)

    def int8_pass():
        for g, e in zip(grads, errs):
            e.copy_(C.compressed_psum(g, group, e)[1])

    pass_ms = {"plain": cuda_ms(plain_pass, iters=3, warmup=1),
               "int8": cuda_ms(int8_pass, iters=3, warmup=1)}
    del grads, errs
    gc.collect()
    torch.cuda.empty_cache()
    # a float32 gradient leaf, quantised on the card and on the CPU: the
    # first layer's wq (75.5 M elements: the CPU quantises it in seconds)
    w = params["layers"][0]["wq"].detach().requires_grad_(True)
    params["layers"][0]["wq"] = w
    with torch.enable_grad():
        loss, _ = M.loss_and_metrics(cfg, params, batch, M.ShardCtx(), DP["ce_chunk"])
        (g,) = torch.autograd.grad(loss, [w])
    del params, w, loss
    codes, scale = C.quantize(g)
    codes_cpu, scale_cpu = C.quantize(g.cpu())
    if not (torch.equal(codes.cpu(), codes_cpu) and torch.equal(scale.cpu(), scale_cpu)):
        raise AssertionError(f"{tag}: quantize of the gradient of layers[0].wq differs "
                             f"between the card and the CPU")
    back = C.dequantize(codes, scale, tuple(g.shape))
    per_elem = scale.expand(-1, C.BLOCK).reshape(-1)[:g.numel()].reshape(g.shape)
    ratio = float(((back - g).abs() / per_elem.clamp(min=1e-30)).max())
    if ratio > DP["quant_slack"]:
        raise AssertionError(f"{tag}: a quantisation error of {ratio:.4f} of its block's scale")
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"{tag}: port kernels launched on the DP path: {counts}")
    added = pass_ms["int8"] - pass_ms["plain"]
    log(f"{tag}: quantize of the float32 gradient of layers[0].wq "
        f"({g.numel():,} elements, {codes.shape[0]:,} blocks): codes and scales bitwise equal "
        f"on the card and on the CPU; largest error {ratio:.4f} of its block's scale; one "
        f"reduction of every gradient leaf takes {pass_ms['plain']:.1f} ms plain and "
        f"{pass_ms['int8']:.1f} ms int8 (CUDA events): compression adds {added:.1f} ms of "
        f"device time per step (step medians {runs['plain']['step_ms']:.1f} -> "
        f"{runs['int8']['step_ms']:.1f} ms); port kernel launches {counts}")
    del g, codes, scale, codes_cpu, scale_cpu, back, per_elem, batch
    return {"counts": counts, "batch": B, "seq": S, "why": why, "predicted_peak": preds[B],
            "runs": runs, "ref_loss": ref_loss, "quant_max_ratio": ratio,
            "reduce_pass_ms": pass_ms, "compress_added_ms": added}


# --------------------------------------------------------------------- main
# ------------------------------------------------------------- path L
def _stacked(parts):
    """Four virtual ranks' (acc, m, l) partials -> merged attention, by the
    model's own merge (models.model.merge_partials) over a stacked rank axis."""
    import torch

    from repro_torch.models import model as M

    acc, m, l = (torch.stack(t) for t in zip(*parts))
    return M.merge_partials(acc, m, l, lambda t: t.amax(0, keepdim=True),
                            lambda t: t.sum(0, keepdim=True))[0]


def _held(tag: str, what: str, got, want, rtol: float, atol: float) -> float:
    """Elementwise |got - want| <= atol + rtol |want|, else raise; -> max abs diff."""
    err = (got.float() - want.float()).abs()
    if bool((err > atol + rtol * want.float().abs()).any()):
        raise AssertionError(f"{tag}: {what} beyond rtol {rtol} atol {atol}: max abs diff "
                             f"{float(err.max()):.4g}")
    return float(err.max())


def _device_ms(fn) -> float:
    """Device ms of one call (torch.profiler), or nan where none was recorded."""
    by_kernel, _, _ = profiled(fn, 1)
    return sum(ms for ms, _ in by_kernel.values()) if by_kernel else float("nan")


def _one_period(arch: str, dev):
    """``arch``'s published config and the bf16 compute weights of one
    period (its first layers), drawn from SEED on the card."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params

    cfg = configs.get_config(arch)
    one = dataclasses.replace(cfg, n_layers=cfg.period)
    layers = M.compute_params(one, init_params(one, SEED, dev))["layers"]
    return cfg, [{k: v[0] for k, v in layer.items()} for layer in layers]


def _bf16(dev, gen, *shape, scale=1.0):
    import torch

    return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)


def seq_parallel_model(dev, ranks: int = 1) -> dict:
    """Path L-a: SEQ_PAR["arch"] at its published width (random weights from
    SEED), SEQ_PAR["batch"] prompts of SEQ_PAR["prompt_len"] tokens and
    SEQ_PAR["max_new"] greedy tokens, run (a) on one device, prefill through
    the flash kernel; (b) the same with attention through the plain version,
    teacher-forced with (a)'s tokens: the baseline of the card's bf16
    arithmetic; (c) on a (1, ``ranks``) mesh over the open process group
    (every rank runs this) with seq_shard, prefill and decode through the
    sharded bodies, teacher-forced alike.  (c)'s logits (prefill's last
    position, every decode step) may not differ from (a)'s by more than
    (b)'s largest difference + SEQ_TOL; its
    own greedy choices are compared with (a)'s tokens.  Then hidden_states
    at SEQ_PAR["hidden_seq"] with and without the mesh, within SEQ_TOL.
    Times (CUDA events), mfu, peaks and the collectives per step."""
    import torch

    from repro_torch import compat, configs
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref
    from repro_torch.launch import roofline as R
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as M
    from repro_torch.models.common import init_params

    gc.collect()
    torch.cuda.empty_cache()
    arch, B, S, n_new = (SEQ_PAR[k] for k in ("arch", "batch", "prompt_len", "max_new"))
    tag = f"seq_parallel[{arch}]"
    cfg = configs.get_config(arch)
    V = cfg.vocab
    params = M.compute_params(cfg, init_params(cfg, SEED, dev))  # the float32 masters go
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, V, (B, S), generator=gen, device=dev, dtype=torch.int32)
    max_seq = S + n_new
    mesh = compat.make_mesh((1, ranks), ("data", "model"), device=dev)
    meshed = TS.make_shard_ctx(cfg, mesh, B, TS.StepOptions(seq_shard=True))
    one = M.ShardCtx()
    if ranks > 1:
        tag += f" rank {meshed.model_rank} of {ranks}"

    def run(ctx, forced=None):
        """-> (logits (B, 1 + n_new, V) on the host, own greedy tokens, decode ms/step, peak)."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        logits, cache = M.prefill(cfg, params, {"tokens": toks}, ctx, max_seq=max_seq)
        outs, own = [logits[:, -1, :V].float().cpu()], [logits[:, -1, :V].argmax(-1)]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n_new):
            feed = (own[-1] if forced is None else forced[:, i].to(dev))[:, None].to(torch.int32)
            logits, cache = M.decode_step(cfg, params, cache, feed, ctx)
            outs.append(logits[:, 0, :V].float().cpu())
            own.append(logits[:, 0, :V].argmax(-1))
        end.record()
        end.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        del cache, logits
        return (torch.stack(outs, 1), torch.stack(own, 1).cpu(), start.elapsed_time(end) / n_new,
                peak)

    flash_before = read_counts()["flash_attention"]
    la, ta, dec_a, peak_a = run(one)
    flash_run = read_counts()["flash_attention"] - flash_before
    if flash_run != cfg.n_layers:
        raise AssertionError(f"{tag}: the unsharded prefill launched flash {flash_run} times, "
                             f"not once per layer ({cfg.n_layers})")
    kernel = ops._fa.flash_attention
    ops._fa.flash_attention = flash_attention_ref
    try:
        lb, _, _, _ = run(one, forced=ta)
    finally:
        ops._fa.flash_attention = kernel
    before = read_counts()
    lc, tc, dec_c, peak_c = run(meshed, forced=ta)
    if read_counts() != before:
        raise AssertionError(f"{tag}: the meshed run launched a port kernel: {read_counts()}")
    for name, lg in (("unsharded", la), ("plain", lb), ("meshed", lc)):
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{tag}: non-finite logits in the {name} run")
    base = float((lb - la).abs().max())
    err = float((lc - la).abs().max())
    if err > base + SEQ_TOL:
        raise AssertionError(f"{tag}: meshed vs one-device logits max abs diff {err:.4g} exceeds "
                             f"the plain-attention baseline {base:.4g} by more than {SEQ_TOL}")
    differ = (tc != ta).any(0)
    first = int(differ.float().argmax()) if bool(differ.any()) else None
    by_step = (lc - la).abs().amax(dim=(0, 2))
    log(f"{tag}: full width ({cfg.n_params():,} parameters), {B} x {S} prompt tokens (window "
        f"{cfg.window}), {n_new} greedy steps; (a) one device, flash in prefill ({flash_run} "
        f"launches), (b) plain attention, (c) a (1, {ranks}) mesh with seq_shard, sharded "
        f"prefill and decode (no port kernel), (b) and (c) fed (a)'s tokens: logits (prefill's "
        f"last position and {n_new} steps) (c) vs (a) max abs diff {err:.4g} (largest at step "
        f"{int(by_step.argmax())}; prefill {float(by_step[0]):.4g}), (b) vs (a) {base:.4g}: held "
        f"within the baseline + {SEQ_TOL}; (c)'s greedy choices "
        + ("all equal to (a)'s" if first is None else
           f"first differ from (a)'s at step {first} ({int(differ.sum())} of {n_new + 1} steps)")
        + f"; largest logit {float(la.abs().max()):.4g}")
    del la, lb, lc

    prefill_ms = {}
    for name, ctx in (("one_device", one), ("meshed", meshed)):
        prefill_ms[name] = cuda_ms(lambda ctx=ctx: M.prefill(cfg, params, {"tokens": toks}, ctx,
                                                             max_seq=max_seq), iters=2, warmup=1)
    rec = compat.CollectiveRecorder()
    with rec:
        _, cache = M.prefill(cfg, params, {"tokens": toks}, meshed, max_seq=max_seq)
    coll_prefill = R.collective_bytes(rec.collectives)
    rec = compat.CollectiveRecorder()
    with rec:
        M.decode_step(cfg, params, cache, toks[:, :1], meshed)
    coll_decode = R.collective_bytes(rec.collectives)
    del cache
    hs = SEQ_PAR["hidden_seq"]
    rows = slice(meshed.model_rank * hs // ranks, (meshed.model_rank + 1) * hs // ranks)
    h1 = M.hidden_states(cfg, params, {"tokens": toks[:, :hs]})[:, rows]
    h2 = M.hidden_states(cfg, params, {"tokens": toks[:, :hs]}, meshed)  # the rank's rows
    h_err = _held(tag, f"hidden_states at {B} x {hs}, mesh vs one device", h2, h1, SEQ_TOL, SEQ_TOL)
    h_equal = bool(torch.equal(h1, h2))
    del h1, h2
    out = {"ranks": ranks, "max_abs_diff": err, "baseline_max_abs_diff": base,
           "first_divergence": first,
           "hidden_max_abs_diff": h_err, "hidden_bitwise_equal": h_equal,
           "flash_launches": flash_run, "collectives": {"prefill": coll_prefill,
                                                        "decode_step": coll_decode}}
    for name, dec, peak in (("one_device", dec_a, peak_a), ("meshed", dec_c, peak_c)):
        out[name] = {"prefill_ms": prefill_ms[name], "decode_ms": dec, "peak_bytes": peak,
                     "prefill_mfu": R.mfu(cfg, "prefill", B, S, prefill_ms[name] / 1e3),
                     "decode_mfu": R.mfu(cfg, "decode", B, S, dec / 1e3)}
        o = out[name]
        log(f"{tag}: {name}: prefill {o['prefill_ms']:.2f} ms per wave of {B} x {S} (mfu "
            f"{o['prefill_mfu']:.4f}), decode {dec:.2f} ms per step (mfu {o['decode_mfu']:.5f}), "
            f"peak memory {peak / 1e9:.3f} GB")
    for what, coll in (("prefill", coll_prefill), ("decode step", coll_decode)):
        log(f"{tag}: meshed {what} collectives (roofline.collective_bytes): " + ", ".join(
            f"{op} {int(c['count'])} ({c['result_bytes'] / 1e6:.2f} MB)"
            for op, c in coll.items() if c["count"]))
    log(f"{tag}: hidden_states at {B} x {hs}, mesh vs one device: max abs diff {h_err:.4g} "
        f"(within {SEQ_TOL}), bitwise equal {h_equal}")
    del params
    return out


def seq_parallel_bodies(dev) -> dict:
    """Path L-b: each sharded body at full width, one layer's bf16 weights
    from SEED, composed for SEQ_BODIES["ranks"] virtual ranks in one process
    with the model's own local functions and merge code, held against the
    unsharded function on the same inputs (elementwise within rtol = atol =
    SEQ_TOL in bf16; Mamba's float32 state within rtol 1e-3, atol 1e-4 of
    its largest element), and the device time (torch.profiler) of the
    four ranks' bodies beside the unsharded call's:

      (i)   the Mamba mixer, four shards each scanning with the scan kernel
            from h0 = 0, against mamba_prefill's output and state on both
            of its scan routes (the kernel; the chunked plain scan); the
            staging kernel at each shard's shape bitwise against
            mamba_stage_ref on the shard's own inputs, and the scan kernel
            against mamba_scan_ref on the shard's own a, b and C; the
            launches held against their wrappers' counters (profiled);
      (ii)  decode attention of a local and a global layer at positions
            after the prompt, over a cache split four ways, against
            _attn_decode, and the cache blocks after it;
      (iii) MLA's sequence-parallel prefill attention against
            layers.attention, and its sharded decode against _mla_decode;
      (iv)  the MoE layer as four ranks of E/4 experts, summed in rank
            order, against moe_block(ep=None)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import mamba_scan as ms_mod
    from repro_torch.kernels import mamba_stage as mst_mod
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import mamba_scan_ref, mamba_stage_ref
    from repro_torch.models import layers as L
    from repro_torch.models import mamba as MB
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE

    n = SEQ_BODIES["ranks"]
    out = {}
    gen = torch.Generator(device=dev).manual_seed(SEED)

    # (i) the Mamba mixer
    gc.collect()
    torch.cuda.empty_cache()
    arch, B, S = SEQ_BODIES["mamba"]
    tag = f"seq_parallel[{arch} mixer]"
    cfg, (p,) = _one_period(arch, dev)
    K, S_loc, chunk = cfg.ssm_d_conv, S // n, 128
    u = _bf16(dev, gen, B, S, cfg.d_model)

    def mixer():
        xs, zs = zip(*((u[:, r * S_loc:(r + 1) * S_loc] @ p["in_proj"]).chunk(2, dim=-1)
                       for r in range(n)))
        tails = [x[:, -(K - 1):] for x in xs]
        parts = [MB.seq_shard_scan(p, xs[r], tails[r - 1] if r else torch.zeros_like(tails[0]),
                                   cfg, chunk, kernel=True) for r in range(n)]
        pairs = [part[-1] for part in parts]
        y = torch.cat([MB.seq_shard_output(p, parts[r][0], zs[r], *parts[r][1:5],
                                           MB.prefix_state(pairs, r), chunk, u.dtype)
                       for r in range(n)], dim=1)
        return y, MB.prefix_state(pairs, n), tails[-1]

    before = read_counts()
    y, h, conv = mixer()
    for name in ("mamba_scan", "mamba_stage"):
        if read_counts()[name] - before[name] != n:
            raise AssertionError(f"{tag}: {n} shards launched {name} "
                                 f"{read_counts()[name] - before[name]} times")
    errs = {}
    # against the unsharded mixer on both scan routes: the kernel's, and the
    # chunked plain scan's, which runs no kernel
    for route, c in (("kernel", None), ("plain", chunk)):
        want_y, want = MB.mamba_prefill(p, u, cfg, chunk=c)
        h_top = float(want["h"].abs().max())
        errs[route] = (_held(tag, f"y ({route} mamba_prefill)", y, want_y, SEQ_TOL, SEQ_TOL),
                       _held(tag, f"final state ({route} mamba_prefill)", h, want["h"], 1e-3,
                             1e-4 * h_top))
        if not torch.equal(conv, want["conv"]):
            raise AssertionError(f"{tag}: the conv state differs from mamba_prefill's")
        del want_y, want
    del y, h, conv
    # each shard's staging and scan at the shape this path gives the
    # kernels, on the shard's own inputs, against the plain versions (the
    # staging bitwise, as phase_stage holds it; the scan within SCAN_TOL,
    # h_last bitwise, as phase_scan holds it); these launches are not the path's
    counted = ms_mod.launches, mst_mod.launches
    scan_err = 0.0
    xs = [(u[:, r * S_loc:(r + 1) * S_loc] @ p["in_proj"]).chunk(2, dim=-1)[0] for r in range(n)]
    for r in range(n):
        left = xs[r - 1][:, -(K - 1):] if r else torch.zeros_like(xs[0][:, :K - 1])
        xc = L.silu(MB.causal_conv1d(xs[r], p["conv_w"], p["conv_b"], left))
        dt, Bm, Cm, A = MB._project(p, xc, cfg)
        a, b = ops.mamba_stage(dt, xc, Bm, A)
        stage_equal(f"{tag}: shard {r} staging", (a, b), mamba_stage_ref(dt, xc, Bm, A))
        y_k, h_k = ops.mamba_scan(a, b, Cm.float())
        y_p, h_p = mamba_scan_ref(a, b, Cm.float())
        scan_err = max(scan_err, _held(tag, f"shard {r} scan y {tuple(a.shape)}", y_k, y_p,
                                       SCAN_TOL, SCAN_TOL))
        if not torch.equal(h_k, h_p):
            raise AssertionError(f"{tag}: shard {r}'s h_last differs from the plain scan's")
        del a, b, y_k, h_k, y_p, h_p
    ms_mod.launches, mst_mod.launches = counted
    shard_shape = (B, S_loc, cfg.d_inner, cfg.ssm_d_state)
    del xs
    ms, ref_ms = _device_ms(mixer), _device_ms(lambda: MB.mamba_prefill(p, u, cfg))
    (y_err, h_err), (y_plain, h_plain) = errs["kernel"], errs["plain"]
    out["mamba"] = {"max_abs_diff": y_err, "state_max_abs_diff": h_err,
                    "plain_route_max_abs_diff": y_plain, "plain_route_state_max_abs_diff": h_plain,
                    "shard_scan_max_abs_err": scan_err, "shard_scan_shape": shard_shape,
                    "device_ms": ms, "unsharded_device_ms": ref_ms, "scan_launches_per_call": n}
    log(f"{tag}: d {cfg.d_model}, d_inner {cfg.d_inner}, {B} x {S} tokens as {n} shards of "
        f"{S_loc}, each scanned by the kernel from h0 = 0 ({n} launches, the profiler's count "
        f"equal to the wrapper's): y within rtol = atol = {SEQ_TOL} of mamba_prefill through "
        f"the kernel (max abs diff {y_err:.4g}) and through the chunked plain scan ({y_plain:.4g}), "
        f"the prefix-combined state within rtol 1e-3, atol 1e-4 of its largest element (max abs "
        f"diff {h_err:.4g} and {h_plain:.4g}), the conv state bitwise; each shard's staging "
        f"kernel at {shard_shape} bitwise equal to mamba_stage_ref, its kernel scan "
        f"at {shard_shape} within rtol = atol = {SCAN_TOL} of mamba_scan_ref on the same a, b "
        f"and C (max abs err {scan_err:.3g}, h_last bitwise); device {ms:.3f} ms for the {n} "
        f"shards against {ref_ms:.3f} ms unsharded")
    del p, u

    # (ii) decode attention, a local and a global layer
    gc.collect()
    torch.cuda.empty_cache()
    arch, B, S, steps = SEQ_BODIES["decode"]
    cfg, layers = _one_period(arch, dev)
    out["decode"] = {}
    for spec, p in zip(cfg.layout, layers):
        tag = f"seq_parallel[{arch} {spec.mixer} decode]"
        Sc = M._cache_len(cfg, spec, S + steps)
        kpos = torch.full((Sc,), -1, dtype=torch.int32, device=dev)
        past = torch.arange(max(0, S - Sc), S, device=dev, dtype=torch.int32)
        kpos[past % Sc] = past
        full = {"k": _bf16(dev, gen, B, Sc, cfg.n_kv_heads, cfg.head_dim),
                "v": _bf16(dev, gen, B, Sc, cfg.n_kv_heads, cfg.head_dim), "kpos": kpos}
        blocks = [{k: (t[r * Sc // n:(r + 1) * Sc // n] if k == "kpos" else
                       t[:, r * Sc // n:(r + 1) * Sc // n]).clone() for k, t in full.items()}
                  for r in range(n)]

        def step(pos, h, p=p, spec=spec, blocks=blocks):
            cos, sin = M._rope_cos_sin(cfg, torch.full((B, 1), pos, device=dev))
            q, k, v = M._qkv(cfg, p, h, cos, sin)
            merged = _stacked([M.attn_decode_partial(cfg, spec, q, k, v, blocks[r], pos, r, n)
                               for r in range(n)])
            return M._heads_out(merged, h.dtype) @ p["wo"], cos, sin

        err = 0.0
        for pos in range(S, S + steps):
            h = _bf16(dev, gen, B, 1, cfg.d_model)
            got, cos, sin = step(pos, h)
            want = M._attn_decode(cfg, spec, p, h, full, pos, cos, sin)
            err = max(err, _held(tag, f"position {pos}", got, want, SEQ_TOL, SEQ_TOL))
        for r in range(n):
            for k, t in full.items():
                blk = t[r * Sc // n:(r + 1) * Sc // n] if k == "kpos" else \
                    t[:, r * Sc // n:(r + 1) * Sc // n]
                if not torch.equal(blocks[r][k], blk):
                    raise AssertionError(f"{tag}: rank {r}'s {k} block differs from the cache's")
        last = S + steps - 1
        ms = _device_ms(lambda: step(last, h))
        cos, sin = M._rope_cos_sin(cfg, torch.full((B, 1), last, device=dev))
        ref_ms = _device_ms(lambda: M._attn_decode(cfg, spec, p, h, full, last, cos, sin))
        out["decode"][spec.mixer] = {"max_abs_diff": err, "slots": Sc, "device_ms": ms,
                                     "unsharded_device_ms": ref_ms}
        log(f"{tag}: {B} sequences, positions {S}-{last} (ring slots {S % Sc}-{last % Sc} of "
            f"{Sc}), the cache split {n} ways ({Sc // n} slots each): within rtol = atol = "
            f"{SEQ_TOL} of _attn_decode (max abs diff {err:.4g}), each rank's block the cache's; "
            f"device {ms:.3f} ms for the {n} ranks and the merge against {ref_ms:.3f} ms")
        del full, blocks
    del layers

    # (iii) MLA: sequence-parallel prefill attention, sharded decode
    gc.collect()
    torch.cuda.empty_cache()
    arch, B, S, steps = SEQ_BODIES["mla"]
    tag = f"seq_parallel[{arch} MLA]"
    cfg, (p,) = _one_period(arch, dev)
    h = _bf16(dev, gen, B, S, cfg.d_model)
    cos, sin = M._rope_cos_sin(cfg, M._positions(cfg, {}, B, S, device=dev))
    q, k, v, ckv, k_rope = M._mla_qkv(cfg, p, h, cos, sin)
    S_loc = S // n
    kw = dict(causal=cfg.causal, window=0, cap=cfg.attn_softcap, scale=M._mla_scale(cfg))
    kb, vb = list(k.split(S_loc, dim=1)), list(v.split(S_loc, dim=1))

    def prefill_attention():
        return torch.cat([M.seq_attention_local(q[:, r * S_loc:(r + 1) * S_loc], kb, vb, r, **kw)[0]
                          for r in range(n)], dim=1)

    want_attn = L.attention(q, k, v, **kw)
    a_err = _held(tag, "prefill attention", prefill_attention(), want_attn, SEQ_TOL, SEQ_TOL)
    a_ms, a_ref = _device_ms(prefill_attention), _device_ms(lambda: L.attention(q, k, v, **kw))
    max_seq = S + steps
    full = {name: F.pad(t, (0, 0, 0, steps))  # the latent cache, zero slots for the steps
            for name, t in (("ckv", ckv), ("krope", k_rope[:, :, 0]))}
    blocks = [{name: t[:, r * max_seq // n:(r + 1) * max_seq // n].clone()
               for name, t in full.items()} for r in range(n)]

    def mla_step(pos, x):
        cs, sn = M._rope_cos_sin(cfg, torch.full((B, 1), pos, device=dev))
        q_eff, q_rope, c_new, k_new = M.mla_decode_query(cfg, p, x, cs, sn)
        lat = _stacked([M.mla_decode_partial(cfg, q_eff, q_rope, c_new, k_new, blocks[r], pos, r)
                        for r in range(n)]).transpose(1, 2)
        return M.mla_latent_out(cfg, p, lat, x.dtype), cs, sn

    d_err = 0.0
    for pos in range(S, S + steps):
        x = _bf16(dev, gen, B, 1, cfg.d_model)
        got, cs, sn = mla_step(pos, x)
        want = M._mla_decode(cfg, p, x, full, pos, cs, sn)
        d_err = max(d_err, _held(tag, f"decode at position {pos}", got, want, SEQ_TOL, SEQ_TOL))
    d_ms = _device_ms(lambda: mla_step(S + steps - 1, x))
    d_ref = _device_ms(lambda: M._mla_decode(cfg, p, x, full, S + steps - 1, cs, sn))
    out["mla"] = {"prefill_max_abs_diff": a_err, "prefill_device_ms": a_ms,
                  "prefill_unsharded_device_ms": a_ref, "decode_max_abs_diff": d_err,
                  "decode_device_ms": d_ms, "decode_unsharded_device_ms": d_ref}
    log(f"{tag}: prefill attention at {B} x {S} (H {cfg.n_heads}, qk "
        f"{cfg.qk_nope_dim + cfg.qk_rope_dim}, v {cfg.v_head_dim}) as {n} query shards with "
        f"offsets against layers.attention: max abs diff {a_err:.4g}, device {a_ms:.3f} ms "
        f"against {a_ref:.3f} ms; {steps} decode steps at positions {S}-{S + steps - 1} over the "
        f"latent cache split {n} ways against _mla_decode: max abs diff {d_err:.4g}, device "
        f"{d_ms:.3f} ms for the {n} ranks and the merge against {d_ref:.3f} ms; both within "
        f"rtol = atol = {SEQ_TOL}")
    del p, h, q, k, v, ckv, k_rope, kb, vb, full, blocks, want_attn

    # (iv) the MoE layer, experts over four ranks
    gc.collect()
    torch.cuda.empty_cache()
    arch, B, S = SEQ_BODIES["moe"]
    tag = f"seq_parallel[{arch} MoE]"
    cfg, (p,) = _one_period(arch, dev)
    E, e_loc = cfg.moe_experts, cfg.moe_experts // n
    x = _bf16(dev, gen, B, S, cfg.d_model)
    ranks = [{"router": p["router"],
              **{k: p[k][r * e_loc:(r + 1) * e_loc] for k in MOE.EXPERT_KEYS}} for r in range(n)]

    def experts():
        total = MOE.moe_local(ranks[0], x, cfg, 0)
        for r in range(1, n):
            total = total + MOE.moe_local(ranks[r], x, cfg, r * e_loc)
        return total

    want = MOE.moe_block({k: p[k] for k in MOE.KEYS}, x, cfg)
    err = _held(tag, "output", experts(), want, SEQ_TOL, SEQ_TOL)
    ms = _device_ms(experts)
    ref_ms = _device_ms(lambda: MOE.moe_block({k: p[k] for k in MOE.KEYS}, x, cfg))
    n_moe = sum(p[k].numel() for k in MOE.KEYS)
    out["moe"] = {"max_abs_diff": err, "device_ms": ms, "unsharded_device_ms": ref_ms,
                  "parameters": n_moe}
    log(f"{tag}: {E} experts top-{cfg.moe_topk}, d {cfg.d_model}, dff {cfg.moe_dff} "
        f"({n_moe:,} parameters, {2 * n_moe / 1e9:.2f} GB bf16) on {B} x {S} tokens as {n} "
        f"ranks of {e_loc} experts summed in rank order: within rtol = atol = {SEQ_TOL} of "
        f"moe_block(ep=None) (max abs diff {err:.4g}); device {ms:.3f} ms for the {n} ranks "
        f"against {ref_ms:.3f} ms")
    del p, x, ranks, want
    return out


def _l_rank(rank: int, n: int, tmp: str) -> None:
    """One rank of ``seq_parallel_ranks``: its card, the NCCL process group,
    path L-a on a (1, n) mesh; its result as JSON."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=rank, world_size=n)
    try:
        out = seq_parallel_model(dev, ranks=n)
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def seq_parallel_ranks(n: int) -> list:
    """``python3 chip_smoke.py --l-ranks N``: path L-a with its meshed run on
    a (1, N) mesh across N cards of one host, one spawned process per card
    (NCCL); each rank also runs the one-device and plain baselines on its
    own card.  -> every rank's result."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_l_rank, args=(n, tmp), nprocs=n, start_method="spawn")
        results = []
        for r in range(n):
            with open(f"{tmp}/rank{r}.json") as f:
                results.append(json.load(f))
    return results


def phase_seq_parallel(dev) -> dict:
    """Path L (see the module docstring): L-a, then L-b; every count set to 0
    before and read after."""
    zero_counts()
    model = seq_parallel_model(dev)
    bodies = seq_parallel_bodies(dev)
    counts = read_counts()
    for name in ("flash_attention", "mamba_scan", "mamba_stage"):
        if counts[name] <= 0:
            raise AssertionError(f"path L never launched {name}: {counts}")
    return {"counts": counts, "model": model, "bodies": bodies}


# ------------------------------------------------------------- path M
def timed_steps(step_fn, state, batches):
    """One step per batch -> (state, losses, grad norms, CUDA-event ms,
    host ms around each synchronised step)."""
    import torch

    losses, gnorms, event_ms, host_ms = [], [], [], []
    for batch in batches:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        state, m = step_fn(state, batch)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return state, losses, gnorms, event_ms, host_ms


def mesh_path_inputs(dev):
    """Path E's configuration, options and batches (its stream, seed 0) on
    ``dev``."""
    from repro_torch import configs
    from repro_torch.data.pipeline import DataShard, SyntheticStream, to_device

    cfg = configs.get_config(TRAIN["arch"])
    B, S = TRAIN["global_batch"], TRAIN["seq"]
    stream = SyntheticStream(cfg, DataShard(0, 1, B), S, seed=0)
    return cfg, train_opts(), [to_device(stream.batch_at(s), dev) for s in range(TRAIN["steps"])]


def placed_state(cfg, mesh, opts, dev):
    """make_train_state(cfg, 0) on ``dev``, placed by train_state_shardings."""
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as TS

    state = TS.make_train_state(cfg, 0, device=dev)
    return SH.place(state, TS.train_state_shardings(cfg, state, mesh, opts))


def phase_mesh_train(dev, path_e: dict) -> dict:
    """Path M-a (see MESH_PARITY's comment): path E's run on a one-rank
    (1, 1) mesh, its state placed with fsdp; then the float32 meshed step
    with seq_shard of each MESH_PARITY config against the step without a
    mesh.  Counts set to 0 before and read after: no port kernel."""
    import torch

    from repro_torch import compat
    from repro_torch import tree as T
    from repro_torch.launch import sharding as SH
    from repro_torch.launch import steps as TS

    gc.collect()
    torch.cuda.empty_cache()
    tag = f"train_mesh[{TRAIN['arch']}]"
    cfg, opts, batches = mesh_path_inputs(dev)
    B, S, steps = TRAIN["global_batch"], TRAIN["seq"], TRAIN["steps"]
    mesh = compat.make_mesh((1, 1), ("data", "model"), device=dev)
    zero_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    state = placed_state(cfg, mesh, opts, dev)
    step_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, mesh, B, opts), opts)
    state, losses, gnorms, event_ms, host_ms = timed_steps(step_fn, state, batches)
    peak = torch.cuda.max_memory_allocated(dev)
    embed = state["params"]["embed"]
    placements = [str(p) for p in embed.placements]
    del state, step_fn
    e_losses = path_e["losses"]
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"{tag}: non-finite loss or grad norm: {losses} {gnorms}")
    if abs(losses[0] - e_losses[0]) > TRAIN_SOCKET["loss_rtol"] * abs(e_losses[0]):
        raise AssertionError(f"{tag}: step-0 loss {losses[0]!r} against path E's "
                             f"{e_losses[0]!r} (build_train_step without a mesh), rtol "
                             f"{TRAIN_SOCKET['loss_rtol']}")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, e_losses)]
    if max(rel) >= MESH_LOSS_RTOL:
        raise AssertionError(f"{tag}: losses {losses} against path E's {e_losses}")
    later_event, later_host = float(np.mean(event_ms[1:])), float(np.mean(host_ms[1:]))
    tok_per_s = B * S / (later_host / 1e3)
    log(f"{tag}: path E's run on a (1, 1) mesh (fsdp, embed placed {placements}), {steps} "
        f"steps of {B} x {S}: losses " + ", ".join(f"{x:.4f}" for x in losses)
        + f"; step-0 loss {losses[0]!r} vs path E's {e_losses[0]!r}; largest relative loss "
        f"difference from path E {max(rel):.3g}; grad norms "
        + ", ".join(f"{x:.4f}" for x in gnorms)
        + f"; steps 1-{steps - 1}: CUDA events {later_event:.1f} ms, host {later_host:.1f} ms "
        f"per step (path E: {path_e['step_ms']:.1f}, {path_e['step_host_ms']:.1f} ms), "
        f"{tok_per_s:.0f} tokens/s (path E {path_e['tok_per_s']:.0f}); peak memory "
        f"{peak / 1e9:.2f} GB (path E {path_e['peak_bytes'] / 1e9:.2f} GB)")
    gc.collect()
    torch.cuda.empty_cache()
    parity = {}  # TF32 is off for the whole run (phase_env's parity_mode)
    for arch in MESH_PARITY:
        cfg, batch = parity_inputs(arch)
        batch = {k: v.to(dev) for k, v in batch.items()}
        mopts = dataclasses.replace(opts, seq_shard=True)
        ref_state = TS.make_train_state(cfg, SEED, device=dev)
        before = {name: t.clone() for name, t in T.paths(ref_state["params"])}
        state = SH.place(T.map(torch.clone, ref_state),
                         TS.train_state_shardings(cfg, ref_state, mesh, mopts))
        ref_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, None, TRAIN_PARITY["batch"],
                                                             opts), opts)
        ctx = TS.make_shard_ctx(cfg, mesh, TRAIN_PARITY["batch"], mopts)
        if not ctx.for_pass(TRAIN_PARITY["batch"], TRAIN_PARITY["seq"]).seq_shard:
            raise AssertionError(f"{tag}: {arch}'s parity step is not sequence-sharded")
        ref_state, ref_m = ref_fn(ref_state, batch)
        state, m = TS.build_train_step(cfg, ctx, mopts)(state, batch)
        n_off, n_all, worst, lr = held_step(
            f"{tag}: {arch} meshed vs unmeshed", m, ref_m,
            [t.to_local() for t in T.leaves(state["params"])], ref_state["params"], before)
        parity[arch] = {"loss": float(m["loss"]), "ref_loss": float(ref_m["loss"]),
                        "grad_norm": float(m["grad_norm"]),
                        "ref_grad_norm": float(ref_m["grad_norm"]),
                        "params_beyond_tol": n_off, "params": n_all, "max_abs_diff": worst}
        log(f"{tag}: {arch} float32 (TF32 off), full width cut to {cfg.n_layers} layers "
            f"({cfg.n_params():,} parameters), {TRAIN_PARITY['batch']} x "
            f"{TRAIN_PARITY['seq']}, seq_shard on the (1, 1) mesh vs no mesh: loss "
            f"{float(m['loss']):.6f} vs {float(ref_m['loss']):.6f}, grad norm "
            f"{float(m['grad_norm']):.6f} vs {float(ref_m['grad_norm']):.6f}; params after "
            f"the step {n_off} of {n_all} beyond rtol {TRAIN_PARITY['params_rtol']} / atol "
            f"{TRAIN_PARITY['params_atol']}, max abs diff {worst:.3g} (lr {lr:.3g})")
        del state, ref_state, before
        gc.collect()
        torch.cuda.empty_cache()
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"{tag}: port kernels launched on path M: {counts}")
    return {"counts": counts, "losses": losses, "grad_norms": gnorms, "event_ms": event_ms,
            "host_ms": host_ms, "step_ms": later_event, "step_host_ms": later_host,
            "tok_per_s": tok_per_s, "peak_bytes": peak, "path_e_losses": e_losses,
            "max_rel_loss_diff": max(rel), "embed_placements": placements, "parity": parity}


def mesh_ranks_run(dev, n: int, ckdir: str) -> dict:
    """Path M-b on one of ``n`` ranks (the NCCL group initialised): path E's
    run on this rank's card without a mesh, then on a (2, n/2) mesh with
    fsdp and seq_shard, saved after step MESH_RANKS["save_after"], restored
    onto (1, n) from the files and stepped to the end again."""
    import shutil

    import torch
    import torch.distributed as dist

    from repro_torch import compat
    from repro_torch.checkpoint import ckpt as CK
    from repro_torch.launch import steps as TS

    tag = f"train_mesh_ranks[{TRAIN['arch']}, rank {dist.get_rank()} of {n}]"
    cfg, opts, batches = mesh_path_inputs(dev)
    B, k = TRAIN["global_batch"], MESH_RANKS["save_after"]
    torch.cuda.reset_peak_memory_stats(dev)
    state = TS.make_train_state(cfg, 0, device=dev)
    one_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, None, B, opts), opts)
    state, one_losses, _, one_ms, _ = timed_steps(one_fn, state, batches)
    one_peak = torch.cuda.max_memory_allocated(dev)
    del state, one_fn
    gc.collect()
    torch.cuda.empty_cache()

    mopts = dataclasses.replace(opts, seq_shard=True)
    mesh = compat.make_mesh((2, n // 2), ("data", "model"), device=dev)
    state = placed_state(cfg, mesh, mopts, dev)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    state_bytes = torch.cuda.memory_allocated(dev)
    step_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, mesh, B, mopts), mopts)
    state, losses, gnorms, ms, host = timed_steps(step_fn, state, batches[:k])
    os.makedirs(ckdir, exist_ok=True)
    free = shutil.disk_usage(ckdir).free
    t0 = time.perf_counter()
    CK.save(ckdir, k, state)
    save_s = time.perf_counter() - t0
    state, more, more_g, more_ms, more_host = timed_steps(step_fn, state, batches[k:])
    losses, gnorms, ms, host = losses + more, gnorms + more_g, ms + more_ms, host + more_host
    peak = torch.cuda.max_memory_allocated(dev)
    del state, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    mesh_b = compat.make_mesh((1, n), ("data", "model"), device=dev)
    target = TS.meta_train_state(cfg)
    t0 = time.perf_counter()
    step_at, state = CK.load(ckdir, target=target,
                             shardings=TS.train_state_shardings(cfg, target, mesh_b, mopts))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    step_b = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, mesh_b, B, mopts), mopts)
    state, resumed, _, resumed_ms, _ = timed_steps(step_b, state, batches[k:])
    del state, step_b
    off_one = max(abs(a - b) for a, b in zip(losses, one_losses))
    off_resumed = max(abs(a - b) for a, b in zip(resumed, losses[k:]))
    if step_at != k or not all(math.isfinite(x) for x in losses + resumed) or \
            off_one >= MESH_RANKS["loss_atol"] or off_resumed >= MESH_RANKS["loss_atol"]:
        raise AssertionError(f"{tag}: restored step {step_at}; losses {losses} on the mesh, "
                             f"{one_losses} on one device, {resumed} resumed on (1, {n})")
    log(f"{tag}: one device {', '.join(f'{x:.4f}' for x in one_losses)} "
        f"({float(np.mean(one_ms[1:])):.1f} ms/step, peak {one_peak / 1e9:.2f} GB); "
        f"(2, {n // 2}) mesh with fsdp and seq_shard {', '.join(f'{x:.4f}' for x in losses)} "
        f"(largest difference {off_one:.4g}; {float(np.mean(ms[1:])):.1f} ms/step CUDA events, "
        f"host {float(np.mean(host[1:])):.1f}; placed state {state_bytes / 1e9:.2f} GB, peak "
        f"{peak / 1e9:.2f} GB); saved after step {k} in {save_s:.1f} s ({free / 1e9:.0f} GB "
        f"free there), restored onto (1, {n}) in {load_s:.1f} s: steps {k}-{len(batches) - 1} "
        f"{', '.join(f'{x:.4f}' for x in resumed)} (largest difference {off_resumed:.4g}; "
        f"{float(np.mean(resumed_ms)):.1f} ms/step)")
    return {"rank": dist.get_rank(), "one_losses": one_losses, "one_peak": one_peak,
            "one_step_ms": float(np.mean(one_ms[1:])), "losses": losses, "grad_norms": gnorms,
            "step_ms": float(np.mean(ms[1:])), "step_host_ms": float(np.mean(host[1:])),
            "state_bytes": state_bytes, "peak": peak, "save_s": save_s, "load_s": load_s,
            "resumed": resumed, "resumed_step_ms": float(np.mean(resumed_ms)),
            "max_diff_one": off_one, "max_diff_resumed": off_resumed}


def _m_rank(rank: int, n: int, tmp: str) -> None:
    """One rank of ``mesh_ranks``: its card, the NCCL process group, path M-b;
    its result as JSON."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=rank, world_size=n)
    try:
        out = mesh_ranks_run(dev, n, os.path.join(tmp, "ck"))
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def mesh_ranks(n: int) -> list:
    """``python3 chip_smoke.py --m-ranks N``: path M-b across N cards of one
    host, one spawned process per card (NCCL); the checkpoint goes to a
    temporary directory.  -> every rank's result."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_m_rank, args=(n, tmp), nprocs=n, start_method="spawn")
        results = []
        for r in range(n):
            with open(f"{tmp}/rank{r}.json") as f:
                results.append(json.load(f))
    return results


# ------------------------------------------------------------- path N
_MESH_DRY_SCRIPT = r"""
import json, logging, sys, time
sys.path.insert(0, sys.argv[1])
logging.getLogger("torch.distributed.tensor._redistribute").setLevel(logging.ERROR)
from repro_torch.launch import dryrun as D

out = {}
for arch, shape, mesh in json.loads(sys.argv[2]):
    t0 = time.perf_counter()
    rec = D.run_cell(arch, shape, mesh, extrapolate_depth=True)
    rec.pop("counted", None)
    out[f"{arch} {shape} {mesh}"] = dict(rec, wall_s=time.perf_counter() - t0)
print(json.dumps(out))
"""


def mesh_dryrun() -> dict:
    """Path N-a(i): launch.dryrun.run_cell of each MESH_DRY cell on JAX's
    production mesh, rank 0 counted, in a child process that starts its own
    fake process group of 512 ranks (this process holds the NCCL group; the
    child sees no card).  Prefill and decode cells are counted at 1 and 2
    periods and extrapolated (``extrapolate_depth``: qwen3-moe's 48 layers
    of 32k-token chunked attention would take ~16 minutes of host time op
    by op).  -> {cell: record}."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _MESH_DRY_SCRIPT, str(ROOT / "src"),
                        json.dumps(MESH_DRY)], capture_output=True, text=True, timeout=600,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    if r.returncode != 0:
        raise AssertionError(f"mesh dry run: exit {r.returncode}: {r.stderr[-3000:]}")
    recs = json.loads(r.stdout.strip().splitlines()[-1])
    for (arch, shape, mesh), (cell, rec) in zip(MESH_DRY, recs.items()):
        tag = f"mesh_dryrun[{cell}]"
        m, c = rec.get("memory", {}), rec.get("cost", {})
        if rec["status"] != "ok" or rec["devices"] != {"single": 256, "multi": 512}[mesh] \
                or not c.get("flops", 0) > 0 or not rec["wire_bytes_per_device"] > 0 \
                or rec["collectives"]["all-gather"]["count"] <= 0:
            raise AssertionError(f"{tag}: {rec}")
        log(f"{tag}: rank 0 of {rec['devices']}: peak {m['peak_bytes'] / 1e9:.3f} GB per device "
            f"(arguments {m['argument_size_in_bytes'] / 1e9:.3f} GB, fits_80gb_hbm "
            f"{m['fits_80gb_hbm']}), flops {c['flops']:.4e}, bytes accessed "
            f"{c['bytes_accessed']:.4e}, wire bytes {rec['wire_bytes_per_device']:.4e} ("
            + ", ".join(f"{op} {int(v['count'])}" for op, v in rec["collectives"].items()
                        if v["count"])
            + f"), {rec['aten_ops']} aten ops, microbatch {rec.get('microbatch', 1)}, depth "
            + ("extrapolated from 1 and 2 periods" if rec["depth_extrapolated"] else "counted")
            + f"; in {rec['wall_s']:.1f} s")
    log(f"mesh_dryrun: {len(recs)} cells in {time.perf_counter() - t0:.1f} s")
    return recs


def tp_mamba_decode(dev) -> dict:
    """Path N-a(ii): one full-width falcon-mamba-7b layer (bf16 weights from
    SEED) after a TP_DECODE["prompt_len"]-token prefill of TP_DECODE["batch"]
    rows (mamba_prefill: the scan kernel), then TP_DECODE["steps"] decode
    steps run as TP_DECODE["ranks"] virtual ranks of the tensor-parallel
    decode (mamba_decode_tp_in and _out, their partials summed in rank order
    in float32 as mamba_decode_tp sums them) against mamba_decode on the
    whole state: each step's output and conv state within SEQ_TOL (bf16),
    the rank blocks of the float32 state within rtol SEQ_TOL, atol SEQ_TOL
    of its largest element (Δt is a bf16 value, which the ranks' float32
    sum rounds once where one device's GEMM rounds its own accumulation,
    and each step's state carries it); the device time of the four ranks'
    step beside the unsharded step's."""
    import torch

    from repro_torch.models import mamba as MB

    gc.collect()
    torch.cuda.empty_cache()
    arch, n, B, S, steps = (TP_DECODE[k] for k in ("arch", "ranks", "batch", "prompt_len", "steps"))
    tag = f"tp_mamba_decode[{arch}]"
    cfg, (p,) = _one_period(arch, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    _, state = MB.mamba_prefill(p, _bf16(dev, gen, B, S, cfg.d_model), cfg)
    blocks = [MB.channel_block(cfg, r, n) for r in range(n)]

    def split(st):
        return [{"h": st["h"][:, c].clone(), "conv": st["conv"][..., c].clone()} for c in blocks]

    def tp_step(u, states):
        parts = [MB.mamba_decode_tp_in(p, u, states[r], cfg, r, n) for r in range(n)]
        dbl = torch.stack([part[3] for part in parts]).sum(0).to(u.dtype)
        outs = [MB.mamba_decode_tp_out(p, *parts[r][:3], dbl, states[r], cfg, r, n)
                for r in range(n)]
        return torch.stack(outs).sum(0).to(u.dtype)[:, None]

    ranks = split(state)
    errs = {"y": 0.0, "h": 0.0, "conv": 0.0}
    for _ in range(steps):
        u = _bf16(dev, gen, B, 1, cfg.d_model)
        want, _ = MB.mamba_decode(p, u, state, cfg)
        got = tp_step(u, ranks)
        errs["y"] = max(errs["y"], _held(tag, "decode output", got, want, SEQ_TOL, SEQ_TOL))
    h_top = float(state["h"].abs().max())
    for r, c in enumerate(blocks):
        errs["h"] = max(errs["h"], _held(tag, f"rank {r}'s h", ranks[r]["h"], state["h"][:, c],
                                         SEQ_TOL, SEQ_TOL * h_top))
        errs["conv"] = max(errs["conv"], _held(tag, f"rank {r}'s conv", ranks[r]["conv"],
                                               state["conv"][..., c], SEQ_TOL, SEQ_TOL))
    u = _bf16(dev, gen, B, 1, cfg.d_model)
    scratch, scratch_ranks = {k: v.clone() for k, v in state.items()}, split(state)
    one_ms = _device_ms(lambda: MB.mamba_decode(p, u, scratch, cfg))
    tp_ms = _device_ms(lambda: tp_step(u, scratch_ranks))
    log(f"{tag}: one layer at full width (d_inner {cfg.d_inner}), {B} rows after a {S}-token "
        f"prefill, {steps} decode steps as {n} virtual ranks of {cfg.d_inner // n} channels: "
        f"output max abs diff {errs['y']:.4g} (within {SEQ_TOL}), h {errs['h']:.4g} (rtol "
        f"{SEQ_TOL}, atol {SEQ_TOL} x {h_top:.4g}), conv {errs['conv']:.4g}; device ms per step: "
        f"{n} ranks {tp_ms:.4f}, unsharded {one_ms:.4f}")
    del p, state, ranks, scratch, scratch_ranks
    return {"max_abs_diff": errs, "tp_device_ms": tp_ms, "one_device_ms": one_ms,
            "ranks": n, "batch": B, "prompt_len": S, "steps": steps}


def _local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor

    from repro_torch import tree as T

    return sum((t.to_local() if isinstance(t, DTensor) else t).untyped_storage().nbytes()
               for t in T.leaves(tree))


def mesh_serve_held(tag: str, cfg, dev, whole, placed, mesh) -> dict:
    """SERVE["batch"] prompts of SERVE["prompt_len"] tokens (from SEED) and
    SERVE["max_new"] greedy tokens: (a) one device on ``whole`` (prefill
    through the kernels), (b) the same with attention, the staging and the
    scan through their plain versions, fed (a)'s tokens (the card's bf16
    baseline), (c) on ``mesh`` with the ``placed`` weights, caches by
    cache_shardings' rule, fed (a)'s tokens.  (c)'s logits (prefill's last position and
    every step) may differ from (a)'s by (b)'s largest difference + SEQ_TOL
    at most.  -> the differences, (c)'s prefill ms per wave (CUDA events),
    decode ms per step, collectives per decode step and peak."""
    import torch

    from repro_torch import compat
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_attention_ref, mamba_scan_ref, mamba_stage_ref
    from repro_torch.launch import roofline as R
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as M

    B, S, n_new = SERVE["batch"], SERVE["prompt_len"], SERVE["max_new"]
    V = cfg.vocab
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, V, (B, S), generator=gen, device=dev, dtype=torch.int32)
    max_seq = S + n_new
    meshed = TS.make_shard_ctx(cfg, mesh, B, TS.StepOptions())

    def run(ctx, params, forced=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        logits, cache = M.prefill(cfg, params, {"tokens": toks}, ctx, max_seq=max_seq)
        outs, own = [logits[:, -1, :V].float().cpu()], [logits[:, -1, :V].argmax(-1)]
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n_new):
            feed = (own[-1] if forced is None else forced[:, i].to(dev))[:, None].to(torch.int32)
            logits, cache = M.decode_step(cfg, params, cache, feed, ctx)
            outs.append(logits[:, 0, :V].float().cpu())
            own.append(logits[:, 0, :V].argmax(-1))
        end.record()
        end.synchronize()
        peak = torch.cuda.max_memory_allocated(dev)
        return torch.stack(outs, 1), torch.stack(own, 1).cpu(), start.elapsed_time(end) / n_new, \
            peak, cache

    la, ta, dec_a, _, cache = run(M.ShardCtx(), whole)
    del cache
    kernels = ops._fa.flash_attention, ops._ms.mamba_scan, ops._mst.mamba_stage
    ops._fa.flash_attention, ops._ms.mamba_scan, ops._mst.mamba_stage = \
        flash_attention_ref, mamba_scan_ref, mamba_stage_ref
    try:
        lb, _, _, _, cache = run(M.ShardCtx(), whole, forced=ta)
    finally:
        ops._fa.flash_attention, ops._ms.mamba_scan, ops._mst.mamba_stage = kernels
    del cache
    lc, tc, dec_c, peak_c, cache = run(meshed, placed, forced=ta)
    for name, lg in (("one device", la), ("plain", lb), ("meshed", lc)):
        if not bool(torch.isfinite(lg).all()):
            raise AssertionError(f"{tag}: non-finite logits in the {name} run")
    base, err = float((lb - la).abs().max()), float((lc - la).abs().max())
    if err > base + SEQ_TOL:
        raise AssertionError(f"{tag}: meshed vs one-device logits max abs diff {err:.4g} exceeds "
                             f"the plain baseline {base:.4g} by more than {SEQ_TOL}")
    differ = (tc != ta).any(0)
    first = int(differ.float().argmax()) if bool(differ.any()) else None
    rec = compat.CollectiveRecorder()
    with rec:
        M.decode_step(cfg, placed, cache, toks[:, :1], meshed)
    coll = R.collective_bytes(rec.collectives)
    del cache
    prefill_ms = cuda_ms(lambda: M.prefill(cfg, placed, {"tokens": toks}, meshed,
                                           max_seq=max_seq), iters=2, warmup=1)
    log(f"{tag}: {B} x {S} prompt tokens, {n_new} steps; (c) on the mesh with placed weights vs "
        f"(a) one device: logits max abs diff {err:.4g}, (b) plain vs (a) {base:.4g}: held within "
        f"the baseline + {SEQ_TOL}; (c)'s greedy choices "
        + ("all equal to (a)'s" if first is None else
           f"first differ at step {first} ({int(differ.sum())} of {n_new + 1} steps)")
        + f"; meshed prefill {prefill_ms:.2f} ms per wave, decode {dec_c:.2f} ms per step (one "
        f"device {dec_a:.2f}), peak {peak_c / 1e9:.3f} GB; collectives per decode step: "
        + ", ".join(f"{op} {int(c['count'])} ({c['result_bytes'] / 1e9:.3f} GB)"
                    for op, c in coll.items() if c["count"]))
    return {"max_abs_diff": err, "baseline_max_abs_diff": base, "first_divergence": first,
            "prefill_ms": prefill_ms, "decode_ms": dec_c, "one_device_decode_ms": dec_a,
            "peak_bytes": peak_c, "decode_collectives": coll,
            "prefill_mfu": R.mfu(cfg, "prefill", B, S, prefill_ms / 1e3)}


def serve_on_mesh(dev, cfg, mesh, tag: str) -> dict:
    """launch.serve.serve of ``cfg`` on ``mesh`` with SERVE's traffic, the
    weights built placed from SEED leaf by leaf (placed_compute_params);
    -> the run's tok/s, the weights' and peak bytes a rank holds, and its
    placed weights (for the caller's checks)."""
    import torch

    from repro_torch.launch import sharding as SH
    from repro_torch.launch.serve import serve

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    placed = SH.placed_compute_params(cfg, SEED, mesh, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    param_bytes = _local_bytes(placed)
    build_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = serve(arch=cfg.name, config=cfg, mesh=mesh, params=placed, seed=SEED, device=dev,
                **SERVE)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    if out["requests"] != SERVE["n_requests"] or \
            out["tokens"] != SERVE["n_requests"] * SERVE["max_new"]:
        raise AssertionError(f"{tag}: {out['requests']} requests, {out['tokens']} tokens")
    log(f"{tag}: {cfg.n_layers} layers at published width ({cfg.n_params():,} parameters), "
        f"weights placed leaf by leaf in {build_s:.1f} s: {param_bytes / 1e9:.3f} GB a rank "
        f"(build peak {build_peak / 1e9:.3f} GB); {out['requests']} requests, {out['tokens']} "
        f"tokens in {serve_s:.2f} s, {out['tok_per_s']:.1f} tok/s; peak {peak / 1e9:.3f} GB")
    return {"tok_per_s": out["tok_per_s"], "serve_s": serve_s, "param_bytes": param_bytes,
            "build_s": build_s, "build_peak_bytes": build_peak, "peak_bytes": peak,
            "placed": placed}


def phase_mesh_serve(dev) -> dict:
    """Path N-a (see MESH_DRY's comment): (i) the meshed dry run, (ii) the
    tensor-parallel Mamba decode as virtual ranks, (iii) SERVE_MESH cut to
    one period served on a one-rank (1, 1) NCCL mesh and held against the
    same weights unplaced; every count set to 0 before and read after."""
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch import compat, configs
    from repro_torch import tree as T

    zero_counts()
    dry = mesh_dryrun()
    tp = tp_mamba_decode(dev)
    cfg = configs.get_config(SERVE_MESH)
    one = dataclasses.replace(cfg, n_layers=cfg.period)
    tag = f"serve_mesh[{SERVE_MESH}, one period]"
    mesh = compat.make_mesh((1, 1), ("data", "model"), device=dev)
    served = serve_on_mesh(dev, one, mesh, tag)
    placed = served.pop("placed")
    # on one rank each block is its whole leaf: the same weights, unplaced
    whole = T.map(lambda t: t.to_local() if isinstance(t, DTensor) else t, placed)
    held = mesh_serve_held(tag, one, dev, whole, placed, mesh)
    del placed, whole
    gc.collect()
    torch.cuda.empty_cache()
    counts = read_counts()
    for name in ("flash_attention", "mamba_scan", "mamba_stage"):
        if counts[name] <= 0:
            raise AssertionError(f"path N never launched {name}: {counts}")
    return {"counts": counts, "dryrun": dry, "tp_decode": tp, "serve": served, "held": held}


def mesh_serve_rank(dev, n: int) -> dict:
    """Path N-b on one of ``n`` ranks (the NCCL group initialised): SERVE_MESH
    cut to one period on (1, n) held against one device (the whole weights
    built leaf by leaf on this rank's card); then each of MESH_SERVE_ARCHS
    at full depth and width served on (1, n) (experts split over the model
    axis), with its prefill ms per wave, decode ms per step and collectives
    per decode step."""
    import torch
    import torch.distributed as dist

    from repro_torch import compat, configs
    from repro_torch.launch import sharding as SH

    rank = dist.get_rank()
    mesh = compat.make_mesh((1, n), ("data", "model"), device=dev)
    cfg = configs.get_config(SERVE_MESH)
    one = dataclasses.replace(cfg, n_layers=cfg.period)
    tag = f"serve_mesh_ranks[{SERVE_MESH}, one period, rank {rank} of {n}]"
    served = serve_on_mesh(dev, one, mesh, tag)
    placed = served.pop("placed")
    whole = SH.placed_compute_params(one, SEED, None, device=dev)  # whole, leaf by leaf
    out = {"rank": rank, "one_period": {**served, **mesh_serve_held(tag, one, dev, whole, placed,
                                                                   mesh)}}
    del placed, whole
    for arch in MESH_SERVE_ARCHS:
        tag = f"serve_mesh_ranks[{arch}, rank {rank} of {n}]"
        cfg = configs.get_config(arch)
        served = serve_on_mesh(dev, cfg, mesh, tag)
        placed = served.pop("placed")
        out[arch] = {**served, **mesh_timed(tag, cfg, dev, placed, mesh)}
        del placed
        gc.collect()
        torch.cuda.empty_cache()
    return out


def mesh_timed(tag: str, cfg, dev, placed, mesh) -> dict:
    """A full model on ``mesh``: one prefill wave's ms (CUDA events, after a
    warm-up), 16 decode steps' ms per step, the collectives of one decode
    step (roofline.collective_bytes) and the peak."""
    import torch

    from repro_torch import compat
    from repro_torch.launch import roofline as R
    from repro_torch.launch import steps as TS
    from repro_torch.models import model as M

    B, S = SERVE["batch"], SERVE["prompt_len"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev, dtype=torch.int32)
    ctx = TS.make_shard_ctx(cfg, mesh, B, TS.StepOptions())
    max_seq = S + SERVE["max_new"]
    torch.cuda.reset_peak_memory_stats(dev)
    prefill = lambda: M.prefill(cfg, placed, {"tokens": toks}, ctx, max_seq=max_seq)  # noqa: E731
    prefill_ms = cuda_ms(prefill, iters=2, warmup=1)
    logits, cache = prefill()
    nxt = torch.argmax(logits[:, -1, :cfg.vocab], -1)[:, None].to(torch.int32)
    rec = compat.CollectiveRecorder()
    with rec:
        logits, cache = M.decode_step(cfg, placed, cache, nxt, ctx)
    coll = R.collective_bytes(rec.collectives)
    steps = 16
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        logits, cache = M.decode_step(cfg, placed, cache, nxt, ctx)
        nxt = torch.argmax(logits[:, 0, :cfg.vocab], -1)[:, None].to(torch.int32)
    end.record()
    end.synchronize()
    decode_ms = start.elapsed_time(end) / steps
    if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
        raise AssertionError(f"{tag}: non-finite decode logits")
    peak = torch.cuda.max_memory_allocated(dev)
    del cache, logits
    log(f"{tag}: prefill {prefill_ms:.2f} ms per wave of {B} x {S}, decode {decode_ms:.2f} ms "
        f"per step (CUDA events); peak {peak / 1e9:.3f} GB; collectives per decode step: "
        + ", ".join(f"{op} {int(c['count'])} ({c['result_bytes'] / 1e9:.3f} GB)"
                    for op, c in coll.items() if c["count"]))
    return {"prefill_ms": prefill_ms, "decode_ms": decode_ms, "timed_peak_bytes": peak,
            "decode_collectives": coll,
            "prefill_mfu": R.mfu(cfg, "prefill", B, S, prefill_ms / 1e3),
            "decode_mfu": R.mfu(cfg, "decode", B, S, decode_ms / 1e3)}


def _n_rank(rank: int, n: int, tmp: str) -> None:
    """One rank of ``mesh_serve_ranks``: its card, the NCCL process group,
    path N-b; its result as JSON."""
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=rank, world_size=n)
    try:
        out = mesh_serve_rank(dev, n)
    finally:
        dist.destroy_process_group()
    with open(f"{tmp}/rank{rank}.json", "w") as f:
        json.dump(out, f)


def mesh_serve_ranks(n: int) -> list:
    """``python3 chip_smoke.py --n-ranks N``: path N-b across N cards of one
    host, one spawned process per card (NCCL).  -> every rank's result."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_n_rank, args=(n, tmp), nprocs=n, start_method="spawn")
        results = []
        for r in range(n):
            with open(f"{tmp}/rank{r}.json") as f:
                results.append(json.load(f))
    return results


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch finds no CUDA device; run this on a machine with a GPU",
              file=sys.stderr)
        return 2
    for flag, run, key in (("--l-ranks", seq_parallel_ranks, "path_l_ranks"),
                           ("--m-ranks", mesh_ranks, "path_m_ranks"),
                           ("--n-ranks", mesh_serve_ranks, "path_n_ranks")):
        if flag not in sys.argv:  # path L-a, M-b or N-b across cards: --l-ranks 4, ...
            continue
        n = int(sys.argv[sys.argv.index(flag) + 1])
        if torch.cuda.device_count() < n:
            raise AssertionError(f"{flag} {n} needs {n} cards, "
                                 f"found {torch.cuda.device_count()}")
        env = phase_env()
        results = run(n)
        log(f"wall {time.perf_counter() - t_start:.1f} s")
        log(json.dumps({key: results, "power": env["smi"]}))
        log(env["smi"])
        log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                               "kind": torch.cuda.get_device_name(0),
                                               "count": torch.cuda.device_count()}}))
        return 0
    import torch.distributed as dist

    from repro_torch.device import default_device

    dev = default_device()
    torch.cuda.set_device(dev)
    env = phase_env()
    zero_counts()
    dry = phase_dryrun()
    dry_counts = read_counts()
    agree = Agreement()
    timing = phase_kernel(dev, agree)
    flash_agree = OutputAgreement()
    flash = phase_flash(dev, flash_agree)
    scan_agree = OutputAgreement()
    scan = phase_scan(dev, scan_agree)
    stage = phase_stage(dev)
    phase_refusals(dev)

    with tempfile.TemporaryDirectory() as tmp:
        # one NCCL group of world size 1: path A's collectives, then path K-c's
        dist.init_process_group("nccl", init_method=f"file://{tmp}/pg", rank=0,
                                world_size=1)
        try:
            trace = phase_trace(dev, dist.group.WORLD)
            width = phase_width(dev, agree)
            served = phase_serve(dev, "gemma-2b", ("flash_attention",),
                                 bf16_smokes=("gemma-2b", "gemma2-2b"))
            prefill_f32 = phase_prefill_f32(dev)
            served_ssm = phase_serve(dev, "falcon-mamba-7b", ("mamba_scan", "mamba_stage"))
            served_moe = phase_serve_moe(dev)
            served_mla = phase_serve(dev, SERVE_MLA, ("flash_attention",),
                                     bf16_smokes=(SERVE_MLA,))
            served_vl = phase_serve_vl(dev)
            trained = phase_train(dev)
            trained_socket = phase_train_socket(dev, trained)
            trained_audio = phase_train_audio(dev)
            dp = phase_dp(dev)
            seq = phase_seq_parallel(dev)
            mesh_train = phase_mesh_train(dev, trained)
            mesh_serve = phase_mesh_serve(dev)
        finally:
            dist.destroy_process_group()
    train_cell = lambda arch: dry[(  # noqa: E731
        {TRAIN["arch"]: "E", TRAIN_AUDIO["arch"]: "J"}[arch], arch, "k_train")]
    timed = {
        "serve": [("C", "gemma-2b", served), ("D", "falcon-mamba-7b", served_ssm),
                  ("G", SERVE_MOE, served_moe), ("H", SERVE_MLA, served_mla),
                  ("I", SERVE_VL, served_vl)],
        "train": [("E", TRAIN["arch"], {**trained, "batch": TRAIN["global_batch"],
                                        "seq": TRAIN["seq"], "predicted_peak":
                                        train_cell(TRAIN["arch"])["memory"]["peak_bytes"]}),
                  ("F", TRAIN["arch"], {**trained_socket, "batch": TRAIN["global_batch"],
                                        "seq": TRAIN["seq"], "predicted_peak": None}),
                  ("J", TRAIN_AUDIO["arch"], {
                      **trained_audio, "batch": TRAIN_AUDIO["global_batch"],
                      "seq": TRAIN_AUDIO["seq"],
                      "predicted_peak": train_cell(TRAIN_AUDIO["arch"])["memory"]["peak_bytes"]})]
        + [(f"K-c {name}", DP["arch"], {"step_ms": run["step_ms"],
                                        "step_host_ms": None, "batch": dp["batch"],
                                        "seq": dp["seq"], "peak_bytes": run["peak_bytes"],
                                        "step_peak_bytes": run["peak_bytes"],
                                        "predicted_peak": dp["predicted_peak"]
                                        if name == "int8" else None})
           for name, run in dp["runs"].items()]
        + [("M-a", TRAIN["arch"], {**mesh_train, "batch": TRAIN["global_batch"],
                                   "seq": TRAIN["seq"], "predicted_peak": None})],
    }
    roofline = phase_roofline(dry, timed, env["smi"])

    paths = {"trace": trace["counts"], "width": width["counts"], "serve": served["counts"],
             "prefill_f32": prefill_f32["counts"],
             "serve_ssm": served_ssm["counts"], "serve_moe": served_moe["counts"],
             "serve_mla": served_mla["counts"], "serve_vl": served_vl["counts"],
             "train": trained["counts"], "train_socket": trained_socket["counts"],
             "train_audio": trained_audio["counts"], "dryrun": dry_counts,
             "train_dp": dp["counts"], "seq_parallel": seq["counts"],
             "train_mesh": mesh_train["counts"], "serve_mesh": mesh_serve["counts"]}
    needs = {"trace": ("moments_and_labels",), "width": ("moments_and_labels",),
             "serve": ("flash_attention",), "prefill_f32": ("flash_attention",),
             "serve_ssm": ("mamba_scan", "mamba_stage"),
             "serve_moe": ("flash_attention",), "serve_mla": ("flash_attention",),
             "serve_vl": ("flash_attention",),
             "seq_parallel": ("flash_attention", "mamba_scan", "mamba_stage"),
             "serve_mesh": ("flash_attention", "mamba_scan", "mamba_stage")}
    for path, names in needs.items():
        for name in names:
            if paths[path][name] <= 0:
                raise AssertionError(f"main path {path} never launched {name}: {paths[path]}")
    # path K runs the plain versions, as JAX's probe; path M trains, as JAX does
    for path in ("dryrun", "train_dp", "train_mesh"):
        if any(paths[path].values()):
            raise AssertionError(f"path {path} launched a port kernel: {paths[path]}")

    def by_path(name):
        return {path: c[name] for path, c in paths.items()}

    def serve_numbers(run):
        return {k: run[k] for k in ("prefill_ms", "decode_ms", "tok_per_s", "peak_bytes",
                                    "param_bytes", "prefill_idle_share", "decode_idle_share")}

    def shape_numbers(t):
        case = t["case"]
        return {**dict(zip(("B", "Sq", "Sk", "H", "KV", "hd", "causal", "window", "cap",
                            "dtype"), case)), "dv": t["dv"],
                **{key: t[key] for key in (
                    "ms", "turns_ms", "device_ms", "host_ms", "host_check_ms", "plain_ms",
                    "bound_ms", "bound_by", "ops_ms", "bytes_ms", "library_ms",
                    "library_device_ms")}}

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
            "ms", "turns_ms", "device_ms", "device_call_ms", "host_ms", "host_check_ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "library_device_ms", "sass",
            "ptxas") + (("cuda_core_ms",) if dtype == "float32" else ())}
            for dtype, inst in flash["instances"].items()},
        "serve": serve_numbers(served),
        "smoke": served["smoke"],
        "prefill_f32": {k: v for k, v in prefill_f32.items() if k != "counts"},
        "f32_max_abs_err": flash["f32_errs"],
        "f32_shapes": {arch: {**shape_numbers(flash[key]),
                              "cuda_core_ms": flash[key]["cuda_core_ms"],
                              "device_call_ms": flash[key]["device_call_ms"],
                              "max_abs_err": flash["f32_errs"][arch]}
                       for key, arch in (("moe_f32", SERVE_MOE), ("vl_f32", SERVE_VL))},
        "moe_shape": shape_numbers(flash["moe"]),
        "mla_shape": shape_numbers(flash["mla"]),
        "vl_shape": shape_numbers(flash["vl"]),
        "gemma2_shape": {**shape_numbers(flash["gemma2"]),
                         "library_same_function": flash["gemma2"]["library_same_function"]},
        "serve_moe": {**serve_numbers(served_moe), "smoke": served_moe["smoke"],
                      "viz": served_moe["viz"], "prefill_classes": served_moe["prefill_classes"],
                      "moe_block_ms": served_moe["moe_block_ms"],
                      "moe_block_classes": served_moe["moe_block_classes"]},
        "serve_mla": {**serve_numbers(served_mla), "smoke": served_mla["smoke"]},
        "serve_vl": {**serve_numbers(served_vl), "smoke": served_vl["smoke"],
                     "vision_prefill": served_vl["vision"]},
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
        "seq_parallel_mixer": seq["bodies"]["mamba"],
    }, {
        "name": "mamba_stage",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mamba_stage.cu",
        "replaces": None,  # the JAX package stages a and b op by op
        "launches": sum(by_path("mamba_stage").values()),
        "launches_by_path": by_path("mamba_stage"),
        "bitwise_equal": True,  # phase_stage raised otherwise
        "ms": stage["ms"],
        "plain_ms": stage["plain_ms"],
        "plain_device_ms": stage["plain_device_ms"],
        "bound_ms": stage["bound_ms"],
        "bound_by": stage["bound_by"],
        "bound_share": stage["bound_share"],
        "library_ms": None,
        "shape": dict(zip(("B", "S", "d_inner", "d_state"), STAGE_FULL)),
        "host_ms": stage["host_ms"],
        "device_ms": stage["device_ms"],
    }]
    log(f"trace precision {trace['precision']:.4f} recall {trace['recall']:.4f}; "
        f"build {env['build_s']:.2f} s; wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"path_k": {
        "dryrun": {f"{path} {arch} {shape}": {
            "model_flops": rec["model_flops_global"], "flops": rec["cost"]["flops"],
            "bytes_accessed": rec["cost"]["bytes_accessed"],
            "argument_bytes": rec["memory"]["argument_size_in_bytes"],
            "peak_bytes": rec["memory"]["peak_bytes"],
            "fits_80gb_hbm": rec["memory"]["fits_80gb_hbm"], "count_s": rec["compile_s"]}
            for (path, arch, shape), rec in dry.items()},
        "roofline": roofline, "power": env["smi"],
        "dp": {k: dp[k] for k in ("batch", "seq", "why", "predicted_peak", "runs", "ref_loss",
                                  "quant_max_ratio", "reduce_pass_ms", "compress_added_ms")}}}))
    log(json.dumps({"path_l": {"model": seq["model"], "bodies": seq["bodies"],
                               "counts": seq["counts"], "power": env["smi"]}}))
    log(json.dumps({"path_m": {**{k: mesh_train[k] for k in (
        "losses", "grad_norms", "event_ms", "host_ms", "step_ms", "step_host_ms", "tok_per_s",
        "peak_bytes", "path_e_losses", "max_rel_loss_diff", "embed_placements", "parity",
        "counts")}, "mfu": roofline["M-a/train"]["mfu"], "power": env["smi"]}}))
    log(json.dumps({"path_n": {"dryrun": {cell: {k: rec[k] for k in (
        "devices", "rank", "memory", "cost", "collectives", "wire_bytes_per_device",
        "aten_ops", "wall_s")} for cell, rec in mesh_serve["dryrun"].items()},
        "tp_decode": mesh_serve["tp_decode"], "serve": mesh_serve["serve"],
        "held": mesh_serve["held"], "counts": mesh_serve["counts"], "power": env["smi"]}}))
    log(env["smi"])
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
