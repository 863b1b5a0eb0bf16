"""Roofline terms on an NVIDIA H100 (port of ``repro.launch.roofline``).

Hardware model (H100 SXM, per card, NVIDIA's data sheet; dense rates at the
700 W power limit): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s
float32 outside them, 3.35 TB/s of HBM, 450 GB/s each way over NVLink to
the host's other cards.  Terms per (arch × shape × devices):

    compute    = FLOPs_per_device            / peak_flops
    memory     = HBM bytes_per_device        / hbm_bw
    collective = NVLink bytes_per_device     / nvlink_bw

The FLOPs and bytes come from the dry run's counting context
(:mod:`repro_torch.compat`), per device.  Collectives are the ones a run
recorded (``compat.CollectiveRecorder``, which ``compat.CostCounter`` extends),
where JAX parses them from partitioned HLO; their wire bytes take the same
ring factors: all-reduce 2×result, all-gather/reduce-scatter/all-to-all/
point-to-point 1×result (each ×(n−1)/n ≈ 1).

The formulas of :func:`roofline_terms`, :func:`attn_scores_traffic`,
:func:`analytic_memory_floor` and :func:`model_flops` are JAX's.  JAX fixes
the model axis at 16 (its production mesh); here ``tp`` is a parameter
whose default is 16, so every input JAX accepts gives JAX's number, and
one device passes ``tp=1``.
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

HW = {
    "peak_flops": 989e12,  # bf16 FLOP/s per card, tensor cores, dense
    "peak_flops_f32": 67e12,  # float32 FLOP/s outside the tensor cores
    "peak_flops_tf32": 495e12,  # TF32 FLOP/s per card, tensor cores, dense
    "hbm_bw": 3.35e12,  # bytes/s per card (HBM3)
    "nvlink_bw": 450e9,  # bytes/s each way per card (NVLink 4, all to all)
    "hbm_bytes": 80e9,  # device memory per card
}

_COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)
# result-bytes -> wire-bytes ring estimate
_WIRE_FACTOR = {
    "all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0,
}


def collective_bytes(records: Iterable[Tuple[str, int]]) -> Dict[str, Dict[str, float]]:
    """Per-op-type {count, result_bytes, wire_bytes} from recorded collectives.

    ``records`` holds (op, result bytes) pairs, op one of JAX's HLO names
    (``all-reduce``, ``all-gather``, ``reduce-scatter``, ``all-to-all``,
    ``collective-permute`` for a point-to-point send), as
    ``compat.CollectiveRecorder`` records them from the c10d operations a
    run issues.
    """
    out = {op: {"count": 0, "result_bytes": 0.0, "wire_bytes": 0.0} for op in _COLLECTIVES}
    for op, nbytes in records:
        if op not in out:
            raise ValueError(f"unknown collective {op!r}; expected one of {_COLLECTIVES}")
        out[op]["count"] += 1
        out[op]["result_bytes"] += nbytes
        out[op]["wire_bytes"] += nbytes * _WIRE_FACTOR[op]
    return out


def roofline_terms(
    flops_per_device: float,
    hbm_bytes_per_device: float,
    wire_bytes_per_device: float,
) -> Dict[str, float]:
    compute = flops_per_device / HW["peak_flops"]
    memory = hbm_bytes_per_device / HW["hbm_bw"]
    collective = wire_bytes_per_device / HW["nvlink_bw"]
    dominant = max(
        ("compute", compute), ("memory", memory), ("collective", collective),
        key=lambda kv: kv[1],
    )[0]
    bound = max(compute, memory, collective)
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
        "step_time_lower_bound_s": bound,
        # fraction of roofline achieved if the dominant term were the step
        # time: useful-work share of the bound
        "compute_fraction_of_bound": compute / bound if bound > 0 else 0.0,
    }


def attn_scores_traffic(
    cfg, mode: str, batch: int, seq: int, devices: int, tp: int = 16
) -> float:
    """Per-device HBM bytes the PROBE's direct-attention path spends on
    materialized (Sq, Sk) score tensors — traffic the flash kernel keeps
    on chip.  memory_term_kernel = (probe_bytes − this)/BW.

    Model: per attention layer, scores+probs ≈ 4 HBM accesses of
    B×H×Sq×Sk fp32 in forward; training triples it (fwd + remat-fwd + bwd).
    ``tp`` is the model-axis size (JAX: always 16; one device: 1).
    """
    dp = devices // tp
    n_full = sum(1 for s in cfg.layout if s.mixer in ("full", "mla")) * (
        cfg.n_layers // max(len(cfg.layout), 1)
    )
    n_swa = sum(1 for s in cfg.layout if s.mixer == "swa") * (
        cfg.n_layers // max(len(cfg.layout), 1)
    )
    H = max(cfg.n_heads, 1)
    H_loc = H // tp if H % tp == 0 else H
    B_loc = max(batch // dp, 1)
    Sq = 1 if mode == "decode" else seq
    Sk = seq
    full_elems = n_full * B_loc * H_loc * Sq * Sk
    swa_elems = n_swa * B_loc * H_loc * Sq * min(Sk, cfg.window)
    phases = 3.0 if mode == "train" else 1.0
    return (full_elems + swa_elems) * 4.0 * 4.0 * phases


def analytic_memory_floor(
    cfg, mode: str, batch: int, seq: int, devices: int, microbatch: int = 1,
    tp: int = 16,
) -> float:
    """Per-device HBM bytes/step assuming perfect fusion (lower bound).

    Terms (documented constants):
      optimizer     32·N/devices      fp32 read+write of p, m, v + grad r/w
      weight reads  passes·2·Na/tp·mb bf16 weights re-read per microbatch;
                    passes = 3 for train (fwd + remat-fwd + bwd), 1 otherwise
      activations   12·tokens_dev·d·2·passes   ~6 intermediates r+w per layer
                    … × n_layers
      kv/ssm cache  full cache r+w for decode; write-only for prefill
    ``tp`` is the model-axis size (JAX: always 16; one device: 1).
    """
    dp = max(devices // tp, 1)
    N, Na = cfg.n_params(), cfg.n_active_params()
    d = cfg.d_model
    L = cfg.n_layers
    passes = 3.0 if mode == "train" else 1.0
    toks_dev = (batch * seq) / dp if mode != "decode" else batch / max(dp, 1)
    total = 0.0
    if mode == "train":
        total += 32.0 * N / devices
        total += passes * 2.0 * Na / tp * max(microbatch, 1)
    else:
        total += 2.0 * Na / tp
    # per-layer activation traffic: ~6 intermediates, read+write, × L layers
    total += 12.0 * toks_dev * d * 2.0 * passes * L
    # decode cache traffic (read K+V per step; mamba state tiny)
    if mode == "decode":
        cache = 0.0
        NP = cfg.n_periods
        for spec_ in cfg.layout:
            if spec_.mixer in ("full", "swa"):
                Sc = min(seq, cfg.window) if spec_.mixer == "swa" else seq
                cache += 2 * batch * Sc * cfg.n_kv_heads * cfg.head_dim * 2
            elif spec_.mixer == "mla":
                cache += batch * seq * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 2
            elif spec_.mixer == "mamba":
                cache += batch * cfg.d_inner * cfg.ssm_d_state * 4
        total += cache * NP / devices * tp  # cache sharded over model+batch axes
    return total


def model_flops(cfg, mode: str, batch: int, seq: int) -> float:
    """Analytic MODEL_FLOPS: 6·N_active·tokens (train), 2·N_active·tokens
    (prefill), 2·N_active·batch (decode, one token)."""
    n = cfg.n_active_params()
    if mode == "train":
        return 6.0 * n * batch * seq
    if mode == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch


def mfu(cfg, mode: str, batch: int, seq: int, seconds: float) -> float:
    """Share of the card's bf16 peak that ``model_flops`` over ``seconds`` is."""
    return model_flops(cfg, mode, batch, seq) / (seconds * HW["peak_flops"])
