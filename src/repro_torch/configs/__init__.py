"""Architecture registry (copy of ``repro.configs``): the 10 configs + input-shape cells.

``get_config(name)`` returns the full published config; ``smoke(name)``
returns a reduced same-family config for CPU tests.  ``SHAPES`` defines the
four assigned input-shape cells; ``cell_mode``/``cell_applicable`` encode the
skip table from DESIGN.md §5.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

from repro_torch.models.common import MAMBA, MOE, SWA, ModelConfig

ARCHS = (
    "falcon_mamba_7b",
    "granite_moe_1b_a400m",
    "qwen3_moe_30b_a3b",
    "minicpm3_4b",
    "gemma2_2b",
    "gemma_2b",
    "h2o_danube3_4b",
    "jamba_v01_52b",
    "hubert_xlarge",
    "qwen2_vl_2b",
)

# canonical ids from the assignment (hyphens) -> module names
ALIASES = {a.replace("_", "-"): a for a in ARCHS}
ALIASES.update(
    {
        "falcon-mamba-7b": "falcon_mamba_7b",
        "granite-moe-1b-a400m": "granite_moe_1b_a400m",
        "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
        "minicpm3-4b": "minicpm3_4b",
        "gemma2-2b": "gemma2_2b",
        "gemma-2b": "gemma_2b",
        "h2o-danube-3-4b": "h2o_danube3_4b",
        "jamba-v0.1-52b": "jamba_v01_52b",
        "hubert-xlarge": "hubert_xlarge",
        "qwen2-vl-2b": "qwen2_vl_2b",
    }
)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def get_config(name: str) -> ModelConfig:
    mod_name = ALIASES.get(name, name)
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.config()


def smoke(name: str) -> ModelConfig:
    return reduce_for_smoke(get_config(name))


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Same family/layout, tiny dims: one CPU forward/train step must run."""
    pairs = 8  # qk_dim // 2 after reduction
    return dataclasses.replace(
        cfg,
        n_layers=cfg.period * 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16,
        d_ff=128,
        vocab=512,
        window=32,
        q_lora_rank=48 if cfg.q_lora_rank else 0,
        kv_lora_rank=32 if cfg.kv_lora_rank else 0,
        qk_nope_dim=8 if cfg.qk_nope_dim else 0,
        qk_rope_dim=8 if cfg.qk_rope_dim else 0,
        v_head_dim=16 if cfg.v_head_dim else 0,
        moe_experts=min(cfg.moe_experts, 8) if cfg.moe_experts else 0,
        moe_topk=min(cfg.moe_topk, 2) if cfg.moe_topk else 0,
        moe_dff=32 if cfg.moe_dff else 0,
        ssm_d_state=8,
        ssm_dt_rank=8,
        mrope_sections=(2, 3, 3),
    )


def cell_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """Skip table (DESIGN.md §5). Returns (runnable, reason-if-skipped)."""
    cell = SHAPES[shape]
    if cfg.is_encoder and cell.mode == "decode":
        return False, "encoder-only arch: no decode step"
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "full-attention arch: long_500k requires sub-quadratic attention"
    return True, ""


def all_cells():
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            ok, why = cell_applicable(cfg, shape)
            yield arch, shape, ok, why
