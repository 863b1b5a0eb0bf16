"""Model configuration and parameter initialisation (port of ``repro.models.common``).

One unified config drives all 10 architectures the repo supports.  A model
is a period-repeated stack of blocks; each period position has a
``LayerSpec`` (mixer kind × mlp kind).  The parameter tree has the JAX
package's shape exactly: ``{"embed", "final_ln", ["unembed"], "layers":
[per-position dict of tensors stacked over periods]}``, so that a JAX tree
carries across leaf for leaf (``convert.params_from_jax``).

``jax.random`` bits cannot be reproduced in torch, so :func:`init_params`
draws the same distributions at the same scales from a ``torch.Generator``
and the parity tests carry JAX's weights across instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from .._unported import unported as _unported
from ..device import resolve

# Mixer kinds: how the sequence dimension is mixed.
FULL, SWA, MLA, MAMBA = "full", "swa", "mla", "mamba"
# MLP kinds.
DENSE, MOE, NONE = "dense", "moe", "none"

# What the dense slice of the port does not cover yet, with its ROADMAP.md
# queue 1 item: raised as NotImplementedError wherever it is asked for.
UNPORTED = {
    MAMBA: ("the Mamba mixer", 7),
    MOE: ("the MoE MLP", 8),
    MLA: ("the MLA mixer", 9),
    "mrope": ("M-RoPE positions", 9),
    "audio_stub": ("the audio-stub modality", 9),
    "vision_stub": ("the vision-stub modality", 9),
}


def unported(kind: str) -> NotImplementedError:
    return _unported(*UNPORTED[kind])


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    mixer: str  # full | swa | mla | mamba
    mlp: str  # dense | moe | none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    layout: Tuple[LayerSpec, ...]  # one period
    # attention details
    window: int = 4096  # SWA window
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    causal: bool = True
    rope_theta: float = 10000.0
    pos: str = "rope"  # rope | mrope | none
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # pairs per (t, h, w)
    # activation
    activation: str = "silu"  # silu (swiglu) | geglu | gelu (dense, no gate)
    # MLA (DeepSeek/MiniCPM3-style latent attention)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # MoE
    moe_experts: int = 0
    moe_topk: int = 0
    moe_dff: int = 0
    moe_capacity_factor: float = 1.25
    # Mamba (SSM)
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0
    # misc
    norm_eps: float = 1e-6
    emb_scale: bool = False  # gemma: hidden *= sqrt(d_model)
    sandwich_norm: bool = False  # gemma2: post-norms after mixer/mlp
    tie_embeddings: bool = True
    modality: str = "text"  # text | audio_stub | vision_stub
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16

    # ------------------------------------------------------------- derived
    @property
    def period(self) -> int:
        return len(self.layout)

    @property
    def vocab_padded(self) -> int:
        """Embedding rows padded to a multiple of 256.

        Padded logit columns are masked to −1e30 in unembed() so the
        softmax is exact."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0, (self.name, self.n_layers, self.period)
        return self.n_layers // self.period

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or max(1, self.d_model // 16)

    @property
    def qk_dim(self) -> int:
        return (self.qk_nope_dim + self.qk_rope_dim) if self.mixer_has(MLA) else self.head_dim

    def mixer_has(self, kind: str) -> bool:
        return any(s.mixer == kind for s in self.layout)

    def mlp_has(self, kind: str) -> bool:
        return any(s.mlp == kind for s in self.layout)

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def attention_free(self) -> bool:
        return all(s.mixer == MAMBA for s in self.layout)

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid-with-few-attn / pure-SWA)."""
        return all(s.mixer in (MAMBA, SWA) for s in self.layout) or self.family == "hybrid"

    def n_params(self) -> int:
        """Analytic parameter count."""
        d, f = self.d_model, self.d_ff
        v = self.vocab_padded
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        for spec in self.layout:
            n = 0
            if spec.mixer in (FULL, SWA):
                n += d * self.n_heads * self.head_dim  # q
                n += 2 * d * self.n_kv_heads * self.head_dim  # k, v
                n += self.n_heads * self.head_dim * d  # o
            elif spec.mixer == MLA:
                qh = self.qk_nope_dim + self.qk_rope_dim
                n += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * qh
                n += d * (self.kv_lora_rank + self.qk_rope_dim)
                n += self.kv_lora_rank * self.n_heads * (self.qk_nope_dim + self.v_head_dim)
                n += self.n_heads * self.v_head_dim * d
            elif spec.mixer == MAMBA:
                di = self.d_inner
                n += d * 2 * di + di * self.ssm_d_conv + di  # in_proj, conv_w, conv_b
                n += di * (self.dt_rank + 2 * self.ssm_d_state)  # x_proj
                n += self.dt_rank * di + di  # dt_proj, dt_bias
                n += di * self.ssm_d_state + di  # A_log, D
                n += di * d  # out_proj
            if spec.mlp == DENSE:
                n += (3 if self.activation in ("silu", "geglu") else 2) * d * f
            elif spec.mlp == MOE:
                n += d * self.moe_experts
                n += self.moe_experts * 3 * d * self.moe_dff
            n += d  # ln1
            if spec.mlp != NONE:
                n += d  # ln2
            if self.sandwich_norm:
                n += d + (d if spec.mlp != NONE else 0)
            if spec.mixer == MLA:
                n += self.q_lora_rank + self.kv_lora_rank  # q_ln, kv_ln
            total += n * self.n_periods
        total += d  # final_ln
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.mlp_has(MOE):
            return self.n_params()
        full = self.n_params()
        per_layer_moe = self.moe_experts * 3 * self.d_model * self.moe_dff
        n_moe_layers = sum(1 for s in self.layout if s.mlp == MOE) * self.n_periods
        inactive = per_layer_moe * (1 - self.moe_topk / self.moe_experts)
        return int(full - n_moe_layers * inactive)


# ---------------------------------------------------------------- initializers
def layer_param_shapes(cfg: ModelConfig, spec: LayerSpec) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (per-layer shape, init) of one period position, init being
    "dense" (normal × 1/√fan_in) or "ones"; the order is the draw order."""
    if spec.mixer in (MLA, MAMBA):
        raise unported(spec.mixer)
    if spec.mlp == MOE:
        raise unported(MOE)
    d, H, KV, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff
    out: Dict[str, Tuple[Tuple[int, ...], str]] = {"ln1": ((d,), "ones")}
    out["wq"] = ((d, H * hd), "dense")
    out["wk"] = ((d, KV * hd), "dense")
    out["wv"] = ((d, KV * hd), "dense")
    out["wo"] = ((H * hd, d), "dense")
    if spec.mlp == DENSE:
        out["ln2"] = ((d,), "ones")
        if cfg.activation in ("silu", "geglu"):
            out["w_gate"] = ((d, f), "dense")
        out["w_up"] = ((d, f), "dense")
        out["w_down"] = ((f, d), "dense")
    if cfg.sandwich_norm:
        out["post_ln1"] = ((d,), "ones")
        if spec.mlp != NONE:
            out["post_ln2"] = ((d,), "ones")
    return out


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The parameter tree's shapes: layer leaves carry a leading period axis."""
    shapes: Dict[str, Any] = {"embed": (cfg.vocab_padded, cfg.d_model),
                              "final_ln": (cfg.d_model,)}
    if not cfg.tie_embeddings:
        shapes["unembed"] = (cfg.d_model, cfg.vocab_padded)
    shapes["layers"] = [
        {name: (cfg.n_periods, *shape) for name, (shape, _) in layer_param_shapes(cfg, s).items()}
        for s in cfg.layout
    ]
    return shapes


def _dense_init(gen: torch.Generator, shape, dtype, device, scale: Optional[float] = None):
    """normal × 1/√fan_in, fan_in = shape[-2]: the input dim, as in JAX,
    whose per-layer init is vmapped over the leading period axis."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    std = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(std).to(dtype)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Dict[str, Any]:
    """Full parameter tree from ``seed``, drawn on ``device``.

    ``device=None`` is the port's default device (``cuda:0``; raises
    without CUDA).  The same seed gives the same tensors on one device
    type; CPU and CUDA generators differ.
    """
    device = resolve(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.param_dtype
    params: Dict[str, Any] = {
        # 1/sqrt(d) keeps tied-unembed logits O(1) at init (emb_scale archs
        # multiply hidden states back up by sqrt(d)).
        "embed": _dense_init(gen, (cfg.vocab_padded, cfg.d_model), dt, device,
                             scale=1.0 / math.sqrt(cfg.d_model)),
        "final_ln": torch.ones((cfg.d_model,), dtype=dt, device=device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = _dense_init(gen, (cfg.d_model, cfg.vocab_padded), dt, device)
    params["layers"] = []
    for spec in cfg.layout:
        layer = {}
        for name, (shape, init) in layer_param_shapes(cfg, spec).items():
            full = (cfg.n_periods, *shape)
            layer[name] = (_dense_init(gen, full, dt, device) if init == "dense"
                           else torch.ones(full, dtype=dt, device=device))
        params["layers"].append(layer)
    return params
