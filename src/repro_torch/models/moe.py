"""Mixture-of-Experts MLP (port of ``repro.models.moe``): top-k routing with
sort-based, capacity-bounded dispatch, all on the device.

Each token picks its top-k experts, weighted by their softmax probabilities
renormalised over the k (``cfg.moe_renormalize``, the default) or as they
are (DeepSeek's ``norm_topk_prob`` false); the (token, expert) pairs are
sorted by expert id and each expert takes at most ``C`` of them, in token order
(``_positions_in_run``).  Kept tokens are scattered into an (E, C, D)
buffer, the experts run as batched GEMMs, and each token sums its k
weighted outputs.

Where the port pins down what torch leaves open, it follows JAX exactly:

  * top-k ties keep the lower expert index (``jax.lax.top_k``): a stable
    descending sort, where ``torch.topk`` promises no order among ties;
  * the dispatch sort is stable (``jnp.argsort``), so the same tokens pass
    the capacity;
  * dropped pairs go to a sink row past the E·C real slots (JAX's
    ``mode="drop"`` / ``mode="fill"``), cropped away;
  * the combine adds each token's k contributions one at a time in the
    dtype of ``x``, in ascending expert id: the order in which XLA's
    scatter-add applies the sorted updates.  No atomics, so two calls on
    the same input are bitwise equal on the card.

:func:`shared_experts` is DeepSeek's always-on SwiGLU, which the model adds
beside ``moe_block``'s output (outside its all-reduce).

Nothing here waits on the device: the capacity comes from shapes, and no
index is read back to the host.

Expert parallelism (``ep=EPInfo``), JAX's ``shard_map`` body: the tokens
are replicated over the expert axis and rank r holds experts
[r·E/n, (r+1)·E/n) (``moe_gate``, ``moe_up``, ``moe_down`` cut to them).
Every rank routes all tokens identically, computes its own experts'
contributions (:func:`moe_local`), and one all-reduce over the axis sums
them (with autograd where a gradient is taken: ``collectives.all_reduce``).  In float32 that equals ``ep=None`` up to the order of that sum.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch

from ..telemetry.selftrace import get_self_tracer
from . import collectives as C
from . import layers as L
from .common import ModelConfig

_TRACER = get_self_tracer()  # span moe, with its routed pairs, the kept ones and its slots

KEYS = ("router", "moe_gate", "moe_up", "moe_down")  # the layer weights moe_block reads
EXPERT_KEYS = KEYS[1:]  # split over the expert axis


@dataclasses.dataclass(frozen=True)
class EPInfo:
    """Expert-parallel context: which experts this shard owns.  ``mesh`` is
    the ``DeviceMesh`` whose dim ``axis`` the experts are split over (JAX
    finds it from ``shard_map``)."""

    axis: str  # mesh axis name experts are sharded over
    n_shards: int
    mesh: Optional[object] = None


def _positions_in_run(sorted_ids: torch.Tensor) -> torch.Tensor:
    """Occurrence index within runs of equal values (sorted input)."""
    idx = torch.arange(sorted_ids.shape[0], device=sorted_ids.device)
    change = torch.ones_like(sorted_ids, dtype=torch.bool)
    change[1:] = sorted_ids[1:] != sorted_ids[:-1]
    run_start = torch.cummax(torch.where(change, idx, 0), dim=0).values
    return idx - run_start


def _route(p: Dict[str, torch.Tensor], xt: torch.Tensor, k: int):
    """-> (probs (N, E) float32, top-k values (N, k), their expert ids)."""
    logits = (xt @ p["router"]).float()
    # jax.nn.softmax, op by op
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, vals[:, :k], ids[:, :k]


def capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Slots per expert: expected load × factor, floored so tiny decode
    batches (N ~ a few tokens) stay effectively dropless."""
    E, k = cfg.moe_experts, cfg.moe_topk
    return max(math.ceil(k * n_tokens / E * cfg.moe_capacity_factor), min(n_tokens, 16))


def moe_block(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,  # (B, S, D), replicated over the expert axis with ``ep``
    cfg: ModelConfig,
    ep: Optional[EPInfo] = None,
) -> torch.Tensor:
    """Top-k routed expert MLP with capacity-based sort dispatch; with
    ``ep`` this rank's experts (``p``'s expert leaves hold E/n of them) and
    one all-reduce of the contributions over ``ep.axis``."""
    if ep is None:
        return moe_local(p, x, cfg, 0)
    if ep.mesh is None:
        raise ValueError("EPInfo needs the mesh whose axis splits the experts")
    E = cfg.moe_experts
    if E % ep.n_shards or p["moe_gate"].shape[0] != E // ep.n_shards:
        raise ValueError(f"expert parallelism over {ep.n_shards} ranks takes this rank's "
                         f"{E // ep.n_shards} of {E} experts, got {p['moe_gate'].shape[0]}")
    out = moe_local(p, x, cfg, ep.mesh.get_local_rank(ep.axis) * (E // ep.n_shards))
    return C.all_reduce(out, ep.mesh.get_group(ep.axis))


def moe_local(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
              offset: int) -> torch.Tensor:
    """The contributions of experts [offset, offset + e) to every token,
    where ``p``'s expert leaves hold those e experts (all E: ``moe_block``
    without expert parallelism).  The routing and the capacity are those
    of all E experts over x's N tokens; a pair routed elsewhere, or past
    its expert's capacity, adds 0."""
    with _TRACER.span("moe") as span:
        B, S, D = x.shape
        E, k = cfg.moe_experts, cfg.moe_topk
        e_loc = p["moe_gate"].shape[0]
        N = B * S
        xt = x.reshape(N, D)

        # --- routing ------------------------------------------------------------
        _, weights, ids = _route(p, xt, k)
        if cfg.moe_renormalize:
            weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
        C = capacity(cfg, N)

        # --- sort-based dispatch ------------------------------------------------
        flat_ids = ids.reshape(-1)  # (N*k,), token-major
        flat_tok = torch.arange(N * k, device=x.device) // k
        order = torch.argsort(flat_ids, stable=True)
        s_ids = flat_ids[order]
        s_tok = flat_tok[order]
        s_w = weights.reshape(-1)[order]
        pos = _positions_in_run(s_ids)
        local_e = s_ids - offset
        owned = pos < C
        if e_loc != E:
            mine = (local_e >= 0) & (local_e < e_loc)
            owned = owned & mine
        sink = e_loc * C  # one row past the real slots takes every dropped pair
        slot = torch.where(owned, local_e * C + pos, sink)
        if span:  # counts read when the spans are read: the pairs kept, the e·C
            # slots, and the pairs routed to these experts (N·k for all E)
            span.set(kept=owned.sum(), slots=sink, pairs=mine.sum() if e_loc != E else N * k)
        buf = x.new_zeros((sink + 1, D)).index_put((slot,), xt[s_tok])
        buf = buf[:sink].reshape(e_loc, C, D)

        # --- expert FFN (batched GEMMs over experts) ----------------------------
        act = L.gelu_tanh if cfg.activation == "geglu" else L.silu
        h = act(torch.bmm(buf, p["moe_gate"])) * torch.bmm(buf, p["moe_up"])
        y_buf = torch.bmm(h, p["moe_down"]).reshape(sink, D)

        # --- combine: gather back, weight, add per token in expert order --------
        y_buf = torch.cat([y_buf, y_buf.new_zeros((1, D))])  # the sink reads 0
        contrib = y_buf[slot] * (s_w * owned).to(x.dtype)[:, None]
        # the sorted position of each (token, j): the stable sort keeps a
        # token's pairs in ascending expert id, the order XLA adds them in
        at = torch.empty_like(order)
        at[order] = torch.arange(N * k, device=x.device)
        at = torch.sort(at.view(N, k), dim=-1).values
        out = contrib[at[:, 0]]
        for j in range(1, k):
            out = out + contrib[at[:, j]]
        return out.reshape(B, S, D)


def shared_experts(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    """The shared experts (DeepSeek's ``n_shared_experts``), one SwiGLU of
    width ``cfg.shared_dff`` on every token of x (B, S, D)."""
    return L.mlp({"w_gate": p["shared_gate"], "w_up": p["shared_up"],
                  "w_down": p["shared_down"]}, x, cfg.activation)


def moe_aux_loss(
    p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
) -> torch.Tensor:
    """Load-balancing auxiliary loss (Switch-style): E · Σ_e f_e · P_e."""
    N = x.shape[0] * x.shape[1]
    probs, _, ids = _route(p, x.reshape(N, -1), cfg.moe_topk)
    ones = torch.ones(ids.numel(), dtype=torch.float32, device=x.device)
    counts = torch.zeros(cfg.moe_experts, dtype=torch.float32, device=x.device)
    f = counts.index_add_(0, ids.reshape(-1), ones) / (N * cfg.moe_topk)
    P = probs.mean(0)
    return cfg.moe_experts * torch.sum(f * P)
