"""Plain float32 reference of a Jamba block (Lieber et al., arXiv:2403.19887)
as the configuration file's ``model`` block states it.

A period of layers, each a pre-norm residual mixer (a Mamba-1 mixer, from
:mod:`perfbench.reference.mamba1`, or causal grouped-query attention with
no positional encoding) followed by a pre-norm residual MLP: a SwiGLU
(``silu(x W_gate) * (x W_up) W_down``) or a mixture of experts.  The mixture
routes each token to its ``moe_topk`` experts by the softmax of ``x W_router``
(ties to the lower index), weights them by their probabilities renormalised
over the chosen ones, and bounds each expert's load per routing call at
``max(ceil(topk * N / E * capacity_factor), min(N, 16))`` tokens of the
call's N, taken in token order; a token past its expert's bound gets
nothing from that expert.  A served batch routes once per call: the prompt
rows of one batch together, then each decoded position of the batch on its
own, so ``logits`` takes the rows' grouping (``groups``) and the prompt
length.

Float32 throughout from the benchmark's weights, TF32 off, one layer at a
time over blocks of whole groups.  It imports nothing of the program.
``quant="fp8"`` is the control, as in :mod:`mamba1`.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from .mamba1 import (f32, final_logits, layer_weights, linear, mamba_leaves, mamba_mixer,
                     rms_norm, silu, top_leaves)

Q_CHUNK = 256  # query rows per block of attention scores


def attention_leaves(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    d, H, KV, hd = m["d_model"], m["n_heads"], m["n_kv_heads"], m["head_dim"]
    return {"ln1": ((d,), "ones"), "wq": ((d, H * hd), "dense"),
            "wk": ((d, KV * hd), "dense"), "wv": ((d, KV * hd), "dense"),
            "wo": ((H * hd, d), "dense")}


def mlp_leaves(m: dict, kind: str) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    d = m["d_model"]
    if kind == "dense":
        f = m["d_ff"]
        return {"ln2": ((d,), "ones"), "w_gate": ((d, f), "dense"),
                "w_up": ((d, f), "dense"), "w_down": ((f, d), "dense")}
    E, f = m["moe_experts"], m["moe_dff"]
    return {"ln2": ((d,), "ones"), "router": ((d, E), "dense"),
            "moe_gate": ((E, d, f), "dense"), "moe_up": ((E, d, f), "dense"),
            "moe_down": ((E, f, d), "dense")}


def leaves(m: dict) -> List[Tuple[Tuple, Tuple[int, ...], str]]:
    n_periods = m["n_layers"] // len(m["layout"])
    out = top_leaves(m)
    for i, (mixer, mlp) in enumerate(m["layout"]):
        if mixer not in ("mamba", "full") or mlp not in ("dense", "moe"):
            raise ValueError(f"a Jamba layer is mamba or full attention with a dense or moe "
                             f"MLP, got {mixer}/{mlp}")
        block = dict(mamba_leaves(m) if mixer == "mamba" else attention_leaves(m))
        block.update(mlp_leaves(m, mlp))
        out += [(("layers", i, k), (n_periods, *s), kind) for k, (s, kind) in block.items()]
    return out


def float32_leaf(name: str) -> bool:
    return name in ("A_log", "final_ln")


def attention(p: Dict[str, torch.Tensor], u: torch.Tensor, m: dict,
              quant: Optional[str]) -> torch.Tensor:
    """Causal GQA over whole sequences u (R, T, d): query head j reads key
    and value head j // (H / KV); scores scaled by 1/sqrt(head_dim)."""
    R, T, _ = u.shape
    H, KV, hd = m["n_heads"], m["n_kv_heads"], m["head_dim"]
    G = H // KV
    q = linear(u, p["wq"], quant).view(R, T, KV, G, hd)
    k = linear(u, p["wk"], quant).view(R, T, KV, hd)
    v = linear(u, p["wv"], quant).view(R, T, KV, hd)
    out = torch.empty((R, T, KV, G, hd), dtype=torch.float32, device=u.device)
    keys = torch.arange(T, device=u.device)
    for q0 in range(0, T, Q_CHUNK):
        q1 = min(T, q0 + Q_CHUNK)
        s = torch.einsum("rqkgd,rskd->rkgqs", q[:, q0:q1], k) / math.sqrt(hd)
        future = keys[None, :] > torch.arange(q0, q1, device=u.device)[:, None]
        s = s.masked_fill(future, float("-inf"))
        out[:, q0:q1] = torch.einsum("rkgqs,rskd->rqkgd", torch.softmax(s, dim=-1), v)
    return linear(out.view(R, T, H * hd), p["wo"], quant)


def swiglu(x: torch.Tensor, gate, up, down, quant: Optional[str]) -> torch.Tensor:
    return linear(silu(linear(x, gate, quant)) * linear(x, up, quant), down, quant)


def route(p: Dict[str, torch.Tensor], x: torch.Tensor, m: dict, quant: Optional[str]):
    """One routing call over the N tokens of x (N, d), in their order ->
    (kept (N, E) bool, weight (N, E) float32)."""
    N = x.shape[0]
    E, k = m["moe_experts"], m["moe_topk"]
    probs = torch.softmax(linear(x, p["router"], quant), dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, ids = vals[:, :k], ids[:, :k]
    weight = torch.zeros((N, E), dtype=torch.float32, device=x.device)
    weight.scatter_(1, ids, vals / vals.sum(-1, keepdim=True).clamp(min=1e-9))
    chosen = torch.zeros((N, E), dtype=torch.bool, device=x.device)
    chosen.scatter_(1, ids, True)
    bound = max(math.ceil(k * N / E * m["moe_capacity_factor"]), min(N, 16))
    return chosen & (torch.cumsum(chosen.to(torch.int64), dim=0) <= bound), weight


def moe(p: Dict[str, torch.Tensor], x: torch.Tensor, m: dict, groups: Sequence[Sequence[int]],
        prompt_len: int, quant: Optional[str]) -> torch.Tensor:
    """The mixture over x (R, T, d): per group of rows, one routing call
    over its prompt positions (row-major), then one per later position;
    each expert then runs once over the tokens all calls kept for it."""
    R, T, d = x.shape
    flat = x.reshape(R * T, d)
    pos = torch.arange(T, device=x.device)
    calls = []
    for rows in groups:
        rows = torch.as_tensor(list(rows), device=x.device)
        calls.append((rows[:, None] * T + pos[None, :prompt_len]).flatten())
        calls += [rows * T + t for t in range(prompt_len, T)]
    routed = [route(p, flat[idx], m, quant) for idx in calls]
    idx = torch.cat(calls)
    kept = torch.cat([r[0] for r in routed])
    weight = torch.cat([r[1] for r in routed])
    out = torch.zeros_like(flat)
    for e in range(m["moe_experts"]):
        sel = torch.nonzero(kept[:, e]).flatten()
        if sel.numel():
            toks = idx[sel]
            y = swiglu(flat[toks], p["moe_gate"][e], p["moe_up"][e], p["moe_down"][e], quant)
            out.index_add_(0, toks, y * weight[sel, e, None])
    return out.view(R, T, d)


def block_groups(groups: Sequence[Sequence[int]], rows_per_block: int) -> List[List[List[int]]]:
    """Whole groups packed into blocks of at most ``rows_per_block`` rows."""
    blocks, cur = [], []
    for g in groups:
        if cur and sum(map(len, cur)) + len(g) > rows_per_block:
            blocks.append(cur)
            cur = []
        cur.append(list(g))
    return blocks + ([cur] if cur else [])


@torch.no_grad()
def logits(m: dict, weights, tokens: torch.Tensor, n_last: int, *,
           groups: Optional[Sequence[Sequence[int]]] = None, prompt_len: Optional[int] = None,
           quant: Optional[str] = None, rows_per_block: int = 16) -> torch.Tensor:
    """Float32 logits at the last ``n_last`` positions of each row of
    ``tokens`` (R, T): (R, n_last, vocab).  ``groups`` (lists of row
    indices) are the batches the rows were served in, ``prompt_len`` their
    prompt length; by default every row is its own batch and all of T is
    prompt."""
    R, T = tokens.shape
    groups = [[r] for r in range(R)] if groups is None else groups
    prompt_len = T if prompt_len is None else prompt_len
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        n_periods = m["n_layers"] // len(m["layout"])
        out = torch.empty((R, n_last, m["vocab"]), dtype=torch.float32, device=tokens.device)
        for block in block_groups(groups, rows_per_block):
            rows = [r for g in block for r in g]
            local = {r: i for i, r in enumerate(rows)}
            local_groups = [[local[r] for r in g] for g in block]
            x = f32(weights["embed"][tokens[rows]])
            for period in range(n_periods):
                for i, (mixer, mlp) in enumerate(m["layout"]):
                    p = layer_weights(weights, i, period)
                    h = rms_norm(x, p["ln1"], m["norm_eps"])
                    x = x + (mamba_mixer(p, h, m, quant) if mixer == "mamba"
                             else attention(p, h, m, quant))
                    h = rms_norm(x, p["ln2"], m["norm_eps"])
                    if mlp == "dense":
                        x = x + swiglu(h, p["w_gate"], p["w_up"], p["w_down"], quant)
                    else:
                        x = x + moe(p, h, m, local_groups, prompt_len, quant)
            out[rows] = final_logits(m, weights, x[:, -n_last:], quant)
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
