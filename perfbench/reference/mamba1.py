"""Plain float32 reference of a Mamba-1 language model.

Follows the selective state-space model of Gu and Dao (arXiv:2312.00752),
as the configuration file's ``model`` block states it: pre-norm residual
blocks (RMSNorm, weight multiplied as it is, eps ``norm_eps``), each a
Mamba mixer and no MLP; a final RMSNorm; logits through the embedding
table (tied) or the ``unembed`` matrix.  The mixer, per position t:

    x, z   = split(u @ in_proj)                      (d_inner each)
    x      = silu(causal depthwise conv_K(x) + conv_b)
    dt, B, C = split(x @ x_proj)                     (dt_rank, d_state, d_state)
    dt     = softplus(dt @ dt_proj + dt_bias)
    h_t    = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t,   A = -exp(A_log)
    y_t    = h_t C_t + D * x_t
    out    = (y * silu(z)) @ out_proj

Everything is computed in float32 from the benchmark's weights (the
bfloat16 values widened), with TF32 off, one layer at a time and the
sequence scanned step by step, in blocks of rows so that it fits beside the
served model's weights.  It imports nothing of the program.

``quant="fp8"`` is the correctness check's control: every matrix product
takes its weight (per tensor) and its input (per row) rounded to float8
e4m3 with a scale, the step below the bfloat16 that the configuration
computes in.  Nothing else changes.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

FP8_MAX = 448.0  # largest finite float8 e4m3fn


# --------------------------------------------------------------- the weights
def mamba_leaves(m: dict) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """One Mamba mixer's weights: name -> (shape, init kind)."""
    d, di = m["d_model"], m["ssm_expand"] * m["d_model"]
    st, dc, dr = m["ssm_d_state"], m["ssm_d_conv"], dt_rank(m)
    return {
        "ln1": ((d,), "ones"),
        "in_proj": ((d, 2 * di), "dense"),
        "conv_w": ((dc, di), "dense"),
        "conv_b": ((di,), "zeros"),
        "x_proj": ((di, dr + 2 * st), "dense"),
        "dt_proj": ((dr, di), "dense"),
        "dt_bias": ((di,), "dt_bias"),
        "A_log": ((di, st), "a_log"),
        "D": ((di,), "ones"),
        "out_proj": ((di, d), "dense"),
    }


def dt_rank(m: dict) -> int:
    return m["dt_rank"]


def top_leaves(m: dict) -> List[Tuple[Tuple, Tuple[int, ...], str]]:
    """The embedding (rows padded to a multiple of 256, as the program
    holds them), the final norm and an untied unembedding."""
    d, vp = m["d_model"], padded_vocab(m)
    out = [(("embed",), (vp, d), "embed"), (("final_ln",), (d,), "ones")]
    if not m["tie_embeddings"]:
        out.append((("unembed",), (d, vp), "dense"))
    return out


def padded_vocab(m: dict) -> int:
    return (m["vocab"] + 255) // 256 * 256


def leaves(m: dict) -> List[Tuple[Tuple, Tuple[int, ...], str]]:
    """Every weight as (path, shape with the period axis, init kind)."""
    n_periods = m["n_layers"] // len(m["layout"])
    out = top_leaves(m)
    for i, (mixer, mlp) in enumerate(m["layout"]):
        if (mixer, mlp) != ("mamba", "none"):
            raise ValueError(f"a Mamba-1 model has only Mamba layers, got {mixer}/{mlp}")
        out += [(("layers", i, k), (n_periods, *s), kind)
                for k, (s, kind) in mamba_leaves(m).items()]
    return out


def float32_leaf(name: str) -> bool:
    """Leaves the served model holds in float32; the rest are bfloat16."""
    return name in ("A_log", "final_ln")


# ------------------------------------------------------------ plain pieces
def f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


def fp8_round(t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a scale that maps its largest
    magnitude (over ``dim``, or the whole tensor) to the format's largest."""
    amax = t.abs().amax() if dim is None else t.abs().amax(dim=dim, keepdim=True)
    scale = torch.clamp(amax, min=1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def linear(x: torch.Tensor, w: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """x @ w in float32; under the fp8 control both rounded first."""
    w = f32(w)
    if quant == "fp8":
        return fp8_round(x, -1) @ fp8_round(w, None)
    if quant is not None:
        raise ValueError(f"unknown quant {quant!r}")
    return x @ w


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * f32(w)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 20.0, x, torch.log1p(torch.exp(torch.clamp(x, max=20.0))))


def mamba_mixer(p: Dict[str, torch.Tensor], u: torch.Tensor, m: dict,
                quant: Optional[str], chunk: int = 32) -> torch.Tensor:
    """The mixer over whole sequences u (R, T, d), float32."""
    R, T, _ = u.shape
    di, st, K = m["ssm_expand"] * m["d_model"], m["ssm_d_state"], m["ssm_d_conv"]
    dr = dt_rank(m)
    xz = linear(u, p["in_proj"], quant)
    x, z = xz[..., :di], xz[..., di:]
    w = f32(p["conv_w"])  # (K, di): tap K-1 multiplies the current position
    conv = f32(p["conv_b"]).expand(R, T, di).clone()
    for j in range(K):
        shift = K - 1 - j
        if shift < T:
            conv[:, shift:] += x[:, :T - shift] * w[j]
    x = silu(conv)
    del conv, xz
    dbl = linear(x, p["x_proj"], quant)
    dt = softplus(linear(dbl[..., :dr].contiguous(), p["dt_proj"], quant) + f32(p["dt_bias"]))
    Bm, Cm = dbl[..., dr:dr + st], dbl[..., dr + st:]
    A = -torch.exp(f32(p["A_log"]))  # (di, st)
    h = u.new_zeros((R, di, st))
    y = torch.empty_like(x)
    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        decay = torch.exp(dt[:, t0:t1, :, None] * A)  # (R, L, di, st)
        drive = (dt[:, t0:t1] * x[:, t0:t1])[..., None] * Bm[:, t0:t1, None, :]
        readout = Cm[:, t0:t1, :, None].contiguous()  # (R, L, st, 1)
        ys = []
        for t in range(t1 - t0):
            h = torch.addcmul(drive[:, t], decay[:, t], h)
            ys.append(torch.bmm(h, readout[:, t]))  # (R, di, 1)
        y[:, t0:t1] = torch.cat(ys, dim=2).transpose(1, 2)
    y = (y + x * f32(p["D"])) * silu(z)
    return linear(y, p["out_proj"], quant)


def layer_weights(weights, position: int, period: int) -> Dict[str, torch.Tensor]:
    return {k: v[period] for k, v in weights["layers"][position].items()}


def final_logits(m: dict, weights, x: torch.Tensor, quant: Optional[str]) -> torch.Tensor:
    """(R, P, d) hidden states -> (R, P, vocab) float32 logits."""
    x = rms_norm(x, weights["final_ln"], m["norm_eps"])
    table = weights["embed"].T if m["tie_embeddings"] else weights["unembed"]
    return linear(x, table, quant)[..., :m["vocab"]]


def row_blocks(n: int, size: int) -> List[slice]:
    return [slice(i, min(n, i + size)) for i in range(0, n, size)]


# ------------------------------------------------------------------ logits
@torch.no_grad()
def logits(m: dict, weights, tokens: torch.Tensor, n_last: int, *,
           groups: Optional[Sequence[Sequence[int]]] = None, prompt_len: Optional[int] = None,
           quant: Optional[str] = None, rows_per_block: int = 32) -> torch.Tensor:
    """Float32 logits at the last ``n_last`` positions of each row of
    ``tokens`` (R, T): (R, n_last, vocab).  ``groups`` and ``prompt_len``
    are the batching a model with routed layers needs; a Mamba-1 model's
    rows are independent."""
    del groups, prompt_len
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        R = tokens.shape[0]
        n_periods = m["n_layers"] // len(m["layout"])
        table = weights["embed"]
        out = []
        for rows in row_blocks(R, rows_per_block):
            x = f32(table[tokens[rows]])
            for period in range(n_periods):
                for i in range(len(m["layout"])):
                    p = layer_weights(weights, i, period)
                    x = x + mamba_mixer(p, rms_norm(x, p["ln1"], m["norm_eps"]), m, quant)
            out.append(final_logits(m, weights, x[:, -n_last:], quant))
        return torch.cat(out)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
