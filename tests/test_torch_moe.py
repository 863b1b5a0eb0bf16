"""Port's MoE MLP (repro_torch.models.moe) and the MoE model families vs the JAX package, on the CPU.

``moe_block`` and ``moe_aux_loss`` take the same numpy inputs in both
packages, on the smoke configs of granite-moe, qwen3-moe and jamba
(8 experts, top-2).  Model-level tests carry JAX's weights across with
``convert.params_from_jax``.  float32 is held at rtol 1e-5 / atol 1e-6
for the block and at tests/test_models.py's rtol 1e-4 / atol 1e-3 for
the logits; bf16 at tests/test_torch_models.py's 2e-2, against JAX run
in a child process with XLA's excess precision off (see there).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models.common import init_params as j_init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.common import init_params as t_init_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "jamba-v0.1-52b"]
MODEL_ARCHS = ["granite-moe-1b-a400m", "jamba-v0.1-52b"]
# In bf16 a router logit may land one ulp from JAX's (the GEMMs sum in
# another order: ~1e-4 of bf16 logits at granite's full width), and at a
# near-tie that flips a top-k choice, after which the token's row and the
# capacity slots behind it differ by far more than 2e-2.  jamba's 16-layer
# smoke model meets such a flip (its bf16 forward differs by up to 0.31
# from token 15 of the first sequence on); granite's 2-layer one does not.
# jamba is held in float32 at the model level and in bf16 block by block.
BF16_MODEL_ARCHS = ["granite-moe-1b-a400m"]
MODES = ["forward", "prefill", "decode"]
BLOCK_F32 = dict(rtol=1e-5, atol=1e-6)
LOGITS_F32 = dict(rtol=1e-4, atol=1e-3)
BF16 = dict(rtol=2e-2, atol=2e-2)
# case -> (B, S, moe_capacity_factor, tied router)
CASES = {
    "ample": (2, 24, 8.0, False),
    "tight": (4, 40, 1.0, False),  # N 160, C 40: the busiest experts drop pairs
    "starved": (4, 40, 0.25, False),  # C 16: some tokens lose both pairs
    "ties": (2, 24, 1.25, True),
    "decode": (4, 1, 1.25, False),  # N 4, C 4: dropless
}
B, S = 2, 40  # model-level inputs (as tests/test_torch_models.py)


def _cfgs(arch, f32, cf=None):
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    if f32:
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe_capacity_factor=cf)
        tcfg = dataclasses.replace(tcfg, moe_capacity_factor=cf)
    return jcfg, tcfg


def _block_inputs(arch, case):
    """One MoE layer's weights (JAX's init, first period) and its input, as
    float32 numpy.  Tied routers copy router columns 0 -> 1, 2 and 3 -> 4,
    5 and 6 -> 7, so a token whose top group is (0, 1, 2) or (3, 4, 5) has
    a tie at the k-th (2nd) place."""
    Bc, Sc, cf, tied = CASES[case]
    jcfg, _ = _cfgs(arch, f32=True, cf=cf)
    jp = j_init_params(jcfg, jax.random.key(1))
    i = [s.mlp for s in jcfg.layout].index("moe")
    p = {k: np.array(jp["layers"][i][k][0]) for k in TMOE.KEYS}
    if tied:
        for src, dst in ((0, (1, 2)), (3, (4, 5)), (6, (7,))):
            p["router"][:, list(dst)] = p["router"][:, [src]]
    x = np.random.default_rng(3).normal(0, 1, (Bc, Sc, jcfg.d_model)).astype(np.float32)
    return p, x


def _jax_block(arch, case, f32):
    p, x = _block_inputs(arch, case)
    jcfg, _ = _cfgs(arch, f32, cf=CASES[case][2])
    dt = jcfg.compute_dtype
    out = JMOE.moe_block({k: jnp.asarray(v, dt) for k, v in p.items()}, jnp.asarray(x, dt),
                         jcfg)
    return np.asarray(out, np.float32)


def _port_block(arch, case, f32):
    p, x = _block_inputs(arch, case)
    _, tcfg = _cfgs(arch, f32, cf=CASES[case][2])
    dt = tcfg.compute_dtype
    out = TMOE.moe_block({k: torch.from_numpy(v).to(dt) for k, v in p.items()},
                         torch.from_numpy(x).to(dt), tcfg)
    return out.float().numpy()


def _carried(jcfg, tcfg, seed=1):
    jp = j_init_params(jcfg, jax.random.key(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jp, TM.compute_params(tcfg, tp)


def _tokens(vocab, seed=2, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _jax_logits(jcfg, jp, toks, mode):
    t = jnp.asarray(toks)
    if mode == "forward":
        out = JM.forward(jcfg, jp, {"tokens": t})
    elif mode == "prefill":
        out, _ = JM.prefill(jcfg, jp, {"tokens": t[:, :-1]}, max_seq=S + 3)
    else:
        _, cache = JM.prefill(jcfg, jp, {"tokens": t[:, :-1]}, max_seq=S + 3)
        out, _ = JM.decode_step(jcfg, jp, cache, t[:, -1:])
    return np.asarray(out, np.float32)


def _port_logits(tcfg, tp, toks, mode):
    t = torch.from_numpy(toks)
    if mode == "forward":
        out = TM.forward(tcfg, tp, {"tokens": t})
    elif mode == "prefill":
        out, _ = TM.prefill(tcfg, tp, {"tokens": t[:, :-1]}, max_seq=S + 3)
    else:
        _, cache = TM.prefill(tcfg, tp, {"tokens": t[:, :-1]}, max_seq=S + 3)
        out, cache = TM.decode_step(tcfg, tp, cache, t[:, -1:])
        assert cache["pos"] == S
    return out.float().numpy()


# ------------------------------------------------------------ moe_block
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax_float32(arch, case):
    got, want = _port_block(arch, case, True), _jax_block(arch, case, True)
    assert got.shape == want.shape and np.isfinite(got).all()
    # a token that lost all k pairs gives an exact zero row: the same rows
    zero_rows = lambda a: set(np.flatnonzero(~a.reshape(-1, a.shape[-1]).any(-1)))  # noqa: E731
    assert zero_rows(got) == zero_rows(want)
    if case == "starved":
        assert zero_rows(got), "no token lost both pairs: the case tests nothing"
    np.testing.assert_allclose(got, want, **BLOCK_F32)


@pytest.mark.parametrize("case", ["tight", "starved", "ties"])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_and_capacity_match_jax(arch, case):
    """The top-k ids equal ``jax.lax.top_k``'s (ties keep the lower index),
    and the capacity is JAX's formula: the busiest expert overflows it in
    the tight cases, so pairs really drop."""
    p, x = _block_inputs(arch, case)
    jcfg, tcfg = _cfgs(arch, True, cf=CASES[case][2])
    xt = x.reshape(-1, x.shape[-1])
    probs_t, _, ids_t = TMOE._route({"router": torch.from_numpy(p["router"])},
                                     torch.from_numpy(xt), tcfg.moe_topk)
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(p["router"]), axis=-1)
    _, ids_j = jax.lax.top_k(jprobs, jcfg.moe_topk)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    N = xt.shape[0]
    C = TMOE.capacity(tcfg, N)
    assert C == max(int(np.ceil(jcfg.moe_topk * N / jcfg.moe_experts * jcfg.moe_capacity_factor)),
                    min(N, 16))
    if case == "ties":
        srt = np.sort(probs_t.numpy(), -1)[:, ::-1]
        k = tcfg.moe_topk
        assert (srt[:, k - 1] == srt[:, k]).sum() > 0, "no tie at the k-th place"
        assert (np.asarray(jnp.sort(jprobs, -1))[:, ::-1][:, k - 1]
                == np.asarray(jnp.sort(jprobs, -1))[:, ::-1][:, k]).sum() > 0
    else:
        assert np.bincount(ids_t.numpy().ravel(), minlength=tcfg.moe_experts).max() > C


def test_moe_block_is_bitwise_repeatable_and_refuses_expert_parallelism(tmp_path):
    """Two calls are bitwise equal; on a one-rank gloo mesh
    ``ep=EPInfo("model", 1)`` (every expert local, one all-reduce) equals
    ``ep=None`` bitwise, in bf16 and in float32.  It refuses an EPInfo
    without its mesh, and expert leaves that are not the rank's share.
    Four ranks: tests/test_torch_seq_parallel.py."""
    import torch.distributed as dist

    from repro_torch import compat

    p, x = _block_inputs("granite-moe-1b-a400m", "tight")
    _, tcfg = _cfgs("granite-moe-1b-a400m", False, cf=1.0)
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p.items()}
    tx = torch.from_numpy(x).to(torch.bfloat16)
    a, b = TMOE.moe_block(tp, tx, tcfg), TMOE.moe_block(tp, tx, tcfg)
    assert torch.equal(a, b) and a.dtype == torch.bfloat16
    _, f32 = _cfgs("granite-moe-1b-a400m", True, cf=1.0)
    fp = {k: torch.from_numpy(v) for k, v in p.items()}
    fx = torch.from_numpy(x)
    with pytest.raises(ValueError, match="mesh"):
        TMOE.moe_block(tp, tx, tcfg, ep=TMOE.EPInfo("model", 1))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        ep = TMOE.EPInfo("model", 1, compat.make_mesh((1,), ("model",), device="cpu"))
        assert torch.equal(TMOE.moe_block(tp, tx, tcfg, ep=ep), a)
        assert torch.equal(TMOE.moe_block(fp, fx, f32, ep=ep), TMOE.moe_block(fp, fx, f32))
        with pytest.raises(ValueError, match="experts"):
            TMOE.moe_block(tp, tx, tcfg, ep=TMOE.EPInfo("model", 2, ep.mesh))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_aux_loss_matches_jax(arch):
    for case in ("ample", "ties"):
        p, x = _block_inputs(arch, case)
        jcfg, tcfg = _cfgs(arch, True)
        want = float(JMOE.moe_aux_loss({k: jnp.asarray(v) for k, v in p.items()},
                                       jnp.asarray(x), jcfg))
        got = TMOE.moe_aux_loss({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x), tcfg)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), want, rtol=1e-5)


def test_moe_matches_dense_routing_reference():
    """Twin of tests/test_models.py:92 on the port: the sort-based capacity
    dispatch equals a naive float64 per-token loop (ample capacity)."""
    cfg = dataclasses.replace(tconfigs.smoke("granite-moe-1b-a400m"), moe_capacity_factor=8.0)
    p = t_init_params(dataclasses.replace(cfg, n_layers=1), 4, "cpu")["layers"][0]
    sub = {k: p[k][0] for k in TMOE.KEYS}
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (2, 8, cfg.d_model))
                         .astype(np.float32))
    out = TMOE.moe_block(sub, x, cfg).reshape(-1, cfg.d_model).numpy().astype(np.float64)
    xt = x.reshape(-1, cfg.d_model).numpy().astype(np.float64)
    w = {k: v.numpy().astype(np.float64) for k, v in sub.items()}
    logits = xt @ w["router"]
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    ref = np.zeros_like(xt)
    for i in range(xt.shape[0]):
        top = np.argsort(probs[i])[::-1][: cfg.moe_topk]
        wt = probs[i, top] / probs[i, top].sum()
        for e, we in zip(top, wt):
            g, u = xt[i] @ w["moe_gate"][e], xt[i] @ w["moe_up"][e]
            ref[i] += we * (((g / (1 + np.exp(-g))) * u) @ w["moe_down"][e])
    np.testing.assert_allclose(out, ref, rtol=2e-3, atol=2e-3)


# ---------------------------------------------------------- whole model
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_moe_logits_match_jax_float32(arch, mode):
    jcfg, tcfg = _cfgs(arch, f32=True)
    jp, tp = _carried(jcfg, tcfg)
    toks = _tokens(jcfg.vocab)
    got, want = _port_logits(tcfg, tp, toks, mode), _jax_logits(jcfg, jp, toks, mode)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got[..., :jcfg.vocab], want[..., :jcfg.vocab], **LOGITS_F32)


_BF16_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import numpy as np
sys.path.insert(0, sys.argv[2])
import test_torch_moe as T
out = {}
for arch in T.ARCHS:
    for case in T.CASES:
        out[f"block/{arch}/{case}"] = T._jax_block(arch, case, False)
for arch in T.BF16_MODEL_ARCHS:
    jcfg, _ = T._cfgs(arch, f32=False)
    jp = T.j_init_params(jcfg, T.jax.random.key(1))
    for mode in T.MODES:
        out[f"model/{arch}/{mode}"] = T._jax_logits(jcfg, jp, T._tokens(jcfg.vocab), mode)
np.savez(sys.argv[1], **out)
print("BF16_OK")
"""


@pytest.fixture(scope="module")
def jax_bf16(tmp_path_factory):
    path = tmp_path_factory.mktemp("bf16") / "moe.npz"
    r = subprocess.run(
        [sys.executable, "-c", _BF16_SCRIPT, str(path), str(REPO / "tests")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"},
    )
    assert "BF16_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_jax_bf16(arch, case, jax_bf16):
    np.testing.assert_allclose(_port_block(arch, case, False),
                               jax_bf16[f"block/{arch}/{case}"], **BF16)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", BF16_MODEL_ARCHS)
def test_moe_logits_match_jax_bf16(arch, mode, jax_bf16):
    jcfg, tcfg = _cfgs(arch, f32=False)
    _, tp = _carried(jcfg, tcfg)
    got = _port_logits(tcfg, tp, _tokens(jcfg.vocab), mode)
    want = jax_bf16[f"model/{arch}/{mode}"]
    np.testing.assert_allclose(got[..., :jcfg.vocab], want[..., :jcfg.vocab], **BF16)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_moe_decode_matches_forward(arch):
    """Twin of tests/test_models.py:44 (its jamba case) on the port alone:
    ample capacity, as there, so the 15-token prefill and the 16-token
    forward drop nothing."""
    tcfg = dataclasses.replace(tconfigs.smoke(arch), compute_dtype=torch.float32,
                               moe_capacity_factor=16.0)
    tp = t_init_params(tcfg, 1, "cpu")
    toks = torch.from_numpy(_tokens(tcfg.vocab, 2, (B, 16)))
    full = TM.forward(tcfg, tp, {"tokens": toks})
    _, cache = TM.prefill(tcfg, tp, {"tokens": toks[:, :15]}, max_seq=16)
    logits, _ = TM.decode_step(tcfg, tp, cache, toks[:, 15:])
    np.testing.assert_allclose(logits[:, 0, :tcfg.vocab].numpy(), full[:, -1].numpy(),
                               **LOGITS_F32)


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_moe_serve_matches_jax_with_carried_weights(arch, monkeypatch):
    """float32 smoke model: identical generated tokens (as
    tests/test_torch_serve.py holds gemma-2b and falcon-mamba-7b)."""
    f32 = {"j": dataclasses.replace(jconfigs.smoke(arch), compute_dtype=jnp.float32),
           "t": dataclasses.replace(tconfigs.smoke(arch), compute_dtype=torch.float32)}
    monkeypatch.setattr(jserve.configs, "smoke", lambda arch: f32["j"])
    monkeypatch.setattr(tserve.configs, "smoke", lambda arch: f32["t"])
    kw = dict(arch=arch, n_requests=3, batch=2, prompt_len=12, max_new=6, seed=4)
    jp = jax.tree.map(np.asarray, j_init_params(f32["j"], jax.random.key(4)))
    want = jserve.serve(**kw)
    got = tserve.serve(params=convert.params_from_jax(jp, f32["t"], device="cpu"),
                       device="cpu", **kw)
    assert got["samples"] == want["samples"]
    assert (got["requests"], got["tokens"]) == (want["requests"], want["tokens"]) == (3, 18)


def test_moe_loss_and_grads_match_jax_float32():
    """One granite-moe smoke train step's loss and gradients against JAX's
    ``value_and_grad``: routing weights carry gradient through the top-k,
    the dispatch and the combine."""
    jcfg, tcfg = _cfgs("granite-moe-1b-a400m", f32=True)
    jp = j_init_params(jcfg, jax.random.key(1))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    rng = np.random.default_rng(0)
    toks, labels = (rng.integers(0, jcfg.vocab, (2, 24)).astype(np.int32) for _ in range(2))
    fn = lambda p: JM.loss_and_metrics(  # noqa: E731
        jcfg, p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}, JM.ShardCtx(), 8)
    (jl, _), jg = jax.value_and_grad(fn, has_aux=True)(jp)
    live = [t.detach().requires_grad_(True) for t in T.leaves(tp)]
    tl, _ = TM.loss_and_metrics(tcfg, T.unflatten(tp, live),
                                {"tokens": torch.from_numpy(toks),
                                 "labels": torch.from_numpy(labels)}, TM.ShardCtx(), 8)
    tg = torch.autograd.grad(tl, live)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    names = convert.flat_names(tp)
    assert len(tg) == len(jax.tree.leaves(jg)) and any("router" in n for n in names)
    for name, g, w in zip(names, tg, jax.tree.leaves(jg)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6, err_msg=name)


# ---------------------------------------------------------- parameters
@pytest.mark.parametrize("arch,full", [
    ("granite-moe-1b-a400m", 1_334_887_424),
    ("qwen3-moe-30b-a3b", 30_532_634_624),
    ("jamba-v0.1-52b", 51_570_315_264),
])
def test_moe_param_counts_match_jax(arch, full):
    """Twin of tests/test_models.py:161-178 for the MoE archs: the smoke
    tree's leaves add up to the analytic count, both equal JAX's, and the
    published configs land on their float32 master sizes (4 bytes each)."""
    jcfg, tcfg = _cfgs(arch, f32=False)
    tp = t_init_params(tcfg, 0, "cpu")
    jp = j_init_params(jcfg, jax.random.key(0))
    assert convert.flat_names(tp) == [jax.tree_util.keystr(p) for p, _ in
                                      jax.tree_util.tree_flatten_with_path(jp)[0]]
    actual = sum(t.numel() for t in T.leaves(tp))
    assert actual == tcfg.n_params() == jcfg.n_params()
    assert tconfigs.get_config(arch).n_params() == jconfigs.get_config(arch).n_params() == full
    assert tconfigs.get_config(arch).n_active_params() == \
        jconfigs.get_config(arch).n_active_params()
