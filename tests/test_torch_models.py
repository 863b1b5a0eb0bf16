"""Port's model (repro_torch.models: dense, Mamba, MLA, M-RoPE) vs the JAX model, on the CPU.

Weights come from JAX ``init_params`` through ``convert.params_from_jax``;
tokens and activations are numpy from a seed.  In float32 compute the
logits are held at rtol 1e-4 / atol 1e-3 (tests/test_models.py:70).

In bf16 they are held at 2e-2 against the JAX model run with XLA's
``--xla_allow_excess_precision=false``.  With the default (true) XLA keeps
bf16 intermediates in float32 inside the fusions of the period scan, so
JAX's own bf16 logits move by up to 0.06 between the two settings
(gemma2-2b and h2o-danube-3-4b smoke); the port, like JAX without excess
precision, rounds after every op.  The flag is read once per process, so
those JAX runs happen in a child process.

``minicpm3-4b-dv16`` is the minicpm3-4b smoke config with qk 16 + 8 = 24
against v 16: the smoke config's own v head dim equals its qk dim, which
hides a v-padding fault on the way to the flash kernel.
"""
import dataclasses
import json
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
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.common import init_params as j_init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import init_params as t_init_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["gemma-2b", "gemma2-2b", "h2o-danube-3-4b", "falcon-mamba-7b", "minicpm3-4b",
         "minicpm3-4b-dv16", "qwen2-vl-2b"]
VARIANTS = {"minicpm3-4b-dv16": ("minicpm3-4b", dict(qk_nope_dim=16, qk_rope_dim=8,
                                                     v_head_dim=16))}
MODES = ["forward", "prefill", "decode"]
B, S = 2, 40  # S > the smoke window (32): SWA masks and ring-aligns
F32 = dict(rtol=1e-4, atol=1e-3)


def _cfgs(arch, f32):
    arch, replace = VARIANTS.get(arch, (arch, {}))
    jcfg = dataclasses.replace(jconfigs.smoke(arch), **replace)
    tcfg = dataclasses.replace(tconfigs.smoke(arch), **replace)
    if f32:
        jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
        tcfg = dataclasses.replace(tcfg, compute_dtype=torch.float32)
    return jcfg, tcfg


def _carried(jcfg, tcfg, seed=1):
    """JAX's weights, and the port's compute-dtype copy of them."""
    jp = j_init_params(jcfg, jax.random.key(seed))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jp, TM.compute_params(tcfg, tp)


def _tokens(vocab, seed=2, shape=(B, S)):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _port_logits(tcfg, tp, toks, mode):
    """forward (B,S,V) | prefill last position (B,1,Vp) | decode of the last
    token after a prefill of the others (B,1,Vp), as float32 numpy."""
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


def _close(got, want, vocab, **tol):
    np.testing.assert_allclose(got[..., :vocab], want[..., :vocab], **tol)


# --------------------------------------------------------------- layers
def test_rms_norm_and_softcap_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 5, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, 64).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = TL.rms_norm(torch.from_numpy(x).to(dt), torch.from_numpy(w), 1e-6)
        want = JL.rms_norm(jnp.asarray(x, jdt), jnp.asarray(w), 1e-6)
        assert got.dtype == dt
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=1e-6 if dt == torch.float32 else 1e-2, atol=1e-6)
    np.testing.assert_allclose(TL.softcap(torch.from_numpy(x * 20), 30.0).numpy(),
                               np.asarray(JL.softcap(jnp.asarray(x * 20), 30.0)), rtol=1e-6)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (2, 40, 4, 16)).astype(np.float32)
    pos = np.arange(40, dtype=np.int32)[None] + np.array([[0], [7]], np.int32)
    cj, sj = JL.rope_cos_sin(jnp.asarray(pos), 16, 10000.0)
    ct, st = TL.rope_cos_sin(torch.from_numpy(pos), 16, 10000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=1e-6)
    got = TL.apply_rope(torch.from_numpy(x), ct, st)
    want = JL.apply_rope(jnp.asarray(x), cj, sj)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(TL.text_positions(2, 5, 3).numpy(),
                                  np.asarray(JL.text_positions(2, 5, 3)))


_ATTN = [(True, 0, 0.0), (True, 16, 0.0), (False, 0, 0.0), (True, 0, 30.0)]


@pytest.mark.parametrize("causal,window,cap", _ATTN)
def test_attention_direct_and_chunked_match_jax(causal, window, cap):
    """Twin of tests/test_models.py:142 against both JAX paths."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(0, 1, (2, 64, h, 16)).astype(np.float32) for h in (4, 2, 2))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    kw = dict(causal=causal, window=window, cap=cap)
    want = np.asarray(JL.attention_direct(jq, jk, jv, **kw))
    np.testing.assert_allclose(TL.attention_direct(tq, tk, tv, **kw).numpy(), want,
                               rtol=2e-5, atol=2e-5)
    chunked_j = np.asarray(JL.attention_chunked(jq, jk, jv, chunk_q=16, chunk_k=16, **kw))
    chunked_t = TL.attention_chunked(tq, tk, tv, chunk_q=16, chunk_k=16, **kw).numpy()
    np.testing.assert_allclose(chunked_t, chunked_j, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(chunked_t, want, rtol=2e-5, atol=2e-5)


def test_attention_partial_matches_jax_over_a_ring_cache():
    """Decode's one-row attention over a cache with unwritten (-1) slots."""
    rng = np.random.default_rng(4)
    q = rng.normal(0, 1, (2, 1, 4, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, 12, 2, 16)).astype(np.float32) for _ in range(2))
    kpos = np.array([[12, 13, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11]], np.int32)
    kpos[0, 5] = -1
    kw = dict(causal=True, window=8, cap=20.0, scale=0.25)
    got = TL.attention_partial(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                               qpos=torch.full((1, 1), 13), kpos=torch.from_numpy(kpos), **kw)
    want = JL.attention_partial(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                qpos=jnp.full((1, 1), 13), kpos=jnp.asarray(kpos), **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", ["silu", "geglu", "gelu"])
def test_mlp_matches_jax(activation):
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 7, 32)).astype(np.float32)
    p = {n: rng.normal(0, 0.2, s).astype(np.float32)
         for n, s in (("w_gate", (32, 48)), ("w_up", (32, 48)), ("w_down", (48, 32)))}
    for dt, jdt, tol in ((torch.float32, jnp.float32, 1e-5), (torch.bfloat16, jnp.bfloat16, 1e-2)):
        got = TL.mlp({n: torch.from_numpy(a).to(dt) for n, a in p.items()},
                     torch.from_numpy(x).to(dt), activation)
        want = JL.mlp({n: jnp.asarray(a, jdt) for n, a in p.items()}, jnp.asarray(x, jdt),
                      activation)
        # bf16: the activations are written op by op as jax.nn writes them,
        # so eager JAX and the port round at the same points (XLA's tanh may
        # still land one bf16 ulp, 2**-8 relative, away).
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


# ---------------------------------------------------------- whole model
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax_float32(arch, mode):
    jcfg, tcfg = _cfgs(arch, f32=True)
    jp, tp = _carried(jcfg, tcfg)
    toks = _tokens(jcfg.vocab)
    got = _port_logits(tcfg, tp, toks, mode)
    want = _jax_logits(jcfg, jp, toks, mode)
    assert got.shape == want.shape and np.isfinite(got).all()
    _close(got, want, jcfg.vocab, **F32)


_BF16_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import numpy as np
sys.path.insert(0, sys.argv[2])
import test_torch_models as T
out = {}
for arch in T.ARCHS:
    jcfg, _ = T._cfgs(arch, f32=False)
    jp = T.j_init_params(jcfg, T.jax.random.key(1))
    for mode in T.MODES:
        out[f"{arch}/{mode}"] = T._jax_logits(jcfg, jp, T._tokens(jcfg.vocab), mode)
np.savez(sys.argv[1], **out)
print("BF16_OK")
"""


@pytest.fixture(scope="module")
def jax_bf16_logits(tmp_path_factory):
    path = tmp_path_factory.mktemp("bf16") / "logits.npz"
    r = subprocess.run(
        [sys.executable, "-c", _BF16_SCRIPT, str(path), str(REPO / "tests")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"},
    )
    assert "BF16_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(path))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_jax_bf16(arch, mode, jax_bf16_logits):
    jcfg, tcfg = _cfgs(arch, f32=False)
    _, tp = _carried(jcfg, tcfg)
    got = _port_logits(tcfg, tp, _tokens(jcfg.vocab), mode)
    _close(got, jax_bf16_logits[f"{arch}/{mode}"], jcfg.vocab, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """Twin of tests/test_models.py:44 on the port alone."""
    _, tcfg = _cfgs(arch, f32=True)
    tp = t_init_params(tcfg, 1, "cpu")
    toks = torch.from_numpy(_tokens(tcfg.vocab, 2, (B, 16)))
    full = TM.forward(tcfg, tp, {"tokens": toks})
    _, cache = TM.prefill(tcfg, tp, {"tokens": toks[:, :15]}, max_seq=16)
    logits, _ = TM.decode_step(tcfg, tp, cache, toks[:, 15:])
    np.testing.assert_allclose(logits[:, 0, :tcfg.vocab].numpy(), full[:, -1].numpy(), **F32)


def test_entry_points_take_compute_dtype_weights():
    """bf16 compute on float32 master weights is refused, not cast per call."""
    _, tcfg = _cfgs("gemma-2b", f32=False)
    master = t_init_params(tcfg, 1, "cpu")
    toks = torch.from_numpy(_tokens(tcfg.vocab, 2, (B, 8)))
    with pytest.raises(ValueError, match="compute_params"):
        TM.forward(tcfg, master, {"tokens": toks})
    cp = TM.compute_params(tcfg, master)
    assert cp["embed"].dtype == torch.bfloat16 and cp["final_ln"].dtype == torch.float32
    assert all(t.dtype == torch.bfloat16 for layer in cp["layers"] for t in layer.values())
    assert torch.equal(cp["layers"][0]["wq"], master["layers"][0]["wq"].to(torch.bfloat16))
    assert np.isfinite(TM.forward(tcfg, cp, {"tokens": toks}).float().numpy()).all()


def test_swa_ring_buffer_consistency():
    """Twin of tests/test_models.py:74, and the same decode held against JAX."""
    jcfg, tcfg = _cfgs("h2o-danube-3-4b", f32=True)
    jcfg, tcfg = (dataclasses.replace(c, window=8) for c in (jcfg, tcfg))
    jp, tp = _carried(jcfg, tcfg, seed=3)
    toks = _tokens(jcfg.vocab, 3, (1, 24))
    full = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)}).numpy()
    cache = TM.init_cache(tcfg, 1, max_seq=24, device="cpu")
    jcache = JM.init_cache(jcfg, 1, max_seq=24)
    outs, jouts = [], []
    for t in range(24):
        logits, cache = TM.decode_step(tcfg, tp, cache, torch.from_numpy(toks[:, t:t + 1]))
        jl, jcache = JM.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        outs.append(logits[:, 0, :jcfg.vocab].numpy())
        jouts.append(np.asarray(jl[:, 0, :jcfg.vocab]))
    np.testing.assert_allclose(np.stack(outs, 1), full, **F32)
    np.testing.assert_allclose(np.stack(outs, 1), np.stack(jouts, 1), **F32)
    assert cache["layers"][0]["k"].shape[2] == 8  # the ring holds the window only


@pytest.mark.parametrize("arch,S_pre,max_seq", [
    ("h2o-danube-3-4b", 40, 43),  # SWA: window 32 < S, ring-rolled
    ("h2o-danube-3-4b", 20, 43),  # SWA: zero-padded into the window
    ("gemma2-2b", 40, 40),  # max_seq == S: stored as computed
    ("gemma-2b", 12, 20),  # FULL: zero-padded to max_seq
])
def test_prefill_cache_matches_jax(arch, S_pre, max_seq):
    """Prefill's cache expansion: same slots, positions and values as JAX."""
    jcfg, tcfg = _cfgs(arch, f32=True)
    jp, tp = _carried(jcfg, tcfg)
    toks = _tokens(jcfg.vocab, 6, (B, S_pre))
    _, jc = JM.prefill(jcfg, jp, {"tokens": jnp.asarray(toks)}, max_seq=max_seq)
    _, tc = TM.prefill(tcfg, tp, {"tokens": torch.from_numpy(toks)}, max_seq=max_seq)
    assert tc["pos"] == int(jc["pos"]) == S_pre
    for jl, tl in zip(jc["layers"], tc["layers"]):
        np.testing.assert_array_equal(tl["kpos"].numpy(), np.asarray(jl["kpos"]))
        for name in ("k", "v"):
            np.testing.assert_allclose(tl[name].numpy(), np.asarray(jl[name]), rtol=1e-5,
                                       atol=1e-5)


# ---------------------------------------------------------- parameters
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_keys_shapes_dtypes_match_jax(arch):
    jcfg, tcfg = _cfgs(arch, f32=False)
    jp = j_init_params(jcfg, jax.random.key(0))
    tp = t_init_params(tcfg, 0, "cpu")
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert convert.flat_names(tp) == [jax.tree_util.keystr(path) for path, _ in jflat]
    tleaves = dict(zip(convert.flat_names(tp), (t for _, t in convert._paths(tp))))
    for path, leaf in jflat:
        t = tleaves[jax.tree_util.keystr(path)]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32 == tcfg.param_dtype
        # the same distribution: ones for norms, normal × 1/sqrt(fan_in)
        np.testing.assert_allclose(t.float().std().item(), float(np.std(leaf)), rtol=0.1,
                                   atol=1e-6)
    actual = sum(t.numel() for _, t in convert._paths(tp))
    assert actual == tcfg.n_params() == jcfg.n_params()


def test_n_params_matches_jax_for_every_config():
    for arch in tconfigs.ARCHS:
        assert tconfigs.get_config(arch).n_params() == jconfigs.get_config(arch).n_params()
        assert tconfigs.smoke(arch).n_params() == jconfigs.smoke(arch).n_params()
    assert tconfigs.get_config("gemma-2b").n_params() == 2_506_172_416


def test_params_round_trip_to_jax_is_exact():
    jcfg, tcfg = _cfgs("gemma2-2b", f32=False)
    jp = jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.key(7)))
    back = convert.params_to_numpy(convert.params_from_jax(jp, tcfg, device="cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)
    bad = {**jp, "final_ln": jp["final_ln"][:-1]}
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_jax(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="names differ"):
        convert.params_from_jax({k: v for k, v in jp.items() if k != "final_ln"}, tcfg,
                                device="cpu")


def test_configs_are_copies_of_the_jax_configs():
    """JAX's ten configurations, aliases and fields, and beside them only
    what the port alone has: its own configurations (``PORT_ONLY``) and
    fields that JAX's configurations hold at their defaults."""
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert tconfigs.ALIASES == {**jconfigs.ALIASES, **tconfigs.PORT_ONLY}
    assert json.dumps({k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()}) == \
        json.dumps({k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()})
    jfields = {f.name for f in dataclasses.fields(jconfigs.get_config("gemma-2b"))}
    port_only = {f.name: f.default for f in dataclasses.fields(tconfigs.get_config("gemma-2b"))
                 if f.name not in jfields}
    assert port_only  # the fields DeepSeek-V2 brought
    for arch in tconfigs.ARCHS:
        for t, j in ((tconfigs.get_config(arch), jconfigs.get_config(arch)),
                     (tconfigs.smoke(arch), jconfigs.smoke(arch))):
            td, jd = dataclasses.asdict(t), dataclasses.asdict(j)
            for d in (td, jd):
                d.pop("param_dtype"), d.pop("compute_dtype")
            assert {k: td.pop(k) for k in port_only} == port_only, arch
            assert td == jd, arch
            assert (t.param_dtype, t.compute_dtype) == (torch.float32, torch.bfloat16)
