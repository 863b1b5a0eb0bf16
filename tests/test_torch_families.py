"""MLA, M-RoPE and the modality stubs in the port, held against the JAX package on the CPU.

minicpm3-4b (MLA), qwen2-vl-2b (M-RoPE, vision stub) and hubert-xlarge
(audio stub, a bidirectional encoder) at smoke size, with JAX's weights
carried across (``convert.params_from_jax``) and numpy inputs made from a
seed (``synthetic_batch`` gives both packages the same ``embeds``,
``visual_embeds`` and ``pos3``).  float32 throughout, at the model tests'
rtol 1e-4 / atol 1e-3 for logits and rtol 1e-4 / atol 1e-6 for gradients
(tests/test_torch_train.py).  The smoke MLA config has v_head_dim equal
to its qk dim (8 + 8 = 16), so the MLA cases here also take a config with
qk 16 + 8 = 24 against v 16: a padding fault in ``ops.flash_attention``
shows only there.  Also the port's twins of tests/test_models.py:17
(every config forward, loss and gradients), :161 and :169 (parameter
counts).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.common import init_params as j_init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import MLA, init_params as t_init_params  # noqa: E402

F32 = dict(rtol=1e-4, atol=1e-3)
GRAD = dict(rtol=1e-4, atol=1e-6)
B, S = 2, 40
MLA_DV = dict(qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16)  # qk 24, v 16


def _cfgs(arch, **replace):
    jcfg = dataclasses.replace(jconfigs.smoke(arch), compute_dtype=jnp.float32, **replace)
    tcfg = dataclasses.replace(tconfigs.smoke(arch), compute_dtype=torch.float32, **replace)
    return jcfg, tcfg


def _carried(jcfg, tcfg, seed=1):
    """JAX's master weights, and the port's float32 copy of them."""
    jp = j_init_params(jcfg, jax.random.key(seed))
    return jp, convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")


def _batches(jcfg, tcfg, S=S, seed=3):
    """synthetic_batch of both packages: the same values (held in
    tests/test_torch_train.py), each in its own container."""
    return JD.synthetic_batch(jcfg, B, S, seed=seed), \
        TD.synthetic_batch(tcfg, B, S, seed=seed, device="cpu")


def _prefix(batch, n):
    """The batch cut to its first ``n`` positions, labels dropped."""
    out = {}
    for k, v in batch.items():
        if k == "pos3":
            out[k] = v[..., :n]
        elif k in ("tokens", "embeds"):
            out[k] = v[:, :n]
        elif k != "labels":
            out[k] = v
    return out


def _np(x):
    return np.asarray(x, np.float32) if not isinstance(x, torch.Tensor) else x.float().numpy()


# ---------------------------------------------------------------- M-RoPE
@pytest.mark.parametrize("dim,sections,theta", [
    (16, (2, 3, 3), 1e6),  # qwen2-vl smoke
    (128, (16, 24, 24), 1e6),  # qwen2-vl-2b
    (24, (4, 4, 4), 1e4),
])
def test_mrope_cos_sin_and_text_positions_match_jax(dim, sections, theta):
    """Positions exactly; cos/sin exactly the port's RoPE of each pair's
    section row, and within atol 1e-6 of JAX's (the RoPE test's tolerance):
    the angles are equal bit for bit (the same float32 frequencies and
    products), but XLA's CPU cos/sin and torch's differ by one or two ulp
    on ~5 % of them."""
    pos3 = TD.make_pos3(B, 50, 13)
    assert np.array_equal(pos3, JD.make_pos3(B, 50, 13))
    sec = np.repeat(np.arange(3), sections)
    for p in (pos3, np.array(JL.mrope_text_positions(B, 50, 7))):
        cj, sj = JL.mrope_cos_sin(jnp.asarray(p), dim, sections, theta)
        ct, st = TL.mrope_cos_sin(torch.from_numpy(p), dim, sections, theta)
        assert ct.dtype == st.dtype == torch.float32 and tuple(ct.shape) == cj.shape
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-6)
        np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-6)
        rows = [TL.rope_cos_sin(torch.from_numpy(p[r]), dim, theta) for r in range(3)]
        for i, r in enumerate(sec):
            assert torch.equal(ct[..., i], rows[r][0][..., i])
            assert torch.equal(st[..., i], rows[r][1][..., i])
    got = TL.mrope_text_positions(B, 50, 7)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(JL.mrope_text_positions(B, 50, 7)))
    with pytest.raises(AssertionError):
        TL.mrope_cos_sin(torch.from_numpy(pos3), dim + 2, sections, theta)


def test_text_only_mrope_is_plain_rope():
    """t = h = w: each section's row is the same, so M-RoPE gives RoPE's
    angles (serve's text prompts exercise no section logic)."""
    p = TL.text_positions(B, 30, 5)
    got = TL.mrope_cos_sin(TL.mrope_text_positions(B, 30, 5), 128, (16, 24, 24), 1e6)
    want = TL.rope_cos_sin(p, 128, 1e6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------------- whole models
@pytest.mark.parametrize("arch,replace", [
    ("minicpm3-4b", {}), ("minicpm3-4b", MLA_DV), ("qwen2-vl-2b", {}), ("hubert-xlarge", {}),
])
def test_forward_loss_and_grads_match_jax_float32(arch, replace):
    """forward logits, loss, metrics and every gradient on the families'
    own inputs: MLA tokens, vision-stub tokens + visual_embeds + pos3,
    audio-stub embeds (hubert trains on them; its embedding table gets a
    zero gradient in both packages)."""
    jcfg, tcfg = _cfgs(arch, **replace)
    jp, tp = _carried(jcfg, tcfg)
    jb, tb = _batches(jcfg, tcfg)
    want = JM.forward(jcfg, jp, jb)
    got = TM.forward(tcfg, TM.compute_params(tcfg, tp), tb)
    assert tuple(got.shape) == want.shape == (B, S, jcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)

    fn = lambda p: JM.loss_and_metrics(jcfg, p, jb, JM.ShardCtx(), 8)  # noqa: E731
    (jl, jm), jg = jax.value_and_grad(fn, has_aux=True)(jp)
    live = [t.detach().requires_grad_(True) for t in T.leaves(tp)]
    tl, tm = TM.loss_and_metrics(tcfg, T.unflatten(tp, live), tb, TM.ShardCtx(remat="block"), 8)
    tg = torch.autograd.grad(tl, live, allow_unused=True)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    assert float(tm["tokens"]) == float(jm["tokens"]) == B * S
    np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), atol=1e-7)
    for name, g, w in zip(convert.flat_names(tp), tg, jax.tree.leaves(jg)):
        g = torch.zeros(w.shape) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD)
    if arch == "hubert-xlarge":
        assert tg[convert.flat_names(tp).index("['embed']")] is None
        assert not np.asarray(jg["embed"]).any()


@pytest.mark.parametrize("arch,replace", [
    ("minicpm3-4b", {}), ("minicpm3-4b", MLA_DV), ("qwen2-vl-2b", {}),
])
def test_prefill_cache_and_decode_match_jax_on_the_families_inputs(arch, replace):
    """prefill(S-1) + decode of the last token, with qwen2-vl's batch
    carrying visual_embeds and pos3; the caches (MLA: the latent ckv and
    the rope key, zero-padded to max_seq) equal JAX's, and a second decode
    step too."""
    jcfg, tcfg = _cfgs(arch, **replace)
    jp, tp = _carried(jcfg, tcfg)
    tp = TM.compute_params(tcfg, tp)
    jb, tb = _batches(jcfg, tcfg)
    if arch == "qwen2-vl-2b":
        assert "visual_embeds" in tb and tuple(tb["pos3"].shape) == (3, B, S)
    max_seq = S + 3
    jl, jc = JM.prefill(jcfg, jp, _prefix(jb, S - 1), max_seq=max_seq)
    tl, tc = TM.prefill(tcfg, tp, _prefix(tb, S - 1), max_seq=max_seq)
    np.testing.assert_allclose(_np(tl)[..., :jcfg.vocab], _np(jl)[..., :jcfg.vocab], **F32)
    assert tc["pos"] == int(jc["pos"]) == S - 1
    for j_layer, t_layer in zip(jc["layers"], tc["layers"]):
        assert list(t_layer) == list(j_layer)
        for name in t_layer:
            assert tuple(t_layer[name].shape) == j_layer[name].shape
            np.testing.assert_allclose(_np(t_layer[name]), _np(j_layer[name]), rtol=1e-5,
                                       atol=1e-5, err_msg=name)
    toks = np.asarray(JD.synthetic_batch(jcfg, B, S + 1, seed=9)["tokens"])[:, -2:]
    for i in range(2):
        jl, jc = JM.decode_step(jcfg, jp, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = TM.decode_step(tcfg, tp, tc, torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(_np(tl)[..., :jcfg.vocab], _np(jl)[..., :jcfg.vocab], **F32)
    assert tc["pos"] == S + 1


@pytest.mark.parametrize("replace", [{}, MLA_DV])
def test_mla_decode_matches_forward(replace):
    """Twin of tests/test_models.py:44 for MLA: prefill + absorbed decode
    against the full forward, token by token."""
    _, tcfg = _cfgs("minicpm3-4b", **replace)
    tp = t_init_params(tcfg, 1, "cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(0, tcfg.vocab, (B, 16))
                            .astype(np.int32))
    full = TM.forward(tcfg, tp, {"tokens": toks})
    _, cache = TM.prefill(tcfg, tp, {"tokens": toks[:, :12]}, max_seq=16)
    for i in range(12, 16):
        logits, cache = TM.decode_step(tcfg, tp, cache, toks[:, i:i + 1])
        np.testing.assert_allclose(logits[:, 0, :tcfg.vocab].numpy(), full[:, i].numpy(), **F32)


def test_mla_prefill_reaches_the_flash_wrapper_with_v_padded_like_qk(monkeypatch):
    """Every MLA prefill layer calls the flash wrapper once, with q, k and v
    padded to one kernel head dim (the kernel takes k.shape == v.shape) and
    the qk scale 1/sqrt(nope + rope), not 1/sqrt(padded width)."""
    _, tcfg = _cfgs("minicpm3-4b", **MLA_DV)
    tp = TM.compute_params(tcfg, t_init_params(tcfg, 1, "cpu"))
    seen, real = [], tfa.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw["scale"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(tfa, "flash_attention", spy)
    toks = torch.zeros((B, 10), dtype=torch.int32)
    TM.prefill(tcfg, tp, {"tokens": toks}, max_seq=12)
    H = tcfg.n_heads
    assert seen == [((B, 10, H, 64), (B, 10, H, 64), (B, 10, H, 64), 1 / 24 ** 0.5)] * \
        tcfg.n_layers


# ----------------------------------------------------- every config
@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_smoke_forward_and_train_step(arch):
    """Twin of tests/test_models.py:17: forward, loss and gradients of every
    smoke config on its synthetic batch, finite, at least one non-zero."""
    cfg = tconfigs.smoke(arch)
    params = t_init_params(cfg, 0, "cpu")
    batch = TD.synthetic_batch(cfg, 2, 32, seed=1, device="cpu")
    logits = TM.forward(cfg, TM.compute_params(cfg, params), batch)
    assert tuple(logits.shape) == (2, 32, cfg.vocab)
    assert torch.isfinite(logits).all(), arch
    live = [t.detach().requires_grad_(True) for t in T.leaves(params)]
    loss, _ = TM.loss_and_metrics(cfg, T.unflatten(params, live), batch)
    grads = [g for g in torch.autograd.grad(loss, live, allow_unused=True) if g is not None]
    assert torch.isfinite(loss), arch
    assert all(torch.isfinite(g).all() for g in grads), arch
    assert sum(float(g.abs().sum()) for g in grads) > 0


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_param_count_analytic_vs_actual(arch):
    """Twin of tests/test_models.py:161, over every config's smoke size."""
    cfg = tconfigs.smoke(arch)
    actual = sum(t.numel() for _, t in T.paths(t_init_params(cfg, 0, "cpu")))
    assert actual == cfg.n_params() == jconfigs.smoke(arch).n_params()


def test_full_config_param_counts():
    """Twin of tests/test_models.py:169: full configs near their nameplates."""
    expect = {
        "falcon-mamba-7b": (6.5e9, 8.5e9),
        "qwen3-moe-30b-a3b": (28e9, 32e9),
        "jamba-v0.1-52b": (49e9, 56e9),
        "granite-moe-1b-a400m": (1.0e9, 1.7e9),
        "gemma2-2b": (2.2e9, 3.5e9),
        "gemma-2b": (2.0e9, 3.0e9),
        "minicpm3-4b": (3.5e9, 5.0e9),
        "h2o-danube-3-4b": (3.5e9, 4.6e9),
        "hubert-xlarge": (0.8e9, 1.3e9),
        "qwen2-vl-2b": (1.2e9, 2.3e9),
    }
    for arch, (lo, hi) in expect.items():
        n = tconfigs.get_config(arch).n_params()
        assert lo <= n <= hi, f"{arch}: {n/1e9:.2f}B not in [{lo/1e9}, {hi/1e9}]"
    assert tconfigs.get_config("minicpm3-4b").n_params() == 4_073_937_408
    assert tconfigs.get_config("qwen2-vl-2b").n_params() == 1_543_853_568
    assert tconfigs.get_config("hubert-xlarge").n_params() == 945_153_280
    assert tconfigs.get_config("minicpm3-4b").layout[0].mixer == MLA


def test_hubert_trains_through_launch_train_on_its_embeds(tmp_path):
    """launch.train.train on the audio stub: the stream's embeds reach
    loss_and_metrics, the loss is finite and falls over a fixed stream."""
    from repro_torch.launch.train import train

    out = train(arch="hubert-xlarge", steps=4, global_batch=2, seq=16, log_every=100,
                monitor_dir=str(tmp_path), device="cpu")
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert out["monitor"]["frames"] == 4
