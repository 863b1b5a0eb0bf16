"""Port's flash attention (plain version on the CPU) and wrappers vs the JAX package.

Inputs are made once with numpy from a seed and handed to both packages.
The Pallas kernel runs in interpret mode, as tests/test_kernels.py runs it.
On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is held against that version on the card by chip_smoke.py.
Tolerances follow tests/test_kernels.py:88: 2e-5 in float32, 2e-2 in bf16.
The CUDA instances' launch plans, TMA rules, the bf16 instance's rounding
of P and the float32 instance's split-TF32 arithmetic (both modelled here
on the CPU) are checked without the card.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as K  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.kernels import flash_attention as tfa  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import flash_attention_ref  # noqa: E402

CASES = [  # tests/test_kernels.py:66-76
    # (B, Sq, Sk, H, KV, hd, causal, window, cap, dtype)
    (2, 128, 128, 4, 4, 64, True, 0, 0.0, "float32"),
    (1, 256, 256, 4, 2, 64, True, 0, 0.0, "float32"),
    (2, 128, 128, 8, 1, 64, True, 0, 0.0, "bfloat16"),  # MQA
    (1, 256, 256, 4, 4, 64, False, 0, 0.0, "float32"),  # encoder
    (1, 256, 256, 4, 2, 64, True, 100, 0.0, "float32"),  # SWA
    (1, 128, 128, 2, 2, 64, True, 0, 50.0, "float32"),  # softcap
    (1, 128, 128, 2, 2, 120, True, 0, 0.0, "float32"),  # danube head_dim
    (1, 128, 128, 2, 1, 256, True, 64, 30.0, "bfloat16"),  # gemma-ish combo
]
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _tol(dtype):
    return 2e-2 if dtype == "bfloat16" else 2e-5


def _inputs(B, Sq, Sk, H, KV, hd, dtype, seed):
    """numpy q, k, v rounded to ``dtype`` (float32 arrays), as the JAX test makes them."""
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(0, 1, s) for s in ((B, Sq, H, hd), (B, Sk, KV, hd), (B, Sk, KV, hd))]
    return [np.array(jnp.asarray(a, JDT[dtype]), np.float32) for a in arrs]


def _torch(arrs, dtype):
    return [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]


@functools.lru_cache(maxsize=None)
def _pallas_case(i):
    """The case's inputs and the Pallas kernel's output (interpret mode)."""
    B, Sq, Sk, H, KV, hd, causal, window, cap, dtype = CASES[i]
    arrs = _inputs(B, Sq, Sk, H, KV, hd, dtype, hd + Sq + H)  # test_kernels.py:81
    q, k, v = (jnp.asarray(a, JDT[dtype]) for a in arrs)
    out = K.flash_attention(q, k, v, causal=causal, window=window, cap=cap,
                            block_q=64, block_k=64)
    return arrs, np.asarray(out, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_flash_ref_matches_pallas_interpret(i):
    B, Sq, Sk, H, KV, hd, causal, window, cap, dtype = CASES[i]
    arrs, want = _pallas_case(i)
    q, k, v = _torch(arrs, dtype)
    got = flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap)
    assert got.dtype == TDT[dtype]
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("i", range(len(CASES)))
def test_flash_ops_on_cpu_matches_pallas_interpret(i):
    B, Sq, Sk, H, KV, hd, causal, window, cap, dtype = CASES[i]
    arrs, want = _pallas_case(i)
    q, k, v = _torch(arrs, dtype)
    before = tfa.launches
    got = tops.flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    assert got.shape == q.shape and got.dtype == q.dtype
    assert tfa.launches == before  # the plain version is never counted
    _close(got, want, _tol(dtype))


def test_flash_kv_len_matches_pallas():
    """Twin of tests/test_kernels.py:95-102."""
    arrs = _inputs(1, 64, 128, 2, 2, 64, "float32", 1)
    q, k, v = (jnp.asarray(a) for a in arrs)
    want = np.asarray(K.flash_attention(q, k, v, causal=False, kv_len=77, block_q=64,
                                        block_k=64))
    tq, tk, tv = _torch(arrs, "float32")
    _close(tops.flash_attention(tq, tk, tv, causal=False, kv_len=77), want, 2e-5)
    _close(flash_attention_ref(tq, tk, tv, causal=False, kv_len=77), want, 2e-5)


@pytest.mark.parametrize("Sq,Sk,hd,causal,window,cap,dtype", [
    (70, 70, 16, True, 0, 0.0, "float32"),  # ragged, smoke head dim
    (33, 97, 120, False, 0, 0.0, "float32"),  # ragged, danube head dim
    (100, 100, 256, True, 40, 30.0, "bfloat16"),  # ragged, gemma head dim
    (1, 75, 256, True, 0, 0.0, "float32"),  # one query row
    (130, 130, 64, True, 7, 0.0, "float32"),  # a window far below the tile
])
def test_flash_ragged_and_head_dims_match_jax_ref(Sq, Sk, hd, causal, window, cap, dtype):
    """Shapes the Pallas wrapper refuses (it asserts tile divisibility):
    held against the JAX materialised reference, every row has a live key."""
    arrs = _inputs(2, Sq, Sk, 4, 2, hd, dtype, Sq + Sk + hd)
    want = np.asarray(jref.flash_attention_ref(*(jnp.asarray(a, JDT[dtype]) for a in arrs),
                                               causal=causal, window=window, cap=cap),
                      np.float32)
    got = tops.flash_attention(*_torch(arrs, dtype), causal=causal, window=window, cap=cap)
    _close(got, want, _tol(dtype))


@pytest.mark.parametrize("H,KV,hd,dv,dtype", [
    (4, 4, 24, 16, "float32"),  # the MLA test config: qk 16 + 8, v 16
    (4, 4, 96, 64, "float32"),  # minicpm3-4b: qk 64 + 32, v 64
    (8, 8, 96, 64, "bfloat16"),
    (4, 2, 128, 80, "bfloat16"),  # GQA, v padded from 80 to 128
    (4, 2, 64, 64, "float32"),  # dv == hd: nothing padded
])
def test_flash_ops_takes_a_v_head_dim_below_qk(H, KV, hd, dv, dtype):
    """MLA's attention (v head dim below q/k's) through ops.flash_attention
    on the CPU, held against the JAX model's and the port's layers.attention
    with MLA's scale 1/sqrt(qk); the wrapper pads v to q/k's padded width,
    since the kernel takes one head dim for q, k and v."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(hd + dv + H)
    arrs = [np.array(jnp.asarray(rng.normal(0, 1, s), JDT[dtype]), np.float32)
            for s in ((2, 70, H, hd), (2, 70, KV, hd), (2, 70, KV, dv))]
    scale = 1.0 / np.sqrt(hd - 8)
    want = np.asarray(JL.attention(*(jnp.asarray(a, JDT[dtype]) for a in arrs), causal=True,
                                   scale=scale), np.float32)
    q, k, v = _torch(arrs, dtype)
    seen, real = [], tfa.flash_attention

    def spy(*qkv, **kw):
        seen.append(tuple(tuple(t.shape) for t in qkv))
        return real(*qkv, **kw)

    before, tfa.flash_attention = tfa.flash_attention, spy
    try:
        got = tops.flash_attention(q, k, v, causal=True, scale=scale)
    finally:
        tfa.flash_attention = before
    width = tops.padded_head_dim(hd)
    assert seen == [((2, 70, H, width), (2, 70, KV, width), (2, 70, KV, width))]
    assert tuple(got.shape) == (2, 70, H, dv) and got.dtype == q.dtype
    _close(got, want, _tol(dtype))
    _close(got, TL.attention(q, k, v, causal=True, scale=scale).float().numpy(), _tol(dtype))
    with pytest.raises(ValueError, match="head dim"):
        tops.flash_attention(q, k, torch.zeros((2, 70, KV, hd + 1), dtype=q.dtype))


def test_flash_row_without_live_keys_follows_the_kernel():
    """kv_len=0 leaves no live key: the Pallas kernel gives 0 (it skips every
    block), and so do the port's kernel and plain version; JAX's
    materialised reference gives the mean of v instead."""
    arrs = _inputs(1, 64, 64, 2, 1, 64, "float32", 5)
    q, k, v = (jnp.asarray(a) for a in arrs)
    pallas = np.asarray(K.flash_attention(q, k, v, causal=False, kv_len=0, block_q=64,
                                          block_k=64))
    got = tops.flash_attention(*_torch(arrs, "float32"), causal=False, kv_len=0)
    np.testing.assert_array_equal(pallas, 0.0)
    np.testing.assert_array_equal(got.numpy(), 0.0)
    mean_v = np.asarray(jref.flash_attention_ref(q, k, v, causal=False, kv_len=0))
    assert np.abs(mean_v).max() > 0.01  # the quirk: the two references differ here


def test_flash_wrapper_on_cpu_is_the_plain_version():
    tq, tk, tv = _torch(_inputs(2, 96, 96, 4, 2, 128, "bfloat16", 3), "bfloat16")
    before = tfa.launches
    got = tfa.flash_attention(tq, tk, tv, causal=True, window=50, cap=20.0)
    want = flash_attention_ref(tq, tk, tv, causal=True, window=50, cap=20.0)
    assert torch.equal(got, want) and tfa.launches == before


def test_flash_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 8, 4, 64))
    kv = torch.zeros((1, 8, 2, 64))
    with pytest.raises(TypeError):  # not 4-D
        tfa.flash_attention(q[0], kv, kv)
    with pytest.raises(TypeError):  # float16 is not built
        tfa.flash_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(TypeError):  # mixed dtypes
        tfa.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError):  # 4 query heads over 3 kv heads
        tfa.flash_attention(q, torch.zeros((1, 8, 3, 64)), torch.zeros((1, 8, 3, 64)))
    with pytest.raises(ValueError):  # k and v differ
        tfa.flash_attention(q, kv, torch.zeros((1, 9, 2, 64)))
    with pytest.raises(ValueError, match="head_dim"):  # ops pads 120 up to 128
        tfa.flash_attention(torch.zeros((1, 8, 4, 120)), torch.zeros((1, 8, 2, 120)),
                            torch.zeros((1, 8, 2, 120)))
    with pytest.raises(ValueError, match="contiguous"):
        tfa.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="one device"):
        tfa.flash_attention(q, kv.to("meta"), kv)
    with pytest.raises(ValueError, match="exceeds"):
        tops.padded_head_dim(320)
    rows = tfa.plan(torch.float32, 64)["block_q"] * tfa.MAX_Q_TILES + 1
    long_q = torch.empty((1, rows, 4, 64), device="meta")  # no storage
    with pytest.raises(ValueError, match="query tiles"):
        tfa.flash_attention(long_q, kv.to("meta"), kv.to("meta"))


def test_flash_wrapper_gives_no_plain_fallback_off_the_cpu():
    """Only CPU tensors take the plain version; others launch or raise."""
    q = torch.zeros((1, 8, 4, 64), device="meta")
    kv = torch.zeros((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa.flash_attention(q, kv, kv)


def test_flash_kernel_fits_a_block_and_ops_pads_to_its_widths():
    for hd in tfa.HEAD_DIMS:
        assert tfa.smem_bytes(hd) <= tfa.SMEM_LIMIT
    assert tfa.smem_bytes(256) == 230_456  # one CTA per SM at gemma's head dim
    assert [tops.padded_head_dim(h) for h in (16, 64, 80, 120, 128, 256)] == [
        64, 64, 128, 128, 128, 256]


def test_flash_source_builds_beside_moments_without_rehashing_it(tmp_path, monkeypatch):
    """Each source is its own library, keyed by its own text and the shared
    flags: adding the flash kernel leaves the moments library's name as it was."""
    from repro_torch.kernels import _build

    assert _build.sources() == ["flash_attention", "mamba_scan", "mamba_stage", "moments"]
    moments = _build.target("moments")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "moments.cu").write_bytes((_build.CSRC / "moments.cu").read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", moments.parent)
    assert _build.target("moments") == moments


# ------------------------------------------------ the tensor-core instances
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_flash_launch_plan_fits_the_card(dtype, hd):
    """The launch csrc/flash_attention.cu makes, as kernels/flash_attention.py:plan
    mirrors it: one block's shared memory within sm_90's limit and one CTA
    per SM; a TMA producer warpgroup and wgmma consumers of 64 rows each
    (bf16: two, with a ring of at least 2 K/V stages; float32: two at hd 64
    and 128, one at hd 256, where Q_hi + Q_lo of 64 rows take 128 KB, and a
    ring of at least 3 slots of one 64-key chunk each); TMA boxes of 128 B
    rows and strides TMA takes."""
    plan = tfa.plan(TDT[dtype], hd)
    item = 4 if dtype == "float32" else 2
    assert plan["smem"] <= tfa.SMEM_LIMIT
    assert tfa.smem_bytes(hd, TDT[dtype]) == plan["smem"]
    assert 2 * (plan["smem"] + 1024) > tfa.SM_SMEM  # a second CTA never fits
    assert plan["block_k"] % 16 == 0 and 8 <= plan["block_k"] <= 256  # wgmma k, n <= 256
    if dtype == "float32":
        consumers = 1 if hd == 256 else 2
        assert (plan["threads"], plan["block_q"], plan["block_k"]) == (
            128 * (1 + consumers), 64 * consumers, 64)
        assert plan["stages"] >= 3 and hd % plan["chunk"] == 0
        slots = plan["stages"] * 2 * item * plan["block_k"] * plan["chunk"]
        assert plan["smem"] == 1024 + 2 * item * plan["block_q"] * hd + slots + 8 * (
            1 + 2 * plan["stages"])
        assert plan["vt_box"] == (tfa.TMA_BOX_BYTES // item, plan["chunk"], 1, 1)
        if hd == 256:
            assert plan["smem"] == 230_456  # one CTA per SM at gemma's head dim
    else:
        assert plan["threads"] == 3 * 128 and plan["block_q"] == 2 * 64
        assert plan["stages"] >= 2
    for box, rows in ((plan["q_box"], plan["block_q"]), (plan["kv_box"], plan["block_k"])):
        assert box == (tfa.TMA_BOX_BYTES // item, 1, rows, 1) and max(box) <= 256
        assert hd % box[0] == 0  # a row tile is hd * item / 128 boxes of 128 B
    for B, S, heads in ((1, 1, 1), (4, 1024, 8), (3, 77, 5)):  # contiguous (B, S, heads, hd)
        t = torch.empty((B, S, heads, hd), dtype=TDT[dtype], device="meta")
        tfa.check_tma(t)
        assert all(item * s % 16 == 0 for s in t.stride()[:-1])


def test_flash_f32_scratch_holds_the_split_k_and_v_transposed():
    """The float32 prologue's scratch: K_hi, K_lo as k, then V^T_hi, V^T_lo
    over keys rounded up to 8, whose rows TMA can step (16-byte strides)."""
    for B, Sk, KV, hd in ((4, 1024, 1, 256), (2, 77, 2, 64), (1, 1, 4, 128)):
        skp = -(-Sk // 8) * 8
        assert tfa.scratch_numel(B, Sk, KV, hd) == 2 * B * Sk * KV * hd + 2 * B * KV * hd * skp
        assert skp * 4 % 16 == 0 and (B * Sk * KV * hd * 4) % 16 == 0
    assert tfa.scratch_numel(4, 1024, 1, 256) * 4 == 16 * 2 ** 20  # 16 MiB at gemma's wave


@pytest.mark.parametrize("arch", tconfigs.ARCHS)
def test_flash_plan_takes_every_attention_config(arch):
    """Each config with attention has its (H, KV, padded head dim) taken by both
    instances, and its longest prefill cell fits the grid's query tiles."""
    cfg = tconfigs.get_config(arch)
    if cfg.attention_free:
        assert cfg.n_heads == 0
        return
    hd = tops.padded_head_dim(max(cfg.qk_dim, cfg.v_head_dim or 0))
    assert cfg.n_heads % cfg.n_kv_heads == 0
    longest = max(c.seq_len for c in tconfigs.SHAPES.values() if c.mode == "prefill")
    for dtype in (torch.float32, torch.bfloat16):
        plan = tfa.plan(dtype, hd)
        assert plan["smem"] <= tfa.SMEM_LIMIT
        assert -(-longest // plan["block_q"]) <= tfa.MAX_Q_TILES
    for heads in (cfg.n_heads, cfg.n_kv_heads):
        for dtype in (torch.float32, torch.bfloat16):
            tfa.check_tma(torch.empty((1, 8, heads, hd), dtype=dtype, device="meta"))


def _tensor_core_model(q, k, v, causal, window, cap, kv_len, scale=None, block_k=64):
    """The bf16 instance's arithmetic on the CPU, kv tile by kv tile: float32
    scores, scale then softcap, a running max; p rounded to bf16 before the
    P.V product, l summed from the float32 p; out = acc / max(l, 1e-30)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kv_len = Sk if kv_len is None else kv_len
    heads = torch.arange(H) // (H // KV)
    qf = q.float().permute(0, 2, 1, 3)  # (B, H, Sq, hd)
    kf, vf = (t.float()[:, :, heads].permute(0, 2, 1, 3) for t in (k, v))
    s_all = qf @ kf.transpose(-1, -2) * (scale if scale is not None else 1.0 / np.sqrt(hd))
    if cap > 0:
        s_all = torch.tanh(s_all / cap) * cap
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    ok = kpos < kv_len
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (qpos - kpos < window)
    s_all = torch.where(ok, s_all, float("-inf"))
    m = torch.full((B, H, Sq), float("-inf"))
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, hd))
    for k0 in range(0, Sk, block_k):
        s = s_all[..., k0:k0 + block_k]
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        r = torch.exp(m - base)
        p = torch.exp(s - base[..., None])
        l = l * r + p.sum(-1)
        p16 = p.to(torch.bfloat16).float()
        acc = acc * r[..., None] + p16 @ vf[:, :, k0:k0 + block_k]
        m = m_new
    out = acc / l.clamp(min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def _model_cases():
    cases = [c[:9] + (None,) for c in CASES if c[9] == "bfloat16"]
    cases += [(2, 70, 70, 4, 2, 64, True, 0, 0.0, None), (2, 33, 97, 4, 2, 128, False, 0, 0.0, None),
              (2, 100, 100, 4, 2, 256, True, 40, 30.0, None), (1, 64, 128, 2, 2, 64, False, 0, 0.0, 77),
              (1, 64, 128, 2, 2, 64, False, 0, 0.0, 0), (1, 130, 130, 4, 1, 64, True, 7, 0.0, None)]
    rng = np.random.default_rng(23)
    for _ in range(12):  # seeded sweep: GQA groups, head dims, ragged lengths, masks
        KV, G = int(rng.choice([1, 2, 4])), int(rng.choice([1, 2, 8]))
        Sk = int(rng.integers(1, 300))
        cases.append((int(rng.integers(1, 3)), int(rng.integers(1, 300)), Sk, KV * G, KV,
                      int(rng.choice(tfa.HEAD_DIMS)), bool(rng.integers(0, 2)),
                      int(rng.choice([0, 1, 64, 150])), float(rng.choice([0.0, 5.0, 50.0])),
                      None if rng.random() < 0.6 else int(rng.integers(0, Sk + 5))))
    return cases


@pytest.mark.parametrize("case", _model_cases())
def test_flash_bf16_rounding_of_p_fits_the_tolerance(case):
    """P in bf16 before P.V (the tensor-core instance) against the plain
    version, which multiplies float32 p: within the unchanged 2e-2."""
    B, Sq, Sk, H, KV, hd, causal, window, cap, kv_len = case
    q, k, v = _torch(_inputs(B, Sq, Sk, H, KV, hd, "bfloat16", Sq + Sk + hd), "bfloat16")
    got = _tensor_core_model(q, k, v, causal, window, cap, kv_len)
    want = flash_attention_ref(q, k, v, causal=causal, window=window, cap=cap, kv_len=kv_len)
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    _close(got, want.float().numpy(), 2e-2)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 rounds: bit operations on the int32 view."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)  # x - hi is exact in float32


def _split_tf32_model(q, k, v, causal, window, cap, kv_len, scale=None, block_k=64, terms=3):
    """The float32 instance's arithmetic on the CPU, kv tile by kv tile:
    q, k, v and p split into TF32 hi and lo; S = q_lo k_hi + q_hi k_lo +
    q_hi k_hi and O += p_lo v_hi + p_hi v_lo + p_hi v_hi, each product and
    sum in float32; scale (or softcap) in log2 units, exp2, a running max,
    l summed from the float32 p, out = acc / max(l, 1e-30).  ``terms=1``
    keeps the hi products only: one TF32 product."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    kv_len = Sk if kv_len is None else kv_len
    heads = torch.arange(H) // (H // KV)
    q_hi, q_lo = _split(q.permute(0, 2, 1, 3))  # (B, H, Sq, hd)
    (k_hi, k_lo), (v_hi, v_lo) = (_split(t[:, :, heads].permute(0, 2, 1, 3)) for t in (k, v))
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    scale = f32(scale if scale is not None else 1.0 / np.sqrt(hd))
    log2e = f32(1.4426950408889634)
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None, :]
    ok = kpos < kv_len
    if causal:
        ok = ok & (kpos <= qpos)
    if window > 0:
        ok = ok & (qpos - kpos < window)
    m = torch.full((B, H, Sq), float("-inf"))
    l = torch.zeros((B, H, Sq))
    acc = torch.zeros((B, H, Sq, hd))
    for k0 in range(0, Sk, block_k):
        kh, kl = (t[:, :, k0:k0 + block_k].transpose(-1, -2) for t in (k_hi, k_lo))
        s = q_hi @ kh if terms == 1 else q_lo @ kh + q_hi @ kl + q_hi @ kh
        if cap > 0:
            s = torch.tanh(s * scale / f32(cap)) * (f32(cap) * log2e)
        else:
            s = s * (scale * log2e)
        s = torch.where(ok[:, k0:k0 + block_k], s, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(m_new == float("-inf"), 0.0, m_new)
        r = torch.exp2(m - base)
        p = torch.exp2(s - base[..., None])
        l = l * r + p.sum(-1)
        p_hi, p_lo = _split(p)
        vh, vl = (t[:, :, k0:k0 + block_k] for t in (v_hi, v_lo))
        pv = p_hi @ vh if terms == 1 else p_lo @ vh + p_hi @ vl + p_hi @ vh
        acc = acc * r[..., None] + pv
        m = m_new
    return (acc / l.clamp(min=1e-30)[..., None]).permute(0, 2, 1, 3)


def _no_live_key(Sq, Sk, causal, window, kv_len):
    """(Sq,) rows with no live key: JAX's materialised reference gives the
    mean of v there, the kernels 0 (test_flash_row_without_live_keys_...)."""
    qpos, kpos = np.arange(Sq)[:, None], np.arange(Sk)[None, :]
    ok = (kpos < (Sk if kv_len is None else kv_len)) & np.ones((Sq, 1), bool)
    if causal:
        ok &= kpos <= qpos
    if window > 0:
        ok &= qpos - kpos < window
    return ~ok.any(-1)


def test_flash_tf32_rounding_is_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -11  # halfway between 1 and 1 + 2^-10
    x = torch.tensor([1.0, one, -one, np.nextafter(np.float32(one), np.float32(0)), 3.0e-39, 7e4],
                     dtype=torch.float32)
    want = [1.0, 1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0]
    np.testing.assert_array_equal(_tf32(x)[:4].numpy(), np.float32(want))
    assert not bool((_tf32(x).view(torch.int32) & 0x1FFF).any())  # exactly TF32 values
    rng = np.random.default_rng(3)
    y = torch.from_numpy((rng.normal(0, 1, 10_000) * 10.0 ** rng.uniform(-6, 6, 10_000))
                         .astype(np.float32))
    hi, lo = _split(y)
    assert bool((((y - hi) - lo).abs() <= y.abs() * 2.0 ** -22).all())  # hi + lo: ~2^-22
    assert bool(((y - hi).abs() <= y.abs() * 2.0 ** -11).all())


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES) if c[9] == "float32"])
def test_flash_split_tf32_model_matches_pallas_interpret(i):
    """The float32 instance's arithmetic against the Pallas kernel on the
    f32 cases of tests/test_kernels.py:66-76, at their unchanged 2e-5."""
    B, Sq, Sk, H, KV, hd, causal, window, cap, dtype = CASES[i]
    arrs, want = _pallas_case(i)
    q, k, v = _torch(arrs, dtype)
    if hd not in tfa.HEAD_DIMS:  # ops.flash_attention pads the danube head dim to 128
        q, k, v = (torch.nn.functional.pad(t, (0, tops.padded_head_dim(hd) - hd))
                   for t in (q, k, v))
    got = _split_tf32_model(q, k, v, causal, window, cap, None, scale=1.0 / np.sqrt(hd))
    _close(got[..., :hd], want, 2e-5)


def _split_model_cases():
    rng = np.random.default_rng(25)
    cases = [(1, 64, 128, 2, 2, 64, False, 0, 0.0, 77), (1, 64, 128, 2, 2, 64, False, 0, 0.0, 0),
             (2, 70, 70, 4, 2, 64, True, 0, 0.0, None), (2, 100, 100, 4, 2, 256, True, 40, 30.0, None),
             (2, 33, 97, 4, 2, 128, False, 0, 0.0, None), (1, 130, 130, 4, 1, 64, True, 7, 0.0, None)]
    for _ in range(14):  # seeded sweep: GQA groups, head dims, ragged lengths, masks, kv_len
        KV, G = int(rng.choice([1, 2, 4])), int(rng.choice([1, 2, 8]))
        Sk = int(rng.integers(1, 300))
        cases.append((int(rng.integers(1, 3)), int(rng.integers(1, 300)), Sk, KV * G, KV,
                      int(rng.choice(tfa.HEAD_DIMS)), bool(rng.integers(0, 2)),
                      int(rng.choice([0, 1, 64, 150])), float(rng.choice([0.0, 5.0, 50.0])),
                      None if rng.random() < 0.6 else int(rng.integers(0, Sk + 5))))
    return cases


@pytest.mark.parametrize("case", _split_model_cases())
def test_flash_split_tf32_model_matches_jax_ref(case):
    """The float32 instance's arithmetic against JAX's materialised
    reference over head dims, GQA groups, ragged lengths, masks and kv_len,
    within 2e-5; a row with no live key gives 0 (the kernels' rule)."""
    B, Sq, Sk, H, KV, hd, causal, window, cap, kv_len = case
    arrs = _inputs(B, Sq, Sk, H, KV, hd, "float32", Sq + Sk + hd)
    kw = dict(causal=causal, window=window, cap=cap)
    want = np.array(jref.flash_attention_ref(*(jnp.asarray(a) for a in arrs), **kw,
                                              kv_len=kv_len), np.float32)
    want[:, _no_live_key(Sq, Sk, causal, window, kv_len)] = 0.0
    got = _split_tf32_model(*_torch(arrs, "float32"), causal, window, cap, kv_len)
    assert torch.isfinite(got).all()
    _close(got, want, 2e-5)


def test_flash_split_tf32_model_at_gemma_head_dim_and_length():
    """hd 256 at S 1024, causal (gemma-2b's prefill per head): split TF32
    holds 2e-5 against JAX's reference, where one TF32 product does not."""
    arrs = _inputs(1, 1024, 1024, 2, 1, 256, "float32", 1024)
    want = np.asarray(jref.flash_attention_ref(*(jnp.asarray(a) for a in arrs), causal=True),
                      np.float32)
    q, k, v = _torch(arrs, "float32")
    _close(_split_tf32_model(q, k, v, True, 0, 0.0, None), want, 2e-5)
    one = _split_tf32_model(q, k, v, True, 0, 0.0, None, terms=1).numpy()
    assert np.abs(one - want).max() > 2e-5 * (1 + np.abs(want)).max()


def test_flash_wrapper_raises_where_tma_cannot_load():
    """An input TMA cannot take is refused on the card, in either dtype (the
    wrapper calls check_tma on CUDA tensors only; see the tests below).  Strides that
    TMA refuses cannot reach the wrapper (it also needs contiguous inputs of
    a built head dim), so check_tma is held to each rule directly."""
    kv = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    shifted = torch.zeros(1 * 8 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 8, 4, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        tfa.check_tma(shifted)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):  # rows of 65 columns
        tfa.check_tma(torch.zeros((1, 8, 4, 65), dtype=torch.bfloat16)[..., :64])
    with pytest.raises(ValueError, match="head dim contiguous"):
        tfa.check_tma(torch.zeros((1, 8, 64, 4), dtype=torch.bfloat16).transpose(2, 3))
    f32 = torch.zeros(1 * 8 * 4 * 64 + 1)[1:].view(1, 8, 4, 64)  # float32 loads by TMA too
    with pytest.raises(ValueError, match="16-byte boundary"):
        tfa.check_tma(f32)
    assert tfa.flash_attention(f32, kv.float(), kv.float()).shape == f32.shape  # CPU: plain


def test_flash_wrapper_takes_a_misaligned_bf16_view_on_the_cpu():
    """TMA's 16-byte rule is the card's: a contiguous bf16 view one element
    into its storage takes the plain version on the CPU, as the JAX wrapper
    takes the same values."""
    q, k, v = _torch(_inputs(1, 64, 64, 2, 1, 64, "bfloat16", 5), "bfloat16")
    shifted = torch.empty(q.numel() + 1, dtype=torch.bfloat16)[1:].view(q.shape)
    shifted.copy_(q)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    before = tfa.launches
    got = tfa.flash_attention(shifted, k, v, causal=True)
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=True))
    assert tfa.launches == before


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_flash_wrapper_refuses_a_misaligned_bf16_view_on_the_card(card):
    kv = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, device=card)
    shifted = torch.zeros(1 * 8 * 4 * 64 + 1, dtype=torch.bfloat16, device=card)[1:]
    with pytest.raises(ValueError, match="16-byte boundary"):
        tfa.flash_attention(shifted.view(1, 8, 4, 64), kv, kv)


@pytest.mark.cuda
def test_flash_wrapper_refuses_a_misaligned_f32_view_on_the_card(card):
    kv = torch.zeros((1, 8, 2, 64), device=card)
    shifted = torch.zeros(1 * 8 * 4 * 64 + 1, device=card)[1:]
    before = tfa.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        tfa.flash_attention(shifted.view(1, 8, 4, 64), kv, kv)
    assert tfa.launches == before


def test_build_keeps_each_compiler_output_beside_its_library(tmp_path, monkeypatch):
    """A cached build still reports its ptxas lines (chip_smoke.py reads them)."""
    from repro_torch.kernels import _build

    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo built > "$2"\necho "ptxas info    : Used 42 registers"\n')
    fake.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// a source\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(fake))
    assert "Used 42 registers" in _build.build_all(["k"])["k"]
    assert _build.build_all(["k"]) == {}  # up to date: nothing compiled
    assert "Used 42 registers" in _build.build_log("k")


# ------------------------------------------- chip_smoke.py's flash build facts
def _chip_smoke():
    """chip_smoke.py as a module (it imports no CUDA code at import time)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_NS = "_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea7"
_FLASH_FNS = {("bfloat16", hd): f"{_NS}2tc20flash_fwd_wgmma_bf16ILi{hd}EEEv14CUtensorMap_stS2_S2_"
              f"P13__nv_bfloat16iiiiiiffi" for hd in tfa.HEAD_DIMS}
_FLASH_FNS.update({("float32", hd): f"{_NS}4tf3219flash_fwd_wgmma_f32ILi{hd}EEEv14CUtensorMap_"
                   f"stS2_S2_S2_S2_Pfiiiiiiffi" for hd in tfa.HEAD_DIMS})
_PROLOGUE_FN = f"{_NS}4tf3219flash_kv_split_tf32EPKfS2_PfS3_S3_S3_iiii"
_SIMT_FN = f"{_NS}4simt18flash_fwd_simt_f32ILi64EEEvPKfS2_S2_Pfiiiiiiffi"


def _flash_ptxas(spilling=None, without=None):
    lines = [f"ptxas info    : (C7519) warpgroup.arrive is injected in around line 19489 by "
             f"compiler to allow use of registers in GMMA in function '{_FLASH_FNS['float32', 256]}'"]
    for key, fn in [*_FLASH_FNS.items(), ("prologue", _PROLOGUE_FN)]:
        if key == without:
            continue
        lines += [f"ptxas info    : Compiling entry function '{fn}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {fn}",
                  f"    0 bytes stack frame, {8 if key == spilling else 0} bytes spill stores, "
                  "0 bytes spill loads", "ptxas info    : Used 168 registers, used 16 barriers"]
    return "\n".join(lines)


def _flash_sass(lacking=None, extra=()):
    out = ["\tcode for sm_90a"]
    for key, fn in [*_FLASH_FNS.items(), ("prologue", _PROLOGUE_FN), *extra]:
        ops = ["LDG.E", "STS", "BAR.SYNC"] if key in ("prologue", "simt") else \
            ["UTMALDG.4D", "SYNCS.ARRIVE", "MUFU.EX2"] + ([] if key == lacking else ["HGMMA.64x64x8"])
        out += [f"\t\tFunction : {fn}"] + [
            f"        /*{16 * i:04x}*/                   {op} R1, R2 ;   /* 0x0 */"
            for i, op in enumerate(ops)]
    return "\n".join(out)


@pytest.mark.parametrize("ptxas,sass,fault", [
    ({}, {}, None),
    ({"spilling": ("float32", 256)}, {}, "spills"),
    ({"spilling": "prologue"}, {}, "spills"),
    ({"without": "prologue"}, {}, "missing"),
    ({}, {"lacking": ("float32", 128)}, "HGMMA"),
    ({}, {"extra": [("simt", _SIMT_FN)]}, "other than"),
])
def test_chip_smoke_reads_the_flash_instances_ptxas_and_sass(monkeypatch, ptxas, sass, fault):
    """chip_smoke.py's flash build facts: every instance of both dtypes with
    HGMMA and UTMALDG and no spills, the float32 prologue present and not
    spilling, no other kernel (the CUDA-core float32 instance it replaced)
    in the library, and ptxas's wgmma notes counted by instance."""
    from repro_torch.kernels import _build

    cs = _chip_smoke()
    monkeypatch.setattr(_build, "build_log", lambda name: _flash_ptxas(**ptxas))
    monkeypatch.setattr(_build, "nvcc", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(cs, "run_text", lambda cmd: _flash_sass(**sass))
    if fault is not None:
        with pytest.raises(AssertionError, match=fault):
            cs.flash_build_facts()
        return
    facts = cs.flash_build_facts()
    for dtype in ("bfloat16", "float32"):
        for hd in tfa.HEAD_DIMS:
            assert facts[dtype][hd]["sass"]["HGMMA"] == facts[dtype][hd]["sass"]["UTMALDG"] == 1
            assert "Used 168 registers" in facts[dtype][hd]["ptxas"]
    assert "0 bytes spill stores" in facts["prologue"]["ptxas"]
    assert facts["warnings"] == ["(C7519) warpgroup.arrive is injected (float32 hd 256) x 1"]


def test_chip_smoke_flash_bound_gives_float32_both_bounds():
    """At gemma-2b's wave: 17.20 GFLOP, the bound is the split-TF32 one,
    104.2 us (three TF32 products at 495 TFLOP/s), and the CUDA-core bound
    256.67 us stands beside it."""
    cs = _chip_smoke()
    f32 = cs.flash_bound((4, 1024, 1024, 8, 1, 256, True, 0, 0.0, "float32"))
    assert round(f32["flops"] / 1e9, 2) == 17.20
    assert round(f32["bound_ms"] * 1e3, 1) == 104.2 and f32["bound_by"] == "operations"
    assert round(f32["cuda_core_ms"] * 1e3, 2) == 256.67
    assert round(f32["bytes_ms"] * 1e3, 1) == 22.5
    bf16 = cs.flash_bound((4, 1024, 1024, 8, 1, 256, True, 0, 0.0, "bfloat16"))
    assert "cuda_core_ms" not in bf16 and round(bf16["bound_ms"] * 1e3, 2) == 17.39
    assert cs.flash_call_device_ms({"tf32::flash_kv_split_tf32(float": 0.0086,
                                    "tf32::flash_fwd_wgmma_f32<256>(": 0.1984,
                                    "Memset (Device)": 0.001}) == pytest.approx(0.207)
    assert cs.flash_call_device_ms({}) is None
