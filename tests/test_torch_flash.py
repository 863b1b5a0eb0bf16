"""Port's flash attention (plain version on the CPU) and wrappers vs the JAX package.

Inputs are made once with numpy from a seed and handed to both packages.
The Pallas kernel runs in interpret mode, as tests/test_kernels.py runs it.
On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is held against that version on the card by chip_smoke.py.
Tolerances follow tests/test_kernels.py:88: 2e-5 in float32, 2e-2 in bf16.
The CUDA instances' launch plans, TMA rules and the bf16 instance's
rounding of P (modelled here on the CPU) are checked without the card.
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
    long_q = torch.empty((1, 64 * 65535 + 1, 4, 64), device="meta")  # no storage
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
    assert tfa.smem_bytes(256) == 217_088  # one CTA per SM at gemma's head dim
    assert [tops.padded_head_dim(h) for h in (16, 64, 80, 120, 128, 256)] == [
        64, 64, 128, 128, 128, 256]


def test_flash_source_builds_beside_moments_without_rehashing_it(tmp_path, monkeypatch):
    """Each source is its own library, keyed by its own text and the shared
    flags: adding the flash kernel leaves the moments library's name as it was."""
    from repro_torch.kernels import _build

    assert _build.sources() == ["flash_attention", "mamba_scan", "moments"]
    moments = _build.target("moments")
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "moments.cu").write_bytes((_build.CSRC / "moments.cu").read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", moments.parent)
    assert _build.target("moments") == moments


# ------------------------------------------------ the bf16 tensor-core instance
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", tfa.HEAD_DIMS)
def test_flash_launch_plan_fits_the_card(dtype, hd):
    """The launch csrc/flash_attention.cu makes, as kernels/flash_attention.py:plan
    mirrors it: one block's shared memory within sm_90's limit; for bf16 three
    warpgroups (a TMA producer, two wgmma consumers of 64 rows each), a ring
    of at least 2 K/V stages, one CTA per SM (setmaxnreg hands the producer's
    registers to the consumers), and TMA boxes and strides TMA takes."""
    plan = tfa.plan(TDT[dtype], hd)
    assert plan["smem"] <= tfa.SMEM_LIMIT
    assert tfa.smem_bytes(hd, TDT[dtype]) == plan["smem"]
    if dtype == "float32":
        assert (plan["threads"], plan["block_q"], plan["block_k"]) == (256, 64, 64)
        if hd == 256:
            assert plan["smem"] == 217_088  # one CTA per SM at gemma's head dim
        return
    assert plan["threads"] == 3 * 128 and plan["block_q"] == 2 * 64
    assert plan["block_k"] % 16 == 0 and 8 <= plan["block_k"] <= 256  # wgmma k16, n <= 256
    assert plan["stages"] >= 2
    assert 2 * (plan["smem"] + 1024) > tfa.SM_SMEM  # a second CTA never fits
    for box, rows in ((plan["q_box"], plan["block_q"]), (plan["kv_box"], plan["block_k"])):
        assert box == (tfa.TMA_BOX_BYTES // 2, 1, rows, 1) and max(box) <= 256
        assert hd % box[0] == 0  # a row tile is hd / 64 boxes of 128 B
    for B, S, heads in ((1, 1, 1), (4, 1024, 8), (3, 77, 5)):  # contiguous (B, S, heads, hd)
        t = torch.empty((B, S, heads, hd), dtype=torch.bfloat16, device="meta")
        tfa.check_tma(t)
        assert all(2 * s % 16 == 0 for s in t.stride()[:-1])


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
        tfa.check_tma(torch.empty((1, 8, heads, hd), dtype=torch.bfloat16, device="meta"))


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


def test_flash_wrapper_raises_where_tma_cannot_load():
    """A bf16 input TMA cannot take is refused on every device.  A start off
    a 16-byte boundary reaches the wrapper; strides that TMA refuses cannot
    (the wrapper also needs contiguous inputs of a built head dim), so
    check_tma, which the wrapper calls, is held to them directly."""
    kv = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    shifted = torch.zeros(1 * 8 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].view(1, 8, 4, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte boundary"):
        tfa.flash_attention(shifted, kv, kv)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):  # rows of 65 columns
        tfa.check_tma(torch.zeros((1, 8, 4, 65), dtype=torch.bfloat16)[..., :64])
    with pytest.raises(ValueError, match="head dim contiguous"):
        tfa.check_tma(torch.zeros((1, 8, 64, 4), dtype=torch.bfloat16).transpose(2, 3))
    f32 = torch.zeros(1 * 8 * 4 * 64 + 1)[1:].view(1, 8, 4, 64)  # no TMA in float32
    assert tfa.flash_attention(f32, kv.float(), kv.float()).shape == f32.shape


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
