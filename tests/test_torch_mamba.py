"""Port's Mamba block and selective-scan kernel wrapper vs the JAX package, on the CPU.

Inputs are made with numpy from a seed and handed to both packages; block
weights come from JAX ``init_layer_params`` (falcon-mamba-7b smoke widths).
The Pallas scan kernel runs in interpret mode, as tests/test_kernels.py
runs it.  On the CPU the port's wrapper takes its plain PyTorch version;
the CUDA kernel itself is held against that version on the card by
chip_smoke.py.

Tolerances: the scan at 1e-5 against the Pallas kernel and the sequential
reference and at 1e-4 against the chunked model scan
(tests/test_kernels.py:119-148); the model functions in float32 at 1e-5,
in bf16 at one bf16 ulp (1e-2, as tests/test_torch_models.py holds the
layers) and, after the output projection, 2e-2.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.mamba_scan import mamba_scan as ms_raw  # noqa: E402
from repro.models import mamba as JMB  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.common import init_layer_params as j_init_layer  # noqa: E402
from repro.models.common import init_params as j_init_params  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import mamba_scan as tms  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import mamba_scan_ref  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import mamba as TMB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import init_params as t_init_params  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
ARCH = "falcon-mamba-7b"
SWEEP = [  # tests/test_kernels.py:120-122: (B, S, di, st, Pallas block_d, chunk)
    (1, 64, 16, 4, 8, 16),
    (2, 128, 64, 16, 32, 32),
    (1, 256, 32, 16, 32, 64),
]
RAGGED = [  # shapes the Pallas wrapper refuses; the CUDA kernel masks them
    (2, 1, 16, 16), (1, 77, 32, 16), (2, 33, 50, 16), (1, 40, 24, 3), (2, 29, 37, 4),
    (1, 45, 70, 8), (1, 20, 9, 1), (1, 12, 5, 32),
]
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)  # one bf16 ulp
OUT = {"float32": F32, "bfloat16": dict(rtol=2e-2, atol=2e-2)}  # after out_proj
STATE = {"float32": F32, "bfloat16": dict(rtol=1e-2, atol=1e-3)}  # float32 h from bf16 inputs
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _scan_inputs(B, S, di, st, seed):
    """The inputs of tests/test_kernels.py:test_mamba_scan_sweep."""
    rng = np.random.default_rng(seed)
    a = np.exp(-rng.uniform(0.05, 2.0, (B, S, di, st))).astype(np.float32)
    b = rng.normal(0, 1, (B, S, di, st)).astype(np.float32)
    C = rng.normal(0, 1, (B, S, st)).astype(np.float32)
    return a, b, C


def _t(*arrays):
    return [torch.from_numpy(np.asarray(x, np.float32)) for x in arrays]


def _np(t):
    return t.float().numpy()


def _cfgs(dtype):
    jdt, tdt = DTYPES[dtype]
    return (dataclasses.replace(jconfigs.smoke(ARCH), compute_dtype=jdt),
            dataclasses.replace(tconfigs.smoke(ARCH), compute_dtype=tdt))


def _block(dtype, seed=0):
    """One Mamba layer's weights in the compute dtype (A_log float32), as
    JAX's ``_cast_block_params`` gives them, for both packages."""
    jcfg, tcfg = _cfgs(dtype)
    jdt, tdt = DTYPES[dtype]
    master = j_init_layer(jcfg, jcfg.layout[0], jax.random.key(seed))
    jp = {k: (v if k == "A_log" else v.astype(jdt)) for k, v in master.items()}
    tp = {k: torch.from_numpy(np.array(v, np.float32)).to(torch.float32 if k == "A_log" else tdt)
          for k, v in jp.items()}
    return jcfg, tcfg, jp, tp


def _acts(shape, dtype, seed=1, scale=1.0):
    jdt, tdt = DTYPES[dtype]
    x = (np.random.default_rng(seed).normal(0, 1, shape) * scale).astype(np.float32)
    jx = jnp.asarray(x, jdt)
    return jx, torch.from_numpy(np.array(jx, np.float32)).to(tdt)


def _close(got, want, dtype, tol=None):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               **(tol or (F32 if dtype == "float32" else BF16)))


# ------------------------------------------------------------- the scan
@pytest.mark.parametrize("B,S,di,st,bd,Lc", SWEEP)
def test_scan_matches_pallas_interpret_and_the_jax_reference(B, S, di, st, bd, Lc):
    a, b, C = _scan_inputs(B, S, di, st, S + di)
    before = tms.launches
    y, h = tops.mamba_scan(*_t(a, b, C))
    assert tms.launches == before  # CPU tensors take the plain version
    y_k, h_k = ms_raw(jnp.asarray(a), jnp.asarray(b), jnp.asarray(C), block_d=bd, chunk=Lc,
                      interpret=True)
    y_r, h_r = jref.mamba_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(C))
    for got, k, r in ((y, y_k, y_r), (h, h_k, h_r)):
        np.testing.assert_allclose(_np(got), np.asarray(k), **F32)
        np.testing.assert_allclose(_np(got), np.asarray(r), **F32)


def test_scan_matches_the_jax_model_chunked_scan():
    """Twin of tests/test_kernels.py:test_mamba_scan_matches_model_chunked."""
    a, b, C = _scan_inputs(2, 128, 32, 8, 3)
    y, h = tops.mamba_scan(*_t(a, b, C))
    y_m, h_m = JMB._ssm_scan_chunked(jnp.asarray(a), jnp.asarray(b), jnp.asarray(C), chunk=32)
    np.testing.assert_allclose(_np(y), np.asarray(y_m), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(h), np.asarray(h_m), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,S,di,st", RAGGED)
def test_scan_on_ragged_shapes_matches_the_jax_reference(B, S, di, st):
    a, b, C = _scan_inputs(B, S, di, st, 7 * S + st)
    y, h = tops.mamba_scan(*_t(a, b, C))
    y_r, h_r = jref.mamba_scan_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(C))
    assert tuple(y.shape) == (B, S, di) and tuple(h.shape) == (B, di, st)
    np.testing.assert_allclose(_np(y), np.asarray(y_r), **F32)
    np.testing.assert_allclose(_np(h), np.asarray(h_r), **F32)


def test_chunked_scan_matches_sequential():
    """Twin of tests/test_models.py:123: the port's chunked scan and the
    kernel's plain version against the naive float64 recurrence."""
    rng = np.random.default_rng(0)
    B, S, di, st = 2, 16, 4, 3
    a = np.exp(-rng.uniform(0.1, 1.0, (B, S, di, st))).astype(np.float32)
    b = rng.normal(0, 1, (B, S, di, st)).astype(np.float32)
    C = rng.normal(0, 1, (B, S, st)).astype(np.float32)
    h = np.zeros((B, di, st), np.float64)
    ys = np.zeros((B, S, di))
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        ys[:, t] = np.einsum("bds,bs->bd", h, C[:, t])
    for y_t, h_t in (TMB._ssm_scan_chunked(*_t(a, b, C), chunk=4), mamba_scan_ref(*_t(a, b, C))):
        np.testing.assert_allclose(_np(y_t), ys, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_np(h_t), h, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("S,chunk", [(48, 16), (40, 128), (9, 9)])
def test_chunked_scan_with_h0_matches_jax(S, chunk):
    a, b, C = _scan_inputs(2, S, 12, 8, S)
    h0 = np.random.default_rng(S).normal(0, 1, (2, 12, 8)).astype(np.float32)
    got = TMB._ssm_scan_chunked(*_t(a, b, C), h0=torch.from_numpy(h0), chunk=chunk)
    want = JMB._ssm_scan_chunked(jnp.asarray(a), jnp.asarray(b), jnp.asarray(C),
                                 h0=jnp.asarray(h0), chunk=chunk)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **F32)


def test_port_associative_scan_orders_as_lax():
    """Odd and even lengths; the combine is not associative in floats, so
    only the same order gives bitwise-equal prefixes."""
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 16, 37):
        a = rng.uniform(0.1, 1.0, (3, n, 5)).astype(np.float32)
        b = rng.normal(0, 1, (3, n, 5)).astype(np.float32)
        got = TMB.associative_scan(TMB._combine, _t(a, b), dim=1)
        want = jax.lax.associative_scan(lambda e1, e2: (e1[0] * e2[0], e2[0] * e1[1] + e2[1]),
                                        (jnp.asarray(a), jnp.asarray(b)), axis=1)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_np(g), np.asarray(w))


# ------------------------------------------------------- model functions
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv1d_and_softplus_match_jax(dtype):
    _, _, jp, tp = _block(dtype)
    jx, tx = _acts((2, 21, 128), dtype)
    _close(TMB.causal_conv1d(tx, tp["conv_w"], tp["conv_b"]),
           JMB.causal_conv1d(jx, jp["conv_w"], jp["conv_b"]), dtype)
    jv, tv = _acts((4, 300), dtype, scale=6.0)
    got = TL.softplus(tv)
    assert got.dtype == tv.dtype
    _close(got, jax.nn.softplus(jv), dtype)


# JAX's side of the bf16 comparisons runs in a child process with XLA's
# excess precision off (see tests/test_torch_models.py): inside a compiled
# scan XLA otherwise keeps bf16 products such as Δt·x in float32, which
# moves _ssm_scan_fused's output by ~3 % where the port, as JAX without
# excess precision, rounds them.
PREFILL_S = (40, 77)  # 77: a length JAX's chunked scan takes only as one chunk


def _fused_inputs():
    rng = np.random.default_rng(9)
    B, S, di, st = 2, 64, 24, 8
    dt = np.log1p(np.exp(rng.normal(-2, 1, (B, S, di)))).astype(np.float32)
    x, Bm, Cm = (rng.normal(0, 1, s).astype(np.float32) for s in
                 ((B, S, di), (B, S, st), (B, S, st)))
    A = -np.tile(np.arange(1, st + 1, dtype=np.float32), (di, 1))
    h0 = rng.normal(0, 1, (B, di, st)).astype(np.float32)
    return (dt, x, Bm, Cm), A, h0


def _decode_state(jcfg, dtype):
    h = np.random.default_rng(3).normal(0, 1, (2, jcfg.d_inner, jcfg.ssm_d_state))
    return h.astype(np.float32), _acts((2, jcfg.ssm_d_conv - 1, jcfg.d_inner), dtype, seed=4)


def _jax_cases(dtype):
    """JAX's outputs for the model-function tests below, as numpy."""
    jdt, _ = DTYPES[dtype]
    out = {}
    ins, A, h0 = _fused_inputs()
    for name, h in (("fused", None), ("fused_h0", jnp.asarray(h0))):
        y, h_last = JMB._ssm_scan_fused(*(jnp.asarray(v, jdt) for v in ins), jnp.asarray(A),
                                        h0=h, chunk=16)
        out[f"{name}/y"], out[f"{name}/h"] = y, h_last
    jcfg, _, jp, _ = _block(dtype)
    ju, _ = _acts((2, 32, jcfg.d_model), dtype)
    out["sequence"] = JMB.mamba_sequence(jp, ju, jcfg, chunk=16)
    h, (jconv, _) = _decode_state(jcfg, dtype)
    y, state = JMB.mamba_decode(jp, _acts((2, 1, jcfg.d_model), dtype)[0],
                                {"h": jnp.asarray(h), "conv": jconv}, jcfg)
    out["decode/y"], out["decode/h"], out["decode/conv"] = y, state["h"], state["conv"]
    for S in PREFILL_S:
        ju, _ = _acts((2, S, jcfg.d_model), dtype)
        out[f"prefill{S}/y"] = JMB.mamba_sequence(jp, ju, jcfg, chunk=S)
        state = JM._mamba_prefill_state(jcfg, jp, ju)
        out[f"prefill{S}/h"], out[f"prefill{S}/conv"] = state["h"], state["conv"]
    return {k: np.asarray(v, np.float32) for k, v in out.items()}


_BF16_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import numpy as np
sys.path.insert(0, sys.argv[2])
import test_torch_mamba as T
np.savez(sys.argv[1], **T._jax_cases("bfloat16"))
print("BF16_OK")
"""


@pytest.fixture(scope="module")
def jax_want(tmp_path_factory):
    path = tmp_path_factory.mktemp("mamba_bf16") / "cases.npz"
    r = subprocess.run(
        [sys.executable, "-c", _BF16_SCRIPT, str(path), str(REPO / "tests")],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"},
    )
    assert "BF16_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return {"float32": _jax_cases("float32"), "bfloat16": dict(np.load(path))}


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_scan_matches_jax(dtype, jax_want):
    """_ssm_scan_fused from (dt, x, B, C, A), chunked, with and without h0:
    a float32 scan either way, so held at 1e-5 in both dtypes."""
    _, tdt = DTYPES[dtype]
    ins, A, h0 = _fused_inputs()
    tin = [torch.from_numpy(v).to(tdt) for v in ins]
    for name, h in (("fused", None), ("fused_h0", torch.from_numpy(h0))):
        y, h_last = TMB._ssm_scan_fused(*tin, torch.from_numpy(A), h0=h, chunk=16)
        assert y.dtype == h_last.dtype == torch.float32
        np.testing.assert_allclose(_np(y), jax_want[dtype][f"{name}/y"], **F32)
        np.testing.assert_allclose(_np(h_last), jax_want[dtype][f"{name}/h"], **F32)


@pytest.mark.parametrize("L_,chunk", [(32, 16), (40, 16), (12, 128)])
def test_h0_correction_matches_jax(L_, chunk):
    """With L not a multiple of the chunk, only the first (L // Lc)·Lc
    positions are covered, as in JAX."""
    rng = np.random.default_rng(L_)
    dt = np.abs(rng.normal(0, 0.05, (2, L_, 24))).astype(np.float32)
    Cm = rng.normal(0, 1, (2, L_, 8)).astype(np.float32)
    A = -np.tile(np.arange(1, 9, dtype=np.float32), (24, 1))
    h_in = rng.normal(0, 1, (2, 24, 8)).astype(np.float32)
    got = TMB._h0_correction(*_t(dt, Cm, A, h_in), chunk=chunk)
    want = JMB._h0_correction(*(jnp.asarray(v) for v in (dt, Cm, A, h_in)), chunk=chunk)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_sequence_matches_jax(dtype, jax_want):
    jcfg, tcfg, _, tp = _block(dtype)
    _, tu = _acts((2, 32, jcfg.d_model), dtype)
    got = TMB.mamba_sequence(tp, tu, tcfg, chunk=16)
    assert got.dtype == tu.dtype
    _close(got, jax_want[dtype]["sequence"], dtype, OUT[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode_matches_jax_and_updates_the_state_in_place(dtype, jax_want):
    jcfg, tcfg, _, tp = _block(dtype)
    h, (_, tconv) = _decode_state(jcfg, dtype)
    state = {"h": torch.from_numpy(h), "conv": tconv}
    keep = dict(state)
    got, gstate = TMB.mamba_decode(tp, _acts((2, 1, jcfg.d_model), dtype)[1], state, tcfg)
    assert all(gstate[k] is keep[k] for k in keep)  # the same tensors, updated in place
    want = jax_want[dtype]
    _close(got, want["decode/y"], dtype, OUT[dtype])
    _close(gstate["h"], want["decode/h"], dtype, STATE[dtype])
    np.testing.assert_array_equal(_np(gstate["conv"]), want["decode/conv"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", PREFILL_S)
def test_prefill_mixer_matches_jax_output_and_state(S, dtype, jax_want):
    """The kernel-path mixer (plain scan on the CPU): its output against JAX's
    mamba_sequence, its state against JAX's _mamba_prefill_state (conv exact)."""
    jcfg, tcfg, _, tp = _block(dtype)
    _, tu = _acts((2, S, jcfg.d_model), dtype)
    out, state = TMB.mamba_prefill(tp, tu, tcfg)
    want = jax_want[dtype]
    _close(out, want[f"prefill{S}/y"], dtype, OUT[dtype])
    _close(state["h"], want[f"prefill{S}/h"], dtype, STATE[dtype])
    np.testing.assert_array_equal(_np(state["conv"]), want[f"prefill{S}/conv"])
    assert state["conv"].untyped_storage().nbytes() == state["conv"].nbytes  # not a view


def test_short_prefill_pads_the_conv_state_and_decodes_as_forward():
    """S < K−1: the conv tail is left-padded with the conv's zeros, so the
    next decode steps give the forward pass's logits (JAX keeps fewer rows
    there, and its decode cannot run)."""
    _, tcfg = _cfgs("float32")
    tp = t_init_params(tcfg, 3, "cpu")
    toks = torch.from_numpy(np.random.default_rng(8).integers(0, tcfg.vocab, (2, 6)).astype(np.int32))
    full = TM.forward(tcfg, tp, {"tokens": toks})
    _, cache = TM.prefill(tcfg, tp, {"tokens": toks[:, :1]}, max_seq=6)
    assert cache["layers"][0]["conv"].shape[2] == tcfg.ssm_d_conv - 1
    for t in range(1, 6):
        logits, cache = TM.decode_step(tcfg, tp, cache, toks[:, t:t + 1])
        np.testing.assert_allclose(_np(logits[:, 0, :tcfg.vocab]), _np(full[:, t]),
                                   rtol=1e-4, atol=1e-3)


def test_decode_from_an_empty_cache_matches_jax_and_forward():
    """Token by token from init_cache: the port, JAX and the port's forward."""
    jcfg, tcfg = _cfgs("float32")
    jp = j_init_params(jcfg, jax.random.key(2))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (1, 10)).astype(np.int32)
    full = _np(TM.forward(tcfg, tp, {"tokens": torch.from_numpy(toks)}))
    cache = TM.init_cache(tcfg, 1, max_seq=10, device="cpu")
    assert [tuple(t.shape) for t in cache["layers"][0].values()] == [
        (2, 1, tcfg.d_inner, tcfg.ssm_d_state), (2, 1, tcfg.ssm_d_conv - 1, tcfg.d_inner)]
    jcache = JM.init_cache(jcfg, 1, max_seq=10)
    for t in range(10):
        logits, cache = TM.decode_step(tcfg, tp, cache, torch.from_numpy(toks[:, t:t + 1]))
        jl, jcache = JM.decode_step(jcfg, jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        np.testing.assert_allclose(_np(logits[:, 0, :jcfg.vocab]), np.asarray(jl[:, 0, :jcfg.vocab]),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(_np(logits[:, 0, :jcfg.vocab]), full[:, t], rtol=1e-4, atol=1e-3)
    for name in ("h", "conv"):
        np.testing.assert_allclose(_np(cache["layers"][0][name]),
                                   np.asarray(jcache["layers"][0][name]), **F32)


def test_sequence_parallel_mixer_waits_for_multi_gpu():
    _, tcfg = _cfgs("float32")
    with pytest.raises(NotImplementedError, match="item 11"):
        TMB.mamba_mixer_seq_parallel({}, torch.zeros((1, 4, tcfg.d_model)), tcfg, None)


# --------------------------------------------------------------- wrapper
def test_scan_wrapper_rejects_what_the_kernel_does_not_take():
    a = torch.zeros((1, 8, 4, 16))
    C = torch.zeros((1, 8, 16))
    with pytest.raises(TypeError):  # not 4-D
        tms.mamba_scan(a[0], a[0], C)
    with pytest.raises(TypeError):  # not float32
        tms.mamba_scan(a.double(), a.double(), C.double())
    with pytest.raises(ValueError):  # b differs
        tms.mamba_scan(a, torch.zeros((1, 8, 5, 16)), C)
    with pytest.raises(ValueError):  # C differs
        tms.mamba_scan(a, a, torch.zeros((1, 8, 8)))
    with pytest.raises(ValueError, match="d_state"):
        tms.mamba_scan(torch.zeros((1, 8, 4, 33)), torch.zeros((1, 8, 4, 33)),
                       torch.zeros((1, 8, 33)))
    with pytest.raises(ValueError, match="contiguous"):
        tms.mamba_scan(a.transpose(1, 2).contiguous().transpose(1, 2), a, C)
    with pytest.raises(ValueError, match="one device"):
        tms.mamba_scan(a, a.to("meta"), C)
    big = torch.empty((65536, 1, 1, 1), device="meta")
    with pytest.raises(ValueError, match="batch"):
        tms.mamba_scan(big, big, torch.empty((65536, 1, 1), device="meta"))
    # ops takes any float dtype and layout, as the JAX wrapper casts
    y, h = tops.mamba_scan(a.double().transpose(1, 2).contiguous().transpose(1, 2), a, C)
    assert y.dtype == h.dtype == torch.float32


def test_scan_wrapper_gives_no_plain_fallback_off_the_cpu():
    """Only CPU tensors take the plain version; others launch or raise."""
    a = torch.zeros((1, 8, 4, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tms.mamba_scan(a, a, torch.zeros((1, 8, 16), device="meta"))
