"""The Mamba staging kernel (``ops.mamba_stage``) against its plain version on the card.

The kernel writes the scan elements a = exp(Δt·A) and b = (Δt·x)·B; the
plain version is ``ref.mamba_stage_ref``.
Both round every product once and dt·x once in the compute dtype, and both
use CUDA's accurate expf, so they agree bit for bit.  Every test needs a
card and skips without one; this file imports no JAX, so it runs where the
card is.  The CPU side (wrapper checks, the CPU route) is in
tests/test_torch_mamba.py.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import mamba_stage as tmst  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import mamba_stage_ref  # noqa: E402
from repro_torch.models import mamba as TMB  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402

CASES = [  # (B, S, di, st, dtype)
    (2, 1024, 8192, 16, torch.bfloat16),  # falcon-mamba-7b's layer, its wave cut to B 2
    (2, 4096, 8192, 16, torch.bfloat16),  # jamba-v0.1's layer, its wave cut to B 2
    (2, 1024, 8192, 16, torch.float32),
    (2, 33, 50, 16, torch.bfloat16),  # ragged d_inner
    (3, 1, 64, 16, torch.bfloat16),  # S 1
    (1, 20, 9, 1, torch.bfloat16),
    (2, 12, 5, 5, torch.float32),
    (1, 12, 5, 32, torch.bfloat16),
    (2, 7, 24, 8, torch.float32),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(card, B, S, di, st, dtype, seed):
    """Δt as softplus gives it, x and B ~ N(0, 1), A = -exp(A_log) with
    Mamba's A_log = log(1..st): exp(Δt·A) spans (0, 1]."""
    g = torch.Generator(device=card).manual_seed(seed)
    dt = torch.nn.functional.softplus(torch.randn((B, S, di), generator=g, device=card) - 2)
    x = torch.randn((B, S, di), generator=g, device=card)
    Bm = torch.randn((B, S, st), generator=g, device=card)
    A = -torch.arange(1, st + 1, dtype=torch.float32, device=card).repeat(di, 1)
    A = A * torch.empty((di, 1), device=card).uniform_(0.5, 1.5, generator=g)
    return dt.to(dtype), x.to(dtype), Bm.to(dtype), A


def _bitwise(got, want):
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,di,st,dtype", CASES)
def test_stage_kernel_is_the_plain_staging_bitwise(card, B, S, di, st, dtype):
    dt, x, Bm, A = _inputs(card, B, S, di, st, dtype, seed=B * S + di + st)
    before = tmst.launches
    a, b = ops.mamba_stage(dt, x, Bm, A)
    assert tmst.launches == before + 1
    want_a, want_b = mamba_stage_ref(dt, x, Bm, A)
    torch.cuda.synchronize()
    assert a.shape == b.shape == (B, S, di, st) and a.dtype == b.dtype == torch.float32
    assert a.is_contiguous() and b.is_contiguous()
    assert _bitwise(a, want_a), f"a differs in {int((a != want_a).sum())} elements"
    assert _bitwise(b, want_b), f"b differs in {int((b != want_b).sum())} elements"


@pytest.mark.cuda
def test_stage_kernel_reads_A_at_any_offset(card):
    """A at a 4-byte offset (a contiguous view into a larger buffer): the
    kernel reads it element by element, with the same result."""
    dt, x, Bm, A = _inputs(card, 2, 40, 96, 16, torch.bfloat16, seed=7)
    shifted = torch.empty(A.numel() + 1, device=card)[1:].view_as(A)
    shifted.copy_(A)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    a, b = ops.mamba_stage(dt, x, Bm, shifted)
    want_a, want_b = mamba_stage_ref(dt, x, Bm, A)
    assert _bitwise(a, want_a) and _bitwise(b, want_b)


@pytest.mark.cuda
@pytest.mark.parametrize("width,dtype", [("published", torch.bfloat16),
                                         ("smoke", torch.float32)])
def test_prefill_with_the_stage_kernel_equals_the_plain_staging(card, monkeypatch, width, dtype):
    """mamba_prefill's output and decode state with the kernel are bitwise
    those of the same call with ops.mamba_stage swapped for the plain
    staging (falcon-mamba-7b's layer: one layer at its published widths, and
    the smoke widths in float32)."""
    cfg = configs.get_config("falcon-mamba-7b")
    cfg = cfg if width == "published" else configs.reduce_for_smoke(cfg)
    cfg = dataclasses.replace(cfg, n_layers=1, compute_dtype=dtype)
    (layer,) = TM.compute_params(cfg, init_params(cfg, 0, card))["layers"]
    p = {k: v[0] for k, v in layer.items()}
    g = torch.Generator(device=card).manual_seed(1)
    u = torch.randn((2, 256, cfg.d_model), generator=g, device=card).to(dtype)
    with torch.no_grad():
        before = tmst.launches
        out, state = TMB.mamba_prefill(p, u, cfg)
        assert tmst.launches == before + 1
        monkeypatch.setattr(ops, "mamba_stage", mamba_stage_ref)
        want, want_state = TMB.mamba_prefill(p, u, cfg)
    assert torch.equal(out, want)
    for name in ("h", "conv"):
        assert torch.equal(state[name], want_state[name])
