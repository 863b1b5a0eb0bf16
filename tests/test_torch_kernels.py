"""Port's moments kernel (plain version on the CPU) and wrappers vs the JAX package.

Inputs are made once with numpy from a seed and handed to both packages.
The Pallas kernel runs in interpret mode, as tests/test_kernels.py runs it.
On the CPU the port's wrapper takes its plain PyTorch version; the CUDA
kernel itself is held against that version on the card by chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import jax_ad as J  # noqa: E402
from repro.core.stats import StatsTable  # noqa: E402
from repro.kernels import ops as K  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moments import moments_and_labels as mo_raw  # noqa: E402
from repro_torch.core import torch_ad as T  # noqa: E402
from repro_torch.kernels import moments as tmo  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.ref import moments_and_labels_ref  # noqa: E402

CASES = [(64, 16, 32), (500, 128, 128), (1000, 7, 512)]  # tests/test_kernels.py:16


def _case_inputs(N, F):
    """The inputs of tests/test_kernels.py:test_moments_kernel_sweep."""
    rng = np.random.default_rng(N + F)
    fids = rng.integers(-1, F, N).astype(np.int32)  # includes padding (-1)
    durs = rng.lognormal(3, 1, N).astype(np.float32)
    prev_f = rng.integers(0, F, 4 * F).astype(np.int32)
    prev_x = rng.lognormal(3, 0.2, 4 * F).astype(np.float32)
    prev, _ = jref.moments_and_labels_ref(jnp.asarray(prev_f), jnp.asarray(prev_x),
                                          jnp.zeros((F, 5)))
    durs[:3] = 1e5
    return fids, durs, np.array(prev, np.float32)


def _assert_delta_close(d_t, d_j):
    """tests/test_kernels.py:32-36 tolerances: sums rtol 1e-5 atol 1e-2,
    min/max rtol 1e-6 on rows some event reached; counts exact."""
    d_t, d_j = np.asarray(d_t), np.asarray(d_j)
    np.testing.assert_array_equal(d_t[:, 0], d_j[:, 0])
    np.testing.assert_allclose(d_t[:, :3], d_j[:, :3], rtol=1e-5, atol=1e-2)
    seen = d_j[:, 0] > 0
    np.testing.assert_allclose(d_t[seen, 3:], d_j[seen, 3:], rtol=1e-6)
    np.testing.assert_array_equal(d_t[~seen, 3:], d_j[~seen, 3:])  # ±1e30 sentinels


@pytest.mark.parametrize("N,F,EB", CASES)
def test_moments_ref_matches_pallas_interpret(N, F, EB):
    fids, durs, prev = _case_inputs(N, F)
    d_j, l_j = mo_raw(jnp.asarray(fids), jnp.asarray(durs), jnp.asarray(prev),
                      block_events=EB, interpret=True)
    d_t, l_t = moments_and_labels_ref(torch.from_numpy(fids), torch.from_numpy(durs),
                                      torch.from_numpy(prev))
    _assert_delta_close(d_t.numpy(), d_j)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))  # labels exact


@pytest.mark.parametrize("N,F,EB", CASES)
def test_moments_wrapper_on_cpu_is_the_plain_version(N, F, EB):
    fids, durs, prev = (torch.from_numpy(a) for a in _case_inputs(N, F))
    before = tmo.launches
    d_w, l_w = tmo.moments_and_labels(fids, durs, prev, block_events=EB)
    d_r, l_r = moments_and_labels_ref(fids, durs, prev)
    assert torch.equal(d_w, d_r) and torch.equal(l_w, l_r)  # bitwise
    assert tmo.launches == before  # the plain version is never counted


@pytest.mark.parametrize("offset", [0, 5, 24])
def test_moments_fid_offset_masks_like_the_kernel(offset):
    """Fids outside [offset, offset + F) drop out like padding, as in the
    Pallas kernel (not clipped into row F-1 as repro.kernels.ref does)."""
    rng = np.random.default_rng(11 + offset)
    F = 8
    fids = rng.integers(-1, 40, 700).astype(np.int32)
    durs = rng.lognormal(3, 0.5, 700).astype(np.float32)
    prev_f = rng.integers(0, F, 6 * F).astype(np.int32)
    prev_x = rng.lognormal(3, 0.1, 6 * F).astype(np.float32)
    prev, _ = jref.moments_and_labels_ref(jnp.asarray(prev_f), jnp.asarray(prev_x),
                                          jnp.zeros((F, 5)))
    prev = np.array(prev, np.float32)
    d_j, l_j = mo_raw(jnp.asarray(fids), jnp.asarray(durs), jnp.asarray(prev),
                      block_events=128, fid_offset=offset, interpret=True)
    d_t, l_t = tmo.moments_and_labels(torch.from_numpy(fids), torch.from_numpy(durs),
                                      torch.from_numpy(prev), block_events=128,
                                      fid_offset=offset)
    _assert_delta_close(d_t.numpy(), d_j)
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))


def test_moments_update_matches_jax():
    """Twin of tests/test_kernels.py:40-62: the port's kernel-backed step
    against J.ad_step and the JAX ops.moments_update."""
    rng = np.random.default_rng(0)
    F = 32
    fids = rng.integers(0, F, 600).astype(np.int32)
    durs = rng.normal(100, 5, 600).astype(np.float32)
    t_ref, lab_ref = J.ad_step(J.init_table(F), jnp.asarray(fids), jnp.asarray(durs))
    t_jk, lab_jk = K.moments_update(J.init_table(F), jnp.asarray(fids), jnp.asarray(durs))
    t_k, lab_k = tops.moments_update(T.init_table(F, device="cpu"),
                                     torch.from_numpy(fids), torch.from_numpy(durs))
    t_k = t_k.numpy()
    for want in (np.asarray(t_ref), np.asarray(t_jk)):
        np.testing.assert_allclose(t_k[:, :2], want[:, :2], rtol=1e-5, atol=1e-3)
        # M2 via raw float32 sums cancels; sigma needs ~3 digits for 6 sigma.
        np.testing.assert_allclose(t_k[:, 2], want[:, 2], rtol=1e-2, atol=1e-1)
    np.testing.assert_array_equal(lab_k.numpy(), np.asarray(lab_ref))
    np.testing.assert_array_equal(lab_k.numpy(), np.asarray(lab_jk))
    # one extreme event flags identically
    f2, d2 = np.asarray([0, 1], np.int32), np.asarray([100.0, 9000.0], np.float32)
    _, l2r = J.ad_step(t_ref, jnp.asarray(f2), jnp.asarray(d2))
    _, l2k = tops.moments_update(torch.from_numpy(t_k), torch.from_numpy(f2),
                                 torch.from_numpy(d2))
    assert l2k.tolist() == np.asarray(l2r).tolist() == [0, 1]


@pytest.mark.parametrize("base", [0, 8, 24])
def test_moments_table_fid_offset_blocks(base):
    """Twin of tests/test_federation.py:338-356 against K.moments_table."""
    rng = np.random.default_rng(2)
    fids = rng.integers(0, 32, 500).astype(np.int32)
    durs = rng.lognormal(3, 0.5, 500).astype(np.float32)
    host = StatsTable(32)
    host.update_batch(fids.astype(np.int64), durs.astype(np.float64))
    d_j = np.asarray(K.moments_table(jnp.asarray(fids), jnp.asarray(durs), 8, fid_offset=base))
    d_t = tops.moments_table(torch.from_numpy(fids), torch.from_numpy(durs), 8,
                             fid_offset=base).numpy()
    np.testing.assert_array_equal(d_t[:, 0], d_j[:, 0])  # n exact
    np.testing.assert_array_equal(d_t[:, 0], host.counts()[base:base + 8])
    np.testing.assert_allclose(d_t[:, 1], d_j[:, 1], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(d_t[:, 1], host.means()[base:base + 8], rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(d_t[:, 3:], d_j[:, 3:])  # min/max are selections


def test_moments_wrapper_rejects_what_the_kernel_does_not_take():
    f = torch.zeros(16, dtype=torch.int32)
    d = torch.ones(16)
    table = torch.zeros((4, 5))
    with pytest.raises(TypeError):
        tmo.moments_and_labels(f.long(), d, table)
    with pytest.raises(TypeError):
        tmo.moments_and_labels(f, d.double(), table)
    with pytest.raises(TypeError):
        tmo.moments_and_labels(f, d, torch.zeros((4, 4)))
    with pytest.raises(ValueError):
        tmo.moments_and_labels(torch.zeros(32, dtype=torch.int32)[::2], d, table)
    with pytest.raises(ValueError):  # (F,5) accumulator beyond a block's shared memory
        tmo.moments_and_labels(f, d, torch.zeros((20000, 5)))
    with pytest.raises(ValueError):
        tmo.moments_and_labels(f, d, table.to("meta"))


@pytest.mark.parametrize("N,want", [
    (0, (1, 1, 8, 1)), (1, (1, 1, 8, 1)), (1000, (512, 2, 8, 1)),
    (51_200, (512, 100, 104, 13)), (262_144, (512, 512, 128, 16))])
def test_moments_launch_grid_is_fixed_by_the_stream(N, want, monkeypatch):
    """The sum order depends only on N and block_events (never the card):
    a fixed grid of whole 8-CTA clusters, at most 128 CTAs, one partial per
    cluster, whatever the SM count."""
    grids = []
    for sms in (132, 114, 16):
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda *a, sms=sms: type("P", (), {"multi_processor_count": sms}))
        grids.append(tmo.grid(N, 512))
    assert grids == [want] * 3
    eb, chunks, ctas, clusters = want
    assert ctas % tmo.CLUSTER == 0 and tmo.CLUSTER <= ctas <= tmo.MAX_CTAS
    assert clusters == ctas // tmo.CLUSTER
    assert chunks * eb >= N and ctas >= min(chunks, tmo.MAX_CTAS)
    assert tmo.smem_bytes(2048, 512) <= tmo.SMEM_LIMIT


_F16, _D16, _T4 = (torch.zeros(16, dtype=torch.int32), torch.ones(16), torch.zeros((4, 5)))
# Each input the wrapper refuses, with the exception type and message it has
# always raised (the checks were trimmed for host time, not changed).
_BAD_INPUTS = {
    "fids int64": ((_F16.long(), _D16, _T4), {}, TypeError,
                   "fids must be a 1-D int32 tensor, got torch.int64 (16,)"),
    "fids 2-D": ((_F16.view(4, 4), _D16.view(4, 4), _T4), {}, TypeError,
                 "fids must be a 1-D int32 tensor, got torch.int32 (4, 4)"),
    "durs float64": ((_F16, _D16.double(), _T4), {}, TypeError,
                     "durs must be float32 of shape (16,), got torch.float64 (16,)"),
    "durs shape": ((_F16, torch.ones(15), _T4), {}, TypeError,
                   "durs must be float32 of shape (16,), got torch.float32 (15,)"),
    "table 4 columns": ((_F16, _D16, torch.zeros((4, 4))), {}, TypeError,
                        "table_sums must be (F, 5) float32, got torch.float32 (4, 4)"),
    "table 1-D": ((_F16, _D16, torch.zeros(5)), {}, TypeError,
                  "table_sums must be (F, 5) float32, got torch.float32 (5,)"),
    "table float64": ((_F16, _D16, _T4.double()), {}, TypeError,
                      "table_sums must be (F, 5) float32, got torch.float64 (4, 5)"),
    "table on meta": ((_F16, _D16, _T4.to("meta")), {}, ValueError,
                      "fids, durs and table_sums must lie on one device"),
    "fids strided": ((torch.zeros(32, dtype=torch.int32)[::2], _D16, _T4), {}, ValueError,
                     "fids, durs and table_sums must be contiguous"),
    "table strided": ((_F16, _D16, torch.zeros((4, 10))[:, ::2]), {}, ValueError,
                      "fids, durs and table_sums must be contiguous"),
    "no rows": ((_F16, _D16, torch.zeros((0, 5))), {}, ValueError,
                "table_sums needs at least one row"),
    "block_events 0": ((_F16, _D16, _T4), {"block_events": 0}, ValueError,
                       "block_events must be positive"),
    "F 20000": ((_F16, _D16, torch.zeros((20000, 5))), {}, ValueError,
                "F=20000 with block_events=512 exceeds a block's 232448 bytes of shared memory"),
    "all on meta": ((_F16.to("meta"), _D16.to("meta"), _T4.to("meta")), {}, ValueError,
                    "moments_and_labels runs on cuda or cpu, not meta"),
}


@pytest.mark.parametrize("case", list(_BAD_INPUTS))
def test_moments_wrapper_check_raises_the_same_type_and_message(case):
    args, kw, exc, msg = _BAD_INPUTS[case]
    before = tmo.launches
    with pytest.raises(exc) as err:
        tmo.moments_and_labels(*args, **kw)
    assert str(err.value) == msg
    assert tmo.launches == before


def test_moments_workspace_is_kept_per_device_and_stream(monkeypatch):
    """One set of tickets (one per cluster rank) and one partials buffer per
    (device, stream), made once and grown (the tickets kept) when a call
    needs more partials."""
    monkeypatch.setattr(tmo, "_workspaces", {})
    cpu = torch.device("cpu")
    t1, p1 = tmo._workspace(0, 11, cpu, 5 * 7)
    assert t1.dtype == torch.int32 and t1.tolist() == [0] * tmo.CLUSTER and p1.numel() == 35
    assert tmo._workspace(0, 11, cpu, 20) == (t1, p1)  # no new allocation
    t2, p2 = tmo._workspace(0, 22, cpu, 35)  # another stream: its own
    assert t2.data_ptr() != t1.data_ptr() and p2.data_ptr() != p1.data_ptr()
    t3, p3 = tmo._workspace(0, 11, cpu, 16 * 5 * 2048)
    assert t3 is t1 and p3.numel() == 16 * 5 * 2048
    assert sorted(tmo._workspaces) == [(0, 11), (0, 22)]


def test_moments_wrapper_gives_no_plain_fallback_off_the_cpu():
    """Only CPU tensors take the plain version; others launch or raise."""
    f = torch.zeros(16, dtype=torch.int32, device="meta")
    d = torch.ones(16, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tmo.moments_and_labels(f, d, torch.zeros((4, 5), device="meta"))


def test_kernel_build_needs_nvcc_and_is_keyed_by_its_source(tmp_path, monkeypatch):
    from repro_torch.kernels import _build

    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "moments.cu").write_bytes((_build.CSRC / "moments.cu").read_bytes())
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.sources() == ["moments"]
    first = _build.target("moments")
    assert first.parent == tmp_path / "build" and first.name.startswith("libmoments-")
    assert _build.target("moments") == first  # same source, same library
    (csrc / "moments.cu").write_text((csrc / "moments.cu").read_text() + "\n// edit\n")
    assert _build.target("moments") != first  # an edited source is rebuilt
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_DEFAULT", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    assert not list((tmp_path / "build").glob("*.so"))


def _chip_smoke():
    """chip_smoke.py as a module (it imports no CUDA code at import time)."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_MOMENTS_FN = "_ZN43_GLOBAL__N__137d2b45_10_moments_cu_7ffa2dda15moments_clusterENS_4ArgsE"
_FLOOR_FN = "_ZN43_GLOBAL__N__137d2b45_10_moments_cu_7ffa2dda20moments_launch_floorEv"


def _ptxas(spill_stores):
    return "\n".join([
        f"ptxas info    : Compiling entry function '{_FLOOR_FN}' for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 4 registers, used 0 barriers",
        f"ptxas info    : Compiling entry function '{_MOMENTS_FN}' for 'sm_90a'",
        f"ptxas info    : Function properties for {_MOMENTS_FN}",
        f"    0 bytes stack frame, {spill_stores} bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 122 registers, used 1 barriers"])


def _sass(ops):
    lines = [f"        /*{16 * i:04x}*/                   {op} R1, R2 ;   /* 0x0 */"
             for i, op in enumerate(ops)]
    return "\n".join([f"\t\tFunction : {_FLOOR_FN}", "        /*0000*/   EXIT ;",
                      f"\t\tFunction : {_MOMENTS_FN}", *lines])


@pytest.mark.parametrize("spills,ops,fault", [
    (0, ["UCGABAR_ARV", "LD.E", "UCGABAR_WAIT", "LDS", "ATOM.E.ADD"], None),
    (8, ["UCGABAR_ARV", "LD.E", "UCGABAR_WAIT"], "spills"),
    (0, ["LD.E", "LDS", "LDG.E"], "cluster barrier"),
    (0, ["UCGABAR_ARV", "UCGABAR_WAIT", "LDS"], "distributed shared memory"),
])
def test_chip_smoke_reads_the_moments_kernels_ptxas_and_sass(monkeypatch, spills, ops, fault):
    """chip_smoke.py takes the moments kernel's ptxas line and SASS counts
    from the build, and fails where the kernel spills or lacks the cluster
    barrier or distributed-shared-memory loads."""
    from repro_torch.kernels import _build

    cs = _chip_smoke()
    monkeypatch.setattr(_build, "build_log", lambda name: _ptxas(spills))
    monkeypatch.setattr(_build, "nvcc", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(cs, "run_text", lambda cmd: _sass(ops))
    if fault is None:
        facts = cs.moments_build_facts()
        assert "Used 122 registers" in facts["ptxas"]
        assert facts["sass"]["UCGABAR_ARV"] == facts["sass"]["UCGABAR_WAIT"] == 1
        assert facts["sass"]["LD"] == facts["sass"]["ATOM"] == 1 and facts["sass"]["total"] == 5
    else:
        with pytest.raises(AssertionError, match=fault):
            cs.moments_build_facts()
