"""The port's slice as a whole vs the JAX package, and tables carried across.

Traces -> call stacks -> on-device AD step, through repro (sim, callstack,
jax_ad, Pallas moments in interpret mode) and through repro_torch (its own
copies of sim and callstack, torch_ad, the moments plain version on the
CPU), from the same seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import callstack as j_callstack  # noqa: E402
from repro.core import jax_ad as J  # noqa: E402
from repro.core import sim as j_sim  # noqa: E402
from repro.core.stats import StatsTable as JStatsTable  # noqa: E402
from repro.kernels import ops as K  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import callstack as t_callstack  # noqa: E402
from repro_torch.core import sim as t_sim  # noqa: E402
from repro_torch.core import torch_ad as T  # noqa: E402
from repro_torch.core.stats import StatsTable  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

RANKS, STEPS = 8, 10


def _spec(sim, kind):
    if kind == "nwchem":
        return sim.nwchem_like(anomaly_rate=0.02, roots_per_frame=4)
    return sim.uniform_workload(n_funcs=12, depth=3, anomaly_rate=0.02, seed=3)


def _step_events(gen, builders, step):
    """(records per rank, (R, E) fids and runtimes padded with -1)."""
    recs = [b.process(gen.frame(r, step)[0])[0] for r, b in enumerate(builders)]
    E = max(len(r) for r in recs)
    fids = np.full((len(recs), E), -1, np.int32)
    durs = np.zeros((len(recs), E), np.float32)
    for r, rec in enumerate(recs):
        fids[r, :len(rec)] = rec["fid"]
        durs[r, :len(rec)] = rec["runtime"]
    return recs, fids, durs


@pytest.mark.parametrize("kind", ["nwchem", "uniform"])
def test_copied_sim_and_callstack_are_byte_identical(kind):
    gj = j_sim.WorkloadGenerator(_spec(j_sim, kind), n_ranks=4, seed=9)
    gt = t_sim.WorkloadGenerator(_spec(t_sim, kind), n_ranks=4, seed=9)
    assert gj.registry.names == gt.registry.names
    bj = [j_callstack.CallStackBuilder(rank=r) for r in range(4)]
    bt = [t_callstack.CallStackBuilder(rank=r) for r in range(4)]
    for step in range(3):
        for r in range(4):
            (fj, tj), (ft, tt) = gj.frame(r, step), gt.frame(r, step)
            assert fj.func_events.tobytes() == ft.func_events.tobytes()
            assert fj.comm_events.tobytes() == ft.comm_events.tobytes()
            assert tj.tobytes() == tt.tobytes()
            rj, rt = bj[r].process(fj)[0], bt[r].process(ft)[0]
            assert rj.dtype == rt.dtype and rj.tobytes() == rt.tobytes()


def test_slice_matches_jax_end_to_end():
    """sim -> callstack -> ad_step and -> moments_update, 8 ranks x 10 steps."""
    gj = j_sim.WorkloadGenerator(_spec(j_sim, "nwchem"), n_ranks=RANKS, seed=5)
    gt = t_sim.WorkloadGenerator(_spec(t_sim, "nwchem"), n_ranks=RANKS, seed=5)
    bj = [j_callstack.CallStackBuilder(rank=r) for r in range(RANKS)]
    bt = [t_callstack.CallStackBuilder(rank=r) for r in range(RANKS)]
    F = len(gt.registry)
    tj, tjk = J.init_table(F), J.init_table(F)
    tt, ttk = T.init_table(F, device="cpu"), T.init_table(F, device="cpu")
    host = StatsTable(F)
    flagged = 0
    for step in range(STEPS):
        rec_j, fj, dj = _step_events(gj, bj, step)
        rec_t, ft, dt = _step_events(gt, bt, step)
        assert all(a.tobytes() == b.tobytes() for a, b in zip(rec_j, rec_t))
        np.testing.assert_array_equal(fj, ft)
        np.testing.assert_array_equal(dj, dt)
        valid = ft >= 0
        host.update_batch(ft[valid].astype(np.int64), dt[valid].astype(np.float64))

        tj, lj = J.ad_step(tj, jnp.asarray(fj.reshape(-1)), jnp.asarray(dj.reshape(-1)))
        tt, lt = T.ad_step(tt, torch.from_numpy(ft.reshape(-1)), torch.from_numpy(dt.reshape(-1)))
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))  # labels exact
        a, b = tt.numpy(), np.asarray(tj)
        np.testing.assert_array_equal(a[:, T.N], b[:, J.N])
        np.testing.assert_allclose(a[:, T.MEAN], b[:, J.MEAN], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(a[:, T.M2], b[:, J.M2], rtol=1e-3, atol=1.0)

        tjk, ljk = K.moments_update(tjk, jnp.asarray(fj.reshape(-1)), jnp.asarray(dj.reshape(-1)))
        ttk, ltk = tops.moments_update(ttk, torch.from_numpy(ft), torch.from_numpy(dt))
        np.testing.assert_array_equal(ltk.numpy(), np.asarray(ljk))
        a, b = ttk.numpy(), np.asarray(tjk)
        np.testing.assert_array_equal(a[:, T.N], b[:, J.N])
        np.testing.assert_allclose(a[:, T.MEAN], b[:, J.MEAN], rtol=1e-4, atol=1e-3)
        # raw-sums M2 (tests/test_kernels.py:52-55)
        np.testing.assert_allclose(a[:, T.M2], b[:, J.M2], rtol=1e-2, atol=1e-1)
        flagged += int(lt.sum())
    np.testing.assert_array_equal(tt.numpy()[:, T.N], host.counts())
    np.testing.assert_allclose(tt.numpy()[:, T.MEAN], host.means(), rtol=1e-4, atol=1e-3)
    assert flagged > 0  # the injected delays reach the labels


def _jax_table(steps=3, F=9, seed=6):
    rng = np.random.default_rng(seed)
    t = J.init_table(F)
    for _ in range(steps):
        t, _ = J.ad_step(t, jnp.asarray(rng.integers(-1, F - 1, 400), jnp.int32),
                         jnp.asarray(rng.lognormal(3, 0.5, 400), jnp.float32))
    return t, rng


def test_table_from_jax_roundtrip_and_resume():
    tj, rng = _jax_table()
    tt = convert.table_from_jax(np.asarray(tj), device="cpu")
    assert tt.dtype == torch.float32 and tt.device.type == "cpu"
    np.testing.assert_array_equal(convert.table_to_numpy(tt), np.asarray(tj))  # bitwise
    # A JAX-side table resumes in the port, and a port table back in JAX.
    f = rng.integers(0, 9, 300).astype(np.int32)
    d = rng.lognormal(3, 0.5, 300).astype(np.float32)
    d[:2] = 1e4
    tj2, lj = J.ad_step(tj, jnp.asarray(f), jnp.asarray(d))
    tt2, lt = T.ad_step(tt, torch.from_numpy(f), torch.from_numpy(d))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert int(lt[:2].sum()) == 2
    back, _ = J.ad_step(jnp.asarray(convert.table_to_numpy(tt)), jnp.asarray(f), jnp.asarray(d))
    np.testing.assert_array_equal(np.asarray(back), np.asarray(tj2))
    np.testing.assert_array_equal(tt2.numpy()[:, T.N], np.asarray(tj2)[:, J.N])
    np.testing.assert_allclose(tt2.numpy()[:, T.MEAN], np.asarray(tj2)[:, J.MEAN], rtol=1e-4)


def test_table_from_host_picks_moment_columns_and_resumes():
    rng = np.random.default_rng(8)
    host = JStatsTable(6)
    f = rng.integers(0, 5, 500)
    x = rng.normal(80, 6, 500)
    host.update_batch(f, x)
    tt = convert.table_from_host(host.table, device="cpu")
    assert tuple(tt.shape) == (6, 5)
    want = host.table[:, [0, 1, 2, 5, 6]].astype(np.float32)  # N, MEAN, M2, MIN, MAX
    np.testing.assert_array_equal(tt.numpy(), want)
    f2 = np.asarray([0, 1, 4, 5], np.int32)
    d2 = np.asarray([80.0, 400.0, 81.0, 80.0], np.float32)
    _, lt = T.ad_step(tt, torch.from_numpy(f2), torch.from_numpy(d2))
    _, lj = J.ad_step(jnp.asarray(want), jnp.asarray(f2), jnp.asarray(d2))
    assert lt.tolist() == np.asarray(lj).tolist() == [0, 1, 0, 0]


def test_convert_rejects_other_shapes():
    with pytest.raises(ValueError):
        convert.table_from_jax(np.zeros((4, 7)), device="cpu")
    with pytest.raises(ValueError):
        convert.table_from_host(np.zeros((4, 5)), device="cpu")
    with pytest.raises(ValueError):
        convert.table_to_numpy(torch.zeros(4))
