"""The port's int8 gradient compression and data-parallel step vs the JAX package.

``quantize`` codes and scales are held equal to JAX's bit for bit (a
hypothesis property, the twin of tests/test_misc.py:20,32).  Four gloo
processes run ``compressed_psum`` and the data-parallel step
(``make_dp_train_step``) on the same numpy inputs that JAX runs on four
host devices in a child process: the mean at rtol 1e-6 and each rank's
error feedback against JAX's stacked state; the first losses at rtol 1e-5
on the smoke gemma-2b computing in float32 (in bf16 the step-0 loss
agrees to ~1e-6, but AdamW turns one-ulp bf16 gradient differences into
~5e-5 in the next losses); 30 steps of the bf16 smoke model converging by
tests/test_training.py:117's criteria, as JAX's do; and the collectives
the step records: one all-reduce per parameter leaf and one for the loss.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import compression as JC  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.optim import compression as TC  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------ quantisation
@given(
    st.lists(
        st.floats(min_value=-1e4, max_value=1e4, allow_nan=False, width=32),
        min_size=1, max_size=600,
    )
)
@settings(max_examples=40, deadline=None)
def test_quantize_codes_and_scales_equal_jax(xs):
    x = np.asarray(xs, np.float32)
    jcodes, jscale = JC.quantize(jnp.asarray(x))
    codes, scale = TC.quantize(torch.from_numpy(x))
    assert codes.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    back = TC.dequantize(codes, scale, x.shape)
    np.testing.assert_array_equal(back.numpy(), np.asarray(JC.dequantize(jcodes, jscale, x.shape)))
    # error bounded by half a quantization step per block (test_misc.py:28-31)
    blocks = np.pad(x, (0, (-len(xs)) % TC.BLOCK)).reshape(-1, TC.BLOCK)
    step = np.abs(blocks).max(axis=1, keepdims=True) / 127.0
    bound = np.repeat(step, TC.BLOCK, axis=1).reshape(-1)[: len(xs)] * 0.51 + 1e-7
    assert (np.abs(back.numpy() - x) <= bound).all()


def test_quantize_preserves_zero_and_extremes():
    x = torch.tensor([0.0, 127.0, -127.0, 1.0])
    codes, scale = TC.quantize(x)
    np.testing.assert_allclose(TC.dequantize(codes, scale, x.shape).numpy(), x.numpy(), atol=0.5)


def test_quantize_rounds_half_to_even_as_jnp_round():
    x = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5], np.float32)
    codes, _ = TC.quantize(torch.from_numpy(x))
    np.testing.assert_array_equal(codes.numpy()[0, :7], np.asarray(JC.quantize(jnp.asarray(x))[0])[0, :7])
    np.testing.assert_array_equal(codes.numpy()[0, :7], [127, 0, 2, 2, 0, -2, 4])


def test_error_state_from_jax_takes_each_ranks_slice():
    rng = np.random.default_rng(3)
    err = {"embed": rng.normal(size=(4, 6, 3)).astype(np.float32),
           "layers": [{"wq": rng.normal(size=(4, 2, 3, 5)).astype(np.float32)}]}
    for r in range(4):
        got = convert.error_state_from_jax(err, r, device="cpu")
        np.testing.assert_array_equal(got["embed"].numpy(), err["embed"][r])
        np.testing.assert_array_equal(got["layers"][0]["wq"].numpy(), err["layers"][0]["wq"][r])
        assert got["embed"].dtype == torch.float32
    with pytest.raises(ValueError, match="rank 4"):
        convert.error_state_from_jax(err, 4, device="cpu")


def test_init_error_state_is_float32_zeros_shaped_like_the_params():
    params = {"a": torch.ones(3, 2, dtype=torch.bfloat16), "layers": [{"b": torch.ones(5)}]}
    err = TC.init_error_state(params)
    for p, e in zip(T.leaves(params), T.leaves(err)):
        assert e.shape == p.shape and e.dtype == torch.float32 and not e.any()


# ------------------------------------------------- four ranks against JAX
_WORLD = 4
_STEPS = 30
_TIMEOUT = 300

_JAX_SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.compat import shard_map
from repro.data.pipeline import synthetic_batch
from repro.launch.steps import make_dp_train_step, make_train_state
from repro.optim.adamw import OptConfig
from repro.optim.compression import compressed_psum
inp = np.load(sys.argv[1]); steps = int(sys.argv[3]); out = {}
mesh = jax.make_mesh((4,), ("data",))

def local(g, e):
    m, ne = compressed_psum(g[0], "data", e[0])
    return m[None], ne[None]

f = jax.jit(shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
                      out_specs=(P("data"), P("data")), check_vma=False))
mean, err = f(jnp.asarray(inp["g"]), jnp.asarray(inp["e"]))
out["psum_mean"], out["psum_err"] = np.asarray(mean), np.asarray(err)

bf16 = configs.smoke("gemma-2b")
batch = synthetic_batch(bf16, 8, 32, seed=0)
out["tokens"], out["labels"] = np.asarray(batch["tokens"]), np.asarray(batch["labels"])
for i, leaf in enumerate(jax.tree.leaves(make_train_state(bf16, 0)["params"])):
    out[f"p{i}"] = np.asarray(leaf)
for name, cfg, n in (("f32", dataclasses.replace(bf16, compute_dtype=jnp.float32), 3),
                     ("bf16", bf16, steps)):
    for compress in (False, True):
        step_fn, init_err = make_dp_train_step(
            cfg, mesh, OptConfig(peak_lr=3e-3, warmup_steps=5, weight_decay=0.0),
            compress=compress)
        state = make_train_state(cfg, 0)
        err = init_err(state["params"])
        losses = []
        for s in range(n):
            state, err, m = step_fn(state, err, batch)
            losses.append(float(m["loss"]))
            if s == 0:
                for i, leaf in enumerate(jax.tree.leaves(err)):
                    out[f"err{name}{int(compress)}_{i}"] = np.asarray(leaf)
        out[f"losses{name}{int(compress)}"] = np.asarray(losses)
np.savez(sys.argv[2], **out)
print("JAX_DP_OK")
"""

_TORCH_WORKER = r"""
import dataclasses, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch import compat, configs, convert, tree as T
from repro_torch.launch import roofline as R, steps as TS
from repro_torch.optim import compression as C
from repro_torch.optim.adamw import OptConfig
rank, world, init, inputs, jax_out, outdir, steps = sys.argv[1:8]
rank, world, steps = int(rank), int(world), int(steps)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=world)
mesh = compat.make_mesh((world,), ("data",), device="cpu")
inp, jx = np.load(inputs), np.load(jax_out)
out = {}
mean, err = C.compressed_psum(torch.from_numpy(inp["g"][rank]), mesh.get_group(),
                              torch.from_numpy(inp["e"][rank]))
out["psum_mean"], out["psum_err"] = mean.numpy(), err.numpy()

bf16 = configs.smoke("gemma-2b")
rows = slice(rank * 8 // world, (rank + 1) * 8 // world)
batch = {k: torch.from_numpy(np.ascontiguousarray(jx[k][rows])) for k in ("tokens", "labels")}
for name, cfg, n_steps, compress in (
        (name, cfg, n_steps, compress)
        for name, cfg, n_steps in (("f32", dataclasses.replace(bf16, compute_dtype=torch.float32), 3),
                                   ("bf16", bf16, steps))
        for compress in (False, True)):
    step_fn, init_err = TS.make_dp_train_step(
        cfg, mesh, OptConfig(peak_lr=3e-3, warmup_steps=5, weight_decay=0.0), compress=compress)
    state = TS.make_train_state(cfg, 0, device="cpu")
    n = len(T.leaves(state["params"]))
    state["params"] = T.unflatten(state["params"],
                                  [torch.from_numpy(jx[f"p{i}"]).clone() for i in range(n)])
    # JAX's stacked (ndev, ...) error state, rank r's slice
    err = convert.error_state_from_jax(
        T.map(lambda p: np.zeros((world,) + tuple(p.shape), np.float32), state["params"]),
        rank, device="cpu")
    losses = []
    for s in range(n_steps):
        if s == 0:
            rec = compat.CollectiveRecorder()
            with rec:
                state, err, m = step_fn(state, err, batch)
            coll = R.collective_bytes(rec.collectives)
            out[f"coll{name}{int(compress)}"] = np.asarray(
                [coll["all-reduce"]["count"], coll["all-reduce"]["result_bytes"],
                 coll["all-reduce"]["wire_bytes"],
                 sum(v["count"] for k, v in coll.items() if k != "all-reduce")])
            for i, e in enumerate(T.leaves(err)):
                out[f"err{name}{int(compress)}_{i}"] = e.numpy().copy()  # updated in place
        else:
            state, err, m = step_fn(state, err, batch)
        losses.append(float(m["loss"]))
    out[f"losses{name}{int(compress)}"] = np.asarray(losses)
out["n_leaves"] = np.asarray(n)
out["param_bytes"] = np.asarray(sum(p.numel() * 4 for p in T.leaves(state["params"])))
np.savez(f"{outdir}/rank{rank}.npz", **out)
dist.destroy_process_group()
print("TORCH_DP_OK", rank)
"""


@pytest.fixture(scope="module")
def dp_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(11)
    g = rng.normal(0, 1, (_WORLD, 5, 77)).astype(np.float32)
    g[1, 2, 3] = 40.0  # one block with a large scale
    e = rng.normal(0, 0.01, (_WORLD, 5, 77)).astype(np.float32)
    np.savez(d / "inputs.npz", g=g, e=e)
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    jax_run = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(d / "inputs.npz"), str(d / "jax.npz"),
         str(_STEPS)], capture_output=True, text=True, timeout=_TIMEOUT, env=env)
    assert "JAX_DP_OK" in jax_run.stdout, jax_run.stdout[-2000:] + jax_run.stderr[-3000:]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TORCH_WORKER, str(r), str(_WORLD), str(d / "pg"),
         str(d / "inputs.npz"), str(d / "jax.npz"), str(d), str(_STEPS)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(_WORLD)]
    try:
        logs = [p.communicate(timeout=_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"TORCH_DP_OK {r}" in text, text[-3000:]
    return (np.load(d / "jax.npz"), [np.load(d / f"rank{r}.npz") for r in range(_WORLD)],
            d / "inputs.npz")


def test_compressed_psum_over_four_gloo_ranks_matches_jax(dp_runs):
    jx, ranks, inputs = dp_runs
    inp = np.load(inputs)
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["psum_mean"], jx["psum_mean"][r], rtol=1e-6, atol=1e-7)
        # the residual target − dequantised cancels: XLA may contract the
        # subtraction into an FMA, so it is held to 2 ulps of the target
        target = inp["g"][r] + inp["e"][r]
        assert (np.abs(got["psum_err"] - jx["psum_err"][r])
                <= 2 * np.spacing(np.abs(target))).all()


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
def test_dp_step_first_losses_match_jax(dp_runs, compress):
    jx, ranks, _ = dp_runs
    for name in ("f32", "bf16"):
        key = f"losses{name}{int(compress)}"
        for got in ranks:  # the loss is averaged over the ranks: every rank holds it
            np.testing.assert_array_equal(got[key], ranks[0][key])
    np.testing.assert_allclose(ranks[0][f"lossesf32{int(compress)}"], jx[f"lossesf32{int(compress)}"],
                               rtol=1e-5)
    np.testing.assert_allclose(ranks[0][f"lossesbf16{int(compress)}"][0],
                               jx[f"lossesbf16{int(compress)}"][0], rtol=1e-5)


def test_dp_step_error_feedback_per_rank_matches_jax(dp_runs):
    """After one compressed float32 step, rank r's residual is JAX's err[r]
    up to the two gradients' float32 differences (~1e-5 of the gradient,
    whose largest element is ~254 times the largest residual), except where
    a code sits on a rounding boundary and flips: there the residual moves
    by one quantisation step, at most twice the largest residual."""
    jx, ranks, _ = dp_runs
    n = int(ranks[0]["n_leaves"])
    for r, got in enumerate(ranks):
        for i in range(n):
            want = jx[f"errf321_{i}"][r]
            diff = np.abs(got[f"errf321_{i}"] - want)
            top = np.abs(want).max()
            assert (diff <= 2.5e-3 * top).mean() > 0.999, (r, i, diff.max(), top)
            assert diff.max() <= 2.01 * top
            assert not got[f"errf320_{i}"].any()  # uncompressed: the error stays 0


def test_dp_compressed_training_converges(dp_runs):
    """tests/test_training.py:117's criteria on the port's four ranks."""
    jx, ranks, _ = dp_runs
    l0, l1 = ranks[0]["lossesbf160"], ranks[0]["lossesbf161"]
    assert len(l0) == len(l1) == _STEPS
    assert l0[-1] < l0[0] * 0.6, ("uncompressed did not converge", l0[::6])
    assert l1[-1] < l1[0] * 0.6, ("compressed did not converge", l1[::6])
    assert abs(l1[-1] - l0[-1]) / l0[-1] < 0.35, (l0[-1], l1[-1])
    # JAX's run meets them too, and ends near the port's
    assert jx["lossesbf161"][-1] < jx["lossesbf161"][0] * 0.6
    np.testing.assert_allclose(l1[-1], jx["lossesbf161"][-1], rtol=0.1)


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
def test_dp_step_records_one_all_reduce_per_leaf(dp_runs, compress):
    """One all-reduce per parameter leaf (float32 gradients) and one for
    the loss; collective_bytes gives their bytes with the ring factor 2."""
    _, ranks, _ = dp_runs
    for got in ranks:
        count, result, wire, others = got[f"collbf16{int(compress)}"]
        assert count == int(got["n_leaves"]) + 1 and others == 0
        assert result == int(got["param_bytes"]) + 4
        assert wire == 2 * result
