"""Port's optimizer, loss and train step vs the JAX package, on the CPU.

Trees and batches are numpy from a seed and go to both packages.  In
float32 compute the loss is held at rtol 1e-5 and every gradient leaf at
rtol 1e-4 / atol 1e-6.  One bf16 train step is held against JAX run in a
child process with ``--xla_allow_excess_precision=false`` (see
tests/test_torch_models.py) at rtol 1e-2 / atol 2e-3 on the params, the
tolerance of tests/test_training.py:55-60.
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
from repro.data import pipeline as JD  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models.common import init_params as j_init_params  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.data import pipeline as TD  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
B, S = 2, 24


def _f32_cfgs(arch="gemma-2b"):
    return (dataclasses.replace(jconfigs.smoke(arch), compute_dtype=jnp.float32),
            dataclasses.replace(tconfigs.smoke(arch), compute_dtype=torch.float32))


def _random_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (7, 5)).astype(np.float32),
            "b": [rng.normal(0, 1, (5,)).astype(np.float32),
                  {"z": rng.normal(0, 3, (3, 2, 4)).astype(np.float32)}]}


# ------------------------------------------------------------ optimizer
def _schedules(**kw):
    cfg, jcfg = TA.OptConfig(**kw), JA.OptConfig(**kw)
    steps = np.arange(0, cfg.decay_steps + 11, dtype=np.int32)
    got = TA.schedule(cfg, torch.from_numpy(steps))
    assert got.dtype == torch.float32
    return got.numpy(), np.asarray(JA.schedule(jcfg, jnp.asarray(steps))), steps


@pytest.mark.parametrize("kw", [
    dict(peak_lr=1e-3, warmup_steps=10, decay_steps=100),
    dict(peak_lr=3e-3, warmup_steps=5, decay_steps=200),  # tests/test_training.py:20
])
def test_schedule_matches_jax(kw):
    got, want, _ = _schedules(**kw)
    np.testing.assert_allclose(got, want, rtol=1e-7)


@pytest.mark.parametrize("kw", [dict(), dict(warmup_steps=10, peak_lr=1e-3)])
def test_schedule_over_a_long_decay_is_as_close_to_float64_as_jaxs(kw):
    """Over 10,000 decay steps XLA's float32 cos is an ulp from the rounded
    float64 cos at ~1 % of steps, and 1 + cos near -1 amplifies that to a
    few ulps of lr (up to 2.8e-7 relative): rtol 1e-7 is below float32's
    resolution there.  Both schedules stay as close to the same formula in
    float64."""
    got, want, steps = _schedules(**kw)
    ulps = np.abs(got.view(np.int32) - want.view(np.int32))
    assert ulps.max() <= 4 and (ulps > 0).mean() < 0.01
    cfg = TA.OptConfig(**kw)
    s = steps.astype(np.float64)
    t = np.clip((s - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    exact = np.where(s < cfg.warmup_steps, cfg.peak_lr * s / max(cfg.warmup_steps, 1),
                     cfg.peak_lr * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5
                                    * (1 + np.cos(np.pi * t))))
    err = lambda v: np.max(np.abs(v - exact)[1:] / exact[1:])  # noqa: E731
    assert err(got) <= err(want)


@pytest.mark.parametrize("clip_norm", [1.0, 100.0])  # clipped, and not
def test_apply_updates_matches_jax(clip_norm):
    cfg = TA.OptConfig(warmup_steps=2, clip_norm=clip_norm)
    jcfg = JA.OptConfig(warmup_steps=2, clip_norm=clip_norm)
    params = _random_tree(1)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = JA.init_opt_state(jp)
    tp = T.map(torch.from_numpy, params)
    tstate = TA.init_opt_state(tp)
    for k in range(3):  # bias corrections and lr move with the step
        grads = _random_tree(10 + k)
        jp, jstate, jstats = JA.apply_updates(jp, jax.tree.map(jnp.asarray, grads), jstate, jcfg)
        tp, tstate, tstats = TA.apply_updates(tp, T.map(torch.from_numpy, grads), tstate, cfg)
        assert int(tstate["step"]) == int(jstate["step"]) == k + 1
        assert tstate["step"].dtype == torch.int32
        for name in ("grad_norm", "lr"):
            assert tstats[name].dtype == torch.float32
            np.testing.assert_allclose(float(tstats[name]), float(jstats[name]),
                                       rtol=1e-6, atol=1e-7)
        for got, want in ((tp, jp), (tstate["m"], jstate["m"]), (tstate["v"], jstate["v"])):
            for g, w in zip(T.leaves(got), jax.tree.leaves(want)):
                np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


def test_apply_updates_writes_the_state_in_place():
    params = T.map(torch.from_numpy, _random_tree(1))
    state = TA.init_opt_state(params)
    ptrs = [t.data_ptr() for t in T.leaves(params) + T.leaves(state["m"])]
    new_p, new_state, _ = TA.apply_updates(params, T.map(torch.from_numpy, _random_tree(2)),
                                           state, TA.OptConfig())
    assert [t.data_ptr() for t in T.leaves(new_p) + T.leaves(new_state["m"])] == ptrs


def test_global_norm_sums_leaf_by_leaf_in_jax_order():
    tree = _random_tree(4)
    got = TA.global_norm(T.map(torch.from_numpy, tree))
    want = JA.global_norm(jax.tree.map(jnp.asarray, tree))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert [tuple(t.shape) for t in T.leaves(tree)] == \
        [t.shape for t in jax.tree.leaves(tree)]


# ------------------------------------------------------------ loss
def _loss_inputs(jcfg, seed=0, unlabelled=True):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    if unlabelled:
        labels[0, 3] = labels[1, 17] = -1  # masked out of the loss
    return toks, labels


def _jax_loss_and_grads(jcfg, jp, toks, labels, ce_chunk):
    fn = lambda p: JM.loss_and_metrics(  # noqa: E731
        jcfg, p, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}, JM.ShardCtx(),
        ce_chunk)
    (loss, metrics), grads = jax.value_and_grad(fn, has_aux=True)(jp)
    return loss, metrics, grads


def _port_loss_and_grads(tcfg, tp, toks, labels, ce_chunk, remat):
    live = [t.detach().requires_grad_(True) for t in T.leaves(tp)]
    loss, metrics = TM.loss_and_metrics(
        tcfg, T.unflatten(tp, live),
        {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)},
        TM.ShardCtx(remat=remat), ce_chunk)
    return loss.detach(), metrics, torch.autograd.grad(loss, live)


@pytest.mark.parametrize("ce_chunk", [8, 7])  # 8 divides S = 24; 7 falls back to one chunk
def test_loss_and_grads_match_jax_float32(ce_chunk):
    jcfg, tcfg = _f32_cfgs()
    jp = j_init_params(jcfg, jax.random.key(1))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks, labels = _loss_inputs(jcfg)
    jl, jm, jg = _jax_loss_and_grads(jcfg, jp, toks, labels, ce_chunk)
    outs = {}
    for remat in ("none", "block"):
        tl, tm, tg = _port_loss_and_grads(tcfg, tp, toks, labels, ce_chunk, remat)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
        assert float(tm["tokens"]) == float(jm["tokens"]) == B * S - 2
        np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), atol=1e-7)
        assert len(tg) == len(jax.tree.leaves(jg))
        for name, g, w in zip(convert.flat_names(tp), tg, jax.tree.leaves(jg)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-6,
                                       err_msg=name)
        outs[remat] = (tl, tg)
    # remat recomputes the same ops: equal on the CPU
    assert torch.equal(outs["none"][0], outs["block"][0])
    assert all(torch.equal(a, b) for a, b in zip(outs["none"][1], outs["block"][1]))


def test_loss_remat_nests_blocks_of_a_multi_layer_period():
    """gemma2-2b's smoke period holds two layers (local, global): remat
    'block' checkpoints each of them inside the period, and the loss and
    gradients stay those of remat 'none'."""
    jcfg, tcfg = _f32_cfgs("gemma2-2b")
    assert tcfg.period > 1
    tp = convert.params_from_jax(
        jax.tree.map(np.asarray, j_init_params(jcfg, jax.random.key(2))), tcfg, device="cpu")
    toks, labels = _loss_inputs(jcfg, seed=1)
    got = {r: _port_loss_and_grads(tcfg, tp, toks, labels, 8, r) for r in ("none", "block")}
    assert torch.equal(got["none"][0], got["block"][0])
    assert all(torch.equal(a, b) for a, b in zip(got["none"][2], got["block"][2]))
    assert len(got["none"][2]) == len(T.leaves(tp))


def test_loss_runs_over_the_padded_vocab_as_jax():
    """The log-softmax runs over vocab_padded (JAX does not crop there):
    the padding columns sit at -1e30 and take no probability."""
    jcfg, tcfg = (dataclasses.replace(c, vocab=500) for c in _f32_cfgs())
    assert tcfg.vocab_padded == jcfg.vocab_padded == 512
    jp = j_init_params(jcfg, jax.random.key(3))
    tp = convert.params_from_jax(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    toks, labels = _loss_inputs(jcfg, seed=3)
    jl, _, _ = _jax_loss_and_grads(jcfg, jp, toks, labels, 8)
    tl, _, _ = _port_loss_and_grads(tcfg, tp, toks, labels, 8, "none")
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    logits = TM.unembed(tcfg, tp, torch.randn(1, 4, tcfg.d_model))
    assert bool((logits[..., 500:] == -1e30).all())


# ------------------------------------------------------------ train step
_BF16_STEP_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import numpy as np, jax
sys.path.insert(0, sys.argv[2])
import test_torch_train as T
state, batch, step_fn = T._jax_bf16_step_inputs()
state, metrics = jax.jit(step_fn)(state, batch)
np.savez(sys.argv[1], loss=np.asarray(metrics["loss"]),
         **{f"p{i}": np.asarray(l) for i, l in enumerate(jax.tree.leaves(state["params"]))})
print("BF16_STEP_OK")
"""

_STEP_OPTS = dict(ce_chunk=16, opt_kw=dict(peak_lr=1e-3, warmup_steps=1, weight_decay=0.0))


def _jax_bf16_step_inputs():
    cfg = jconfigs.smoke("gemma-2b")
    opts = JS.StepOptions(ce_chunk=_STEP_OPTS["ce_chunk"],
                          opt=JA.OptConfig(**_STEP_OPTS["opt_kw"]))
    step_fn = JS.build_train_step(cfg, JS.make_shard_ctx(cfg, None, 4, opts), opts)
    return JS.make_train_state(cfg, 0), JD.synthetic_batch(cfg, 4, 32, seed=1), step_fn


def test_bf16_train_step_matches_jax(tmp_path):
    path = tmp_path / "step.npz"
    r = subprocess.run(
        [sys.executable, "-c", _BF16_STEP_SCRIPT, str(path), str(REPO / "tests")],
        capture_output=True, text=True, timeout=150,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"},
    )
    assert "BF16_STEP_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    want = np.load(path)
    jstate = JS.make_train_state(jconfigs.smoke("gemma-2b"), 0)
    tcfg = tconfigs.smoke("gemma-2b")
    state = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg, device="cpu")
    opts = TS.StepOptions(ce_chunk=_STEP_OPTS["ce_chunk"],
                          opt=TA.OptConfig(**_STEP_OPTS["opt_kw"]))
    step_fn = TS.build_train_step(tcfg, TS.make_shard_ctx(tcfg, None, 4, opts), opts)
    state, metrics = step_fn(state, TD.synthetic_batch(tcfg, 4, 32, seed=1, device="cpu"))
    np.testing.assert_allclose(float(metrics["loss"]), float(want["loss"]), rtol=1e-2)
    assert int(state["step"]) == 1
    for i, (name, got) in enumerate(T.paths(state["params"])):
        np.testing.assert_allclose(got.numpy(), want[f"p{i}"], rtol=1e-2, atol=2e-3,
                                   err_msg=name)


def _fixed_batch_steps(steps=40, lr=3e-3):
    """Twin of tests/test_training.py:18 on the port."""
    cfg = tconfigs.smoke("gemma-2b")
    opts = TS.StepOptions(
        ce_chunk=512,
        opt=TA.OptConfig(peak_lr=lr, warmup_steps=5, decay_steps=200, weight_decay=0.0),
    )
    step_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, None, 4, opts), opts)
    state = TS.make_train_state(cfg, 0, device="cpu")
    batch = TD.synthetic_batch(cfg, 4, 32, seed=0, device="cpu")
    losses = []
    for _ in range(steps):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    return losses


def test_overfits_fixed_batch():
    """Twin of tests/test_training.py:35."""
    losses = _fixed_batch_steps()
    assert losses[0] > 5.5  # ~ln(512)
    assert losses[-1] < losses[0] * 0.5, losses[::8]


def test_microbatch_equivalence():
    """Twin of tests/test_training.py:42: grad accumulation (microbatch=2)
    ≈ single-shot on the same batch, at its tolerance."""
    cfg = tconfigs.smoke("gemma-2b")
    batch = TD.synthetic_batch(cfg, 4, 32, seed=1, device="cpu")
    outs, metrics = {}, {}
    for mb in (1, 2):
        opts = TS.StepOptions(ce_chunk=512, microbatch=mb,
                              opt=TA.OptConfig(peak_lr=1e-3, warmup_steps=1, weight_decay=0.0))
        step_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, None, 4, opts), opts)
        state, metrics[mb] = step_fn(TS.make_train_state(cfg, 0, device="cpu"), batch)
        outs[mb] = state["params"]["embed"]
    np.testing.assert_allclose(outs[1].float().numpy(), outs[2].float().numpy(),
                               rtol=1e-2, atol=2e-3)
    # JAX's quirk, kept: accumulated steps report accuracy and tokens as 0
    assert float(metrics[2]["accuracy"]) == float(metrics[2]["tokens"]) == 0.0
    assert float(metrics[1]["tokens"]) == 4 * 32


def test_microbatch_split_matches_jax():
    """(nm, B/nm) microbatches, pos3 on its batch axis 1, as JAX splits them."""
    x = np.arange(4 * 6).reshape(4, 6).astype(np.int32)
    pos3 = np.arange(3 * 4 * 6).reshape(3, 4, 6).astype(np.int32)
    got = TS._split("tokens", torch.from_numpy(x), 2).numpy()
    np.testing.assert_array_equal(got, x.reshape(2, 2, 6))
    got = TS._split("pos3", torch.from_numpy(pos3), 2).numpy()
    np.testing.assert_array_equal(got, pos3.reshape(3, 2, 2, 6).swapaxes(0, 1))


def test_master_in_opt_keeps_bf16_params_beside_a_float32_master():
    cfg = tconfigs.smoke("gemma-2b")
    opts = TS.StepOptions(ce_chunk=512, master_in_opt=True)
    step_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, None, 4, opts), opts)
    state = TS.make_train_state(cfg, 0, master_in_opt=True, device="cpu")
    state, m = step_fn(state, TD.synthetic_batch(cfg, 4, 32, seed=1, device="cpu"))
    for p, q in zip(T.leaves(state["params"]), T.leaves(state["master"])):
        assert p.dtype == torch.bfloat16 and q.dtype == torch.float32
        assert torch.equal(p, q.to(torch.bfloat16))
    assert torch.isfinite(m["loss"]) and int(state["step"]) == 1


def test_donate_false_leaves_the_input_state_untouched():
    cfg = tconfigs.smoke("gemma-2b")
    opts = TS.StepOptions(ce_chunk=512, donate=False)
    step_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, None, 4, opts), opts)
    state = TS.make_train_state(cfg, 0, device="cpu")
    before = T.map(torch.clone, state)
    new, _ = step_fn(state, TD.synthetic_batch(cfg, 4, 32, seed=1, device="cpu"))
    assert all(torch.equal(a, b) for a, b in zip(T.leaves(state), T.leaves(before)))
    assert not torch.equal(new["params"]["embed"], state["params"]["embed"])


@pytest.mark.parametrize("kw", [dict(seq_shard=True), dict(seq_shard=True, probe=True)])
def test_mesh_and_probe_options_raise_naming_their_item(kw, tmp_path):
    """``seq_shard`` is read on a mesh only, as JAX's make_shard_ctx reads it
    (repro/launch/steps.py:57-73); on a one-rank gloo mesh the context is
    JAX's: its batch axes, the model axis, a shardable batch, and
    ``seq_shard`` and ``probe`` as asked."""
    import torch.distributed as dist

    from repro_torch import compat

    cfg = tconfigs.smoke("gemma-2b")
    opts = TS.StepOptions(**kw)
    assert TS.make_shard_ctx(cfg, None, 4, opts) == TM.ShardCtx(remat=opts.remat,
                                                                unroll=opts.probe)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1)
    try:
        mesh = compat.make_mesh((1, 1), ("data", "model"), device="cpu")
        ctx = TS.make_shard_ctx(cfg, mesh, 4, opts)
        assert ctx == TM.ShardCtx(mesh=mesh, batch_axes=("data",), model_axis="model",
                                  batch_shardable=True, seq_shard=True, remat=opts.remat,
                                  unroll=opts.probe)
        assert ctx.tp == ctx.dp == 1 and ctx.model_rank == 0
        assert ctx.hidden_spec() == (("data",), "model", None)
        assert ctx.for_pass(4, 16).seq_shard and not ctx.for_pass(4, 8).seq_shard
    finally:
        dist.destroy_process_group()


def test_probe_option_gives_the_probe_context():
    """JAX's probe (repro/launch/steps.py:67): unrolled, single-block
    attention, whole-sequence Mamba chunks; and no kernel in prefill."""
    cfg = tconfigs.smoke("gemma-2b")
    ctx = TS.make_shard_ctx(cfg, None, 4, TS.StepOptions(probe=True, remat="none"))
    assert ctx == TM.ShardCtx(remat="none", unroll=True)
    assert not ctx.kernels and ctx.direct_threshold() == 1 << 30 and ctx.mamba_chunk(4096) == 4096
    plain = TS.make_shard_ctx(cfg, None, 4, TS.StepOptions())
    assert plain.kernels and plain.direct_threshold() == 1024 and plain.mamba_chunk(4096) == 128


@pytest.mark.parametrize("arch", ["gemma-2b", "falcon-mamba-7b", "jamba-v0.1-52b"])
def test_auto_microbatch_matches_jax(arch):
    for gb, seq, dp in ((256, 4096, 1), (8, 64, 1), (256, 4096, 16)):
        assert TS.auto_microbatch(tconfigs.get_config(arch), gb, seq, dp) == \
            JS.auto_microbatch(jconfigs.get_config(arch), gb, seq, dp)


# ------------------------------------------------------------ data
@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-vl-2b", "hubert-xlarge"])
def test_batch_at_is_byte_identical_to_jax(arch):
    for host, n_hosts, step in ((0, 1, 0), (1, 2, 7), (3, 4, 123)):
        jstream = JD.SyntheticStream(jconfigs.smoke(arch), JD.DataShard(host, n_hosts, 8), 40,
                                     seed=5)
        tstream = TD.SyntheticStream(tconfigs.smoke(arch), TD.DataShard(host, n_hosts, 8), 40,
                                     seed=5)
        want, got = jstream.batch_at(step), tstream.batch_at(step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("arch", ["gemma-2b", "qwen2-vl-2b", "hubert-xlarge"])
def test_synthetic_batch_and_spec_match_jax(arch):
    jcfg, tcfg = jconfigs.smoke(arch), tconfigs.smoke(arch)
    want = JD.synthetic_batch(jcfg, 2, 16, seed=3)
    got = TD.synthetic_batch(tcfg, 2, 16, seed=3, device="cpu")
    spec, jspec = TD.batch_spec(tcfg, 2, 16), JD.batch_spec(jcfg, 2, 16)
    assert list(got) == list(want) == list(spec) == list(jspec)
    for k in want:
        assert got[k].device.type == "cpu" and spec[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(spec[k].shape) == want[k].shape == jspec[k].shape
        assert str(got[k].dtype).split(".")[1] == str(want[k].dtype) == str(jspec[k].dtype)
        assert got[k].dtype == spec[k].dtype
        np.testing.assert_array_equal(got[k].float().numpy(), np.asarray(want[k], np.float32))


def test_stream_batches_feed_the_step_as_jax_feeds_it():
    """train.py's batch: batch_at's numpy, same dtypes on the device."""
    cfg = tconfigs.smoke("gemma-2b")
    raw = TD.SyntheticStream(cfg, TD.DataShard(0, 1, 4), 16).batch_at(2)
    got = TD.to_device(raw, "cpu")
    assert {k: v.dtype for k, v in got.items()} == {"tokens": torch.int32, "labels": torch.int32}
    assert list(got) == list(raw) and all(np.array_equal(got[k].numpy(), raw[k]) for k in raw)


# ------------------------------------------- the driver over shard workers
def _chip_smoke():
    """chip_smoke.py as a module (it imports no CUDA code at import time)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_socket_supervised_wal_training_matches_local(tmp_path):
    """The smoke gemma-2b trains with the monitor's PS and provenance DB in
    two supervised shard worker processes and a PS write-ahead log
    (chip_smoke.py's path F at the smoke size): the summary shows socket
    transports, the losses equal a local run's, the WAL and the sharded
    provenance files are written, and the frames the run's monitor ingested
    (archived through chip_smoke.py's hook) replay offline with local
    transports to the live events, anomalies and PS table."""
    from repro_torch.core import offline
    from repro_torch.launch.train import train
    from repro_torch.trace.stream import FrameStore

    cs = _chip_smoke()
    kw = dict(arch="gemma-2b", steps=8, global_batch=4, seq=32, log_every=100, device="cpu",
              inject_straggler_at=5, provdb_shards=2)
    local = train(**kw)
    store, seen = FrameStore(str(tmp_path / "frames")), {}
    with cs.archived_monitor(store, seen):
        got = train(ps_transport="socket", provdb_transport="socket", shard_endpoints="spawn:2",
                    supervise=True, ps_wal=str(tmp_path / "wal"),
                    monitor_dir=str(tmp_path / "mon"), **kw)
    mon = got["monitor"]
    assert (mon["ps_transport"], mon["provdb_transport"]) == ("socket", "socket")
    assert mon["ps_shards"] == mon["provdb_shards"] == 2 and mon["frames"] == 8
    assert mon["events"] == 8 * 6 + 2  # 3 spans a step, and the injected delay's
    np.testing.assert_allclose([h["loss"] for h in got["history"]],
                               [h["loss"] for h in local["history"]], rtol=1e-5)
    assert sorted(os.listdir(tmp_path / "wal")) == ["ps_shard0.wal", "ps_shard1.wal"]
    assert {"provenance.shard0.jsonl", "provenance.shard1.jsonl"} <= set(
        os.listdir(tmp_path / "mon"))
    assert store.ranks() == [0] and store.steps(0) == list(range(8))
    replayed = offline.replay(store, registry=seen["registry"],
                              num_funcs=cs.TRAIN_MONITOR["num_funcs"], ps_shards=2,
                              provdb_shards=2, **cs.TRAIN_MONITOR["kw"])
    summary = replayed.summary()
    assert (summary["events"], summary["anomalies"]) == (mon["events"], mon["anomalies"])
    np.testing.assert_allclose(replayed.ps.snapshot().table[:, :3], seen["snapshot"][:, :3],
                               rtol=1e-9)
    replayed.close()
