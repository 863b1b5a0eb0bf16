"""The train step on a mesh: the port in four gloo processes against the
JAX package.

JAX runs once per session in a child process (four host devices) and the
port in four spawned gloo processes (rendezvous ``file://``).  Inputs are
numpy from seeds; the smoke configs compute in float32 with
``moe_capacity_factor=16`` (no token is dropped, so the capacity, which
JAX takes from the tokens routed together, changes nothing between one
device and a mesh).  The batch masks tokens unevenly (rows 1 and 3), so
the global mask count and JAX's microbatch split matter.

Each case places JAX's ``make_train_state`` tree by ``param_shardings``
(``launch.sharding.place``) and runs ``build_train_step`` on a mesh with
``make_shard_ctx``: gemma-2b on (2, 2) and (1, 4), ``seq_shard`` off and
on; granite-moe-1b-a400m (expert parallelism), falcon-mamba-7b (the
sequence-parallel mixer), minicpm3-4b (MLA) and jamba-v0.1-52b (all
three) on (2, 2) with ``seq_shard``; gemma-2b with ``microbatch=2``, with
``master_in_opt`` and with ``remat="none"`` on (2, 2) with ``seq_shard``.
They are held against JAX's single-device ``build_train_step``
(tests/test_elastic.py shows meshed and single-device JAX agree), three
steps each:

  * the port's own run of three steps: loss and grad norm at rtol 1e-5;
  * at each step, from JAX's state of that step: each rank's gradient
    blocks (``build_grad_step``) at rtol 1e-5, atol 1e-7, and the blocks
    of the state after the step by chip_smoke.py's K-c criterion (a share
    of 1e-4 of the elements may miss rtol 1e-4 / atol 1e-6: Adam turns a
    float32 rounding of a near-zero gradient into a step of ~lr; none
    moves further than 2·lr·(1 + the leaf's largest magnitude));
  * remat "none" gives remat "block"'s gradients bitwise.

Two cases take another gradient atol (``GRAD_ATOL``), each from sums in
another order than one device's: granite's expert parallelism adds a
token's expert outputs rank by rank (1.0e-7 seen), and jamba's port on
one device is already up to 1.6e-6 from JAX over its 16 layers of
float32 Mamba scans (1.8e-6 seen on the mesh); their atol is about twice
what was seen.  ``master_in_opt`` keeps bf16 params, whose gradients are
bf16 in both packages: JAX rounds each contribution to bf16 where one
device computes it, the port sums the ranks' float32 contributions and
rounds once.  That case holds its gradient blocks within one bf16 ulp of
the leaf's largest magnitude (2^-7 of it), its grad norms at rtol 1e-4,
and the state after a step by K-c with a share of 2e-2 (about 1 % of
m's and v's elements carry a gradient one ulp off).

The data-parallel step (``make_dp_train_step``) on the (2, 2) mesh, int8
compression off and on, against JAX's on the same mesh, held as
tests/test_torch_compression.py holds the 1-D step: float32 losses of
three steps at rtol 1e-5, each rank's error feedback after one compressed
step, and one all-reduce per parameter leaf and one for the loss.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.launch import sharding as TSH  # noqa: E402
from repro_torch.models.common import param_shapes  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_WORLD = 4
_TIMEOUT = 420
NAMES = ("data", "model")
MESHES = {"22": (2, 2), "14": (1, 4)}
STEPS = 3
LOSS_RTOL = 1e-5
GRAD = dict(rtol=1e-5, atol=1e-7)
# where a case's float32 sums run in another order than one device's, its atol
GRAD_ATOL = {"granite_22_seq": 2e-7, "jamba_22_seq": 4e-6}
KC = dict(rtol=1e-4, atol=1e-6, off_share=1e-4, lr_steps=2)  # chip_smoke.py TRAIN_PARITY (K-c)
BF16_CASE = "gemma_master_22_seq"  # bf16 params: bf16 gradients (see check_gradient_blocks)
BF16 = dict(grad_norm_rtol=1e-4, ulp=2.0 ** -7, off_share=2e-2)

# Shared by both sides: the runs JAX makes, the cases the port runs against
# them, and the inputs.
_COMMON = r"""
import dataclasses
import numpy as np

B, S, STEPS, CE_CHUNK = 4, 64, 3, 32
# JAX run -> (arch, microbatch, master_in_opt)
RUNS = {"gemma": ("gemma-2b", 1, False), "granite": ("granite-moe-1b-a400m", 1, False),
        "falcon": ("falcon-mamba-7b", 1, False), "minicpm": ("minicpm3-4b", 1, False),
        "jamba": ("jamba-v0.1-52b", 1, False), "gemma_mb2": ("gemma-2b", 2, False),
        "gemma_master": ("gemma-2b", 1, True)}
# case -> (JAX run, mesh, seq_shard, remat)
CASES = {"gemma_22": ("gemma", "22", False, "block"), "gemma_22_seq": ("gemma", "22", True, "block"),
         "gemma_14": ("gemma", "14", False, "block"), "gemma_14_seq": ("gemma", "14", True, "block"),
         "granite_22_seq": ("granite", "22", True, "block"),
         "falcon_22_seq": ("falcon", "22", True, "block"),
         "minicpm_22_seq": ("minicpm", "22", True, "block"),
         "jamba_22_seq": ("jamba", "22", True, "block"),
         "gemma_mb2_22_seq": ("gemma_mb2", "22", True, "block"),
         "gemma_master_22_seq": ("gemma_master", "22", True, "block"),
         "gemma_22_seq_remat_none": ("gemma", "22", True, "none")}
DP_B, DP_S, DP_STEPS = 8, 32, 3
# each test file runs one group (its own JAX child and gloo processes)
GROUPS = {"gemma": ("gemma", "gemma_mb2", "gemma_master"),
          "families": ("granite", "falcon", "minicpm", "jamba")}


def cfg_of(configs, f32, arch):
    return dataclasses.replace(configs.smoke(arch), compute_dtype=f32, moe_capacity_factor=16.0)


def opt_kw():
    return dict(peak_lr=1e-3, warmup_steps=1)


def batch_of(cfg):
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, (B, S + 1))
    labels = toks[:, 1:].copy()
    labels[1, :20] = -1
    labels[3, 50:] = -1
    return toks[:, :-1].astype(np.int32), labels.astype(np.int32)
"""

_JAX_SCRIPT = _COMMON + r"""
import os, sys
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_allow_excess_precision=false")
import jax, jax.numpy as jnp
from repro import configs
from repro.compat import make_mesh
from repro.data.pipeline import synthetic_batch
from repro.launch.steps import (StepOptions, build_train_step, make_dp_train_step,
                                make_shard_ctx, make_train_state)
from repro.models import model as M
from repro.optim.adamw import OptConfig

group, out = sys.argv[2], {}


def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32) if x.dtype == jnp.bfloat16 else x)


for run in GROUPS[group]:
    arch, nm, master = RUNS[run]
    cfg = cfg_of(configs, jnp.float32, arch)
    opts = StepOptions(ce_chunk=CE_CHUNK, microbatch=nm, master_in_opt=master,
                       opt=OptConfig(**opt_kw()))
    ctx = make_shard_ctx(cfg, None, B, opts)
    step_fn = jax.jit(build_train_step(cfg, ctx, opts))
    toks, labels = batch_of(cfg)
    out[f"tok_{run}"], out[f"lab_{run}"] = toks, labels
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    vg = jax.jit(jax.value_and_grad(
        lambda p, b: M.loss_and_metrics(cfg, p, b, ctx, CE_CHUNK), has_aux=True))

    def grads_of(params):  # build_train_step's accumulation, microbatch by microbatch
        if nm == 1:
            return vg(params, batch)[1]
        total = None
        for i in range(nm):
            part = {k: v.reshape((nm, B // nm) + v.shape[1:])[i] for k, v in batch.items()}
            g = vg(params, part)[1]
            total = g if total is None else jax.tree.map(jnp.add, total, g)
        return jax.tree.map(lambda g: g / nm, total)

    state = make_train_state(cfg, 0, master_in_opt=master)
    for s in range(STEPS + 1):
        for i, leaf in enumerate(jax.tree.leaves(state)):
            out[f"st_{run}_{s}_{i}"] = f32(leaf)
        if s == STEPS:
            break
        for i, g in enumerate(jax.tree.leaves(grads_of(state["params"]))):
            out[f"g_{run}_{s}_{i}"] = f32(g)
        state, m = step_fn(state, batch)
        out[f"loss_{run}_{s}"], out[f"gn_{run}_{s}"] = np.asarray(m["loss"]), np.asarray(m["grad_norm"])

# the data-parallel step on the (2, 2) mesh
mesh = make_mesh((2, 2), ("data", "model"))
cfg = cfg_of(configs, jnp.float32, "gemma-2b")
batch = synthetic_batch(cfg, DP_B, DP_S, seed=0)
out["dp_tokens"], out["dp_labels"] = np.asarray(batch["tokens"]), np.asarray(batch["labels"])
for compress in ((False, True) if group == "gemma" else ()):
    step_fn, init_err = make_dp_train_step(
        cfg, mesh, OptConfig(peak_lr=3e-3, warmup_steps=5, weight_decay=0.0), compress=compress)
    state = make_train_state(cfg, 0)
    err = init_err(state["params"])
    losses = []
    for s in range(DP_STEPS):
        state, err, m = step_fn(state, err, batch)
        losses.append(float(m["loss"]))
        if s == 0:
            for i, leaf in enumerate(jax.tree.leaves(err)):
                out[f"dp_err{int(compress)}_{i}"] = np.asarray(leaf)
    out[f"dp_losses{int(compress)}"] = np.asarray(losses)
np.savez(sys.argv[1], **out)
print("JAX_MESH_TRAIN_OK")
"""

_TORCH_WORKER = _COMMON + r"""
import sys
import torch, torch.distributed as dist
from repro_torch import compat, configs, tree as T
from repro_torch.launch import roofline as R, sharding as SH, steps as TS
from repro_torch.optim.adamw import OptConfig

rank, init, jax_out, outdir, group = int(sys.argv[1]), *sys.argv[2:6]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=4)
meshes = {m: compat.make_mesh(shape, ("data", "model"), device="cpu")
          for m, shape in (("22", (2, 2)), ("14", (1, 4)))}
jx = np.load(jax_out)
out = {}


def local(t):
    t = t.to_local() if hasattr(t, "to_local") else t
    return t.to(torch.float32 if t.is_floating_point() else t.dtype).numpy().copy()


def jax_state(run, cfg, master, s, template):
    leaves = [torch.from_numpy(jx[f"st_{run}_{s}_{i}"]).to(t.dtype)
              for i, t in enumerate(T.leaves(template))]
    return T.unflatten(template, leaves)


for case, (run, m, seq, remat) in CASES.items():
    if run not in GROUPS[group]:
        continue
    arch, nm, master = RUNS[run]
    cfg = cfg_of(configs, torch.float32, arch)
    opts = TS.StepOptions(ce_chunk=CE_CHUNK, microbatch=nm, master_in_opt=master, remat=remat,
                          seq_shard=seq, opt=OptConfig(**opt_kw()))
    mesh = meshes[m]
    ctx = TS.make_shard_ctx(cfg, mesh, B, opts)
    step_fn = TS.build_train_step(cfg, ctx, opts)
    grad_fn = TS.build_grad_step(cfg, ctx, opts)
    batch = {"tokens": torch.from_numpy(jx[f"tok_{run}"]),
             "labels": torch.from_numpy(jx[f"lab_{run}"])}
    template = TS.make_train_state(cfg, 0, master_in_opt=master, device="cpu")
    shardings = TS.train_state_shardings(cfg, template, mesh, opts)
    place = lambda s: SH.place(jax_state(run, cfg, master, s, template), shardings)  # noqa: E731
    # the port's own run
    state, losses, gnorms = place(0), [], []
    for s in range(STEPS):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        gnorms.append(float(metrics["grad_norm"]))
    out[f"loss_{case}"], out[f"gn_{case}"] = np.asarray(losses), np.asarray(gnorms)
    # each step from JAX's state of that step
    for s in range(STEPS):
        state = place(s)
        _, grads = grad_fn(state["params"], batch)
        for i, g in enumerate(T.leaves(grads)):
            out[f"g_{case}_{s}_{i}"] = local(g)
        state, _ = step_fn(state, batch)
        for i, t in enumerate(T.leaves(state)):
            out[f"st_{case}_{s + 1}_{i}"] = local(t)

# the data-parallel step on (2, 2): rank r's rows, r row-major over the mesh
cfg = cfg_of(configs, torch.float32, "gemma-2b")
rows = slice(rank * DP_B // 4, (rank + 1) * DP_B // 4)
batch = {k: torch.from_numpy(np.ascontiguousarray(jx[f"dp_{k}"][rows])) for k in ("tokens", "labels")}
for compress in ((False, True) if group == "gemma" else ()):
    step_fn, init_err = TS.make_dp_train_step(
        cfg, meshes["22"], OptConfig(peak_lr=3e-3, warmup_steps=5, weight_decay=0.0),
        compress=compress)
    template = TS.make_train_state(cfg, 0, device="cpu")
    state = jax_state("gemma", cfg, False, 0, template)
    err = init_err(state["params"])
    losses = []
    for s in range(DP_STEPS):
        if s == 0:
            rec = compat.CollectiveRecorder()
            with rec:
                state, err, metrics = step_fn(state, err, batch)
            ar = R.collective_bytes(rec.collectives)["all-reduce"]
            out[f"dp_coll{int(compress)}"] = np.asarray([ar["count"], ar["result_bytes"]])
            for i, e in enumerate(T.leaves(err)):
                out[f"dp_err{int(compress)}_{i}"] = e.numpy().copy()
        else:
            state, err, metrics = step_fn(state, err, batch)
        losses.append(float(metrics["loss"]))
    out[f"dp_losses{int(compress)}"] = np.asarray(losses)
out["dp_param_bytes"] = np.asarray(sum(p.numel() * 4 for p in T.leaves(state["params"])))
out["dp_n_leaves"] = np.asarray(len(T.leaves(state["params"])))
np.savez(f"{outdir}/rank{rank}.npz", **out)
dist.destroy_process_group()
print("TORCH_MESH_TRAIN_OK", rank)
"""

_SHARED: dict = {}
exec(_COMMON, _SHARED)  # noqa: S102 - the runs and cases, as both scripts hold them
RUNS, CASES, GROUPS = _SHARED["RUNS"], _SHARED["CASES"], _SHARED["GROUPS"]


def cases_of(group):
    return [case for case, (run, *_) in CASES.items() if run in GROUPS[group]]


def run_group(tmp_path_factory, group):
    """JAX's runs of ``group`` in a child process, then the port's cases
    of them in four gloo processes -> (JAX's arrays, each rank's)."""
    d = tmp_path_factory.mktemp(f"mesh_train_{group}")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    jax_run = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "jax.npz"), group],
                             capture_output=True, text=True, timeout=_TIMEOUT, env=env)
    assert "JAX_MESH_TRAIN_OK" in jax_run.stdout, jax_run.stdout[-2000:] + jax_run.stderr[-3000:]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TORCH_WORKER, str(r), str(d / "pg"), str(d / "jax.npz"), str(d),
         group], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(_WORLD)]
    try:
        logs = [p.communicate(timeout=_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"TORCH_MESH_TRAIN_OK {r}" in text, text[-3000:]
    return np.load(d / "jax.npz"), [np.load(d / f"rank{r}.npz") for r in range(_WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_group(tmp_path_factory, "gemma")


class _Mesh:
    """What the sharding rules read of a mesh."""

    def __init__(self, shape):
        self.mesh_dim_names, self.shape = NAMES, shape


def _param_specs(case):
    """The spec of each parameter leaf, by the port's param_shardings
    (tests/test_torch_placements.py holds its blocks to JAX's)."""
    run, mesh, _, _ = CASES[case]
    cfg = tconfigs.smoke(RUNS[run][0])
    return [s.spec for s in T.leaves(TSH.param_shardings(cfg, param_shapes(cfg),
                                                          _Mesh(MESHES[mesh])))]


def _state_specs(case):
    """The spec of each leaf of the case's train state, in leaf order
    (m, master, params, step, v): the params' for each tree, step replicated."""
    specs = _param_specs(case)
    keys = ["m"] + (["master"] if RUNS[CASES[case][0]][2] else []) + ["params", "step", "v"]
    return [spec for k in keys for spec in ([()] if k == "step" else specs)]


def _block(arr, spec, mesh, rank):
    return convert.block_from_jax(arr, spec, MESHES[mesh], NAMES, rank)


def check_losses_and_grad_norms(runs, case):
    jx, ranks = runs
    run = CASES[case][0]
    for got in ranks:  # every rank holds the global metrics
        np.testing.assert_array_equal(got[f"loss_{case}"], ranks[0][f"loss_{case}"])
        np.testing.assert_array_equal(got[f"gn_{case}"], ranks[0][f"gn_{case}"])
    for s in range(STEPS):
        np.testing.assert_allclose(ranks[0][f"loss_{case}"][s], jx[f"loss_{run}_{s}"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(ranks[0][f"gn_{case}"][s], jx[f"gn_{run}_{s}"],
                                   rtol=BF16["grad_norm_rtol"] if case == BF16_CASE else LOSS_RTOL)


def check_gradient_blocks(runs, case):
    """Each rank's block of every gradient leaf, from JAX's state at each
    step: the block JAX's placement gives the rank's mesh coordinate."""
    jx, ranks = runs
    run, mesh, _, _ = CASES[case]
    tol = dict(GRAD, atol=GRAD_ATOL.get(case, GRAD["atol"]))
    for s in range(STEPS):
        for i, spec in enumerate(_param_specs(case)):
            full = jx[f"g_{run}_{s}_{i}"]
            if case == BF16_CASE:
                tol = dict(rtol=0, atol=BF16["ulp"] * float(np.abs(full).max()))
            for r, got in enumerate(ranks):
                np.testing.assert_allclose(got[f"g_{case}_{s}_{i}"], _block(full, spec, mesh, r),
                                           **tol, err_msg=f"step {s} leaf {i} rank {r}")


def check_updated_blocks(runs, case):
    """The state after each step, from JAX's state of that step, by the
    K-c criterion: each rank's blocks of params, m, v (and the master)."""
    jx, ranks = runs
    run, mesh, _, _ = CASES[case]
    specs = _state_specs(case)
    share = BF16["off_share"] if case == BF16_CASE else KC["off_share"]
    lr = _SHARED["opt_kw"]()["peak_lr"]
    for s in range(1, STEPS + 1):
        off, n_all = 0, 0
        for i, spec in enumerate(specs):
            bound = KC["lr_steps"] * lr * (1 + float(np.abs(jx[f"st_{run}_{s - 1}_{i}"]).max()))
            for r, got in enumerate(ranks):
                want = _block(jx[f"st_{run}_{s}_{i}"], spec, mesh, r)
                have = got[f"st_{case}_{s}_{i}"]
                assert have.shape == want.shape
                err = np.abs(have - want)
                assert err.max(initial=0.0) <= bound, (s, i, r, float(err.max()), bound)
                off += int((err > KC["atol"] + KC["rtol"] * np.abs(want)).sum())
                n_all += want.size
        assert off <= share * n_all, (s, off, n_all)


@pytest.mark.parametrize("case", cases_of("gemma"))
def test_meshed_losses_and_grad_norms_match_jax(runs, case):
    check_losses_and_grad_norms(runs, case)


@pytest.mark.parametrize("case", cases_of("gemma"))
def test_meshed_gradient_blocks_match_jax(runs, case):
    check_gradient_blocks(runs, case)


@pytest.mark.parametrize("case", cases_of("gemma"))
def test_meshed_updated_blocks_match_jax(runs, case):
    check_updated_blocks(runs, case)


def test_remat_none_gives_remat_blocks_gradients_bitwise(runs):
    _, ranks = runs
    for got in ranks:
        keys = [k for k in got.files if k.startswith("g_gemma_22_seq_remat_none_")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(got[k], got[k.replace("_remat_none", "")])


# --------------------------------------------------------- data parallel
@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
def test_dp_step_on_a_2d_mesh_matches_jax(runs, compress):
    jx, ranks = runs
    key = f"dp_losses{int(compress)}"
    for got in ranks:
        np.testing.assert_array_equal(got[key], ranks[0][key])
    np.testing.assert_allclose(ranks[0][key], jx[key], rtol=1e-5)


def test_dp_step_on_a_2d_mesh_error_feedback_per_rank_matches_jax(runs):
    """Rank r (row-major over the (2, 2) mesh) holds JAX's err[r], by
    tests/test_torch_compression.py's criterion; uncompressed it stays 0."""
    jx, ranks = runs
    n = int(ranks[0]["dp_n_leaves"])
    for r, got in enumerate(ranks):
        for i in range(n):
            want = jx[f"dp_err1_{i}"][r]
            diff = np.abs(got[f"dp_err1_{i}"] - want)
            top = np.abs(want).max()
            assert (diff <= 2.5e-3 * top).mean() > 0.999, (r, i, diff.max(), top)
            assert diff.max() <= 2.01 * top
            assert not got[f"dp_err0_{i}"].any()


@pytest.mark.parametrize("compress", [False, True], ids=["plain", "int8"])
def test_dp_step_on_a_2d_mesh_records_one_all_reduce_per_leaf(runs, compress):
    _, ranks = runs
    for got in ranks:
        count, result = got[f"dp_coll{int(compress)}"]
        assert count == int(got["dp_n_leaves"]) + 1
        assert result == int(got["dp_param_bytes"]) + 4


# ------------------------------------------------------------ collectives
def test_gather_backward_writes_a_contiguous_reduce_scatter_buffer(monkeypatch):
    """The all-gather's backward on NCCL reduce-scatters the stacked
    gradients into a new buffer, which the collective writes in memory
    order.  A gradient that reaches it with permuted strides (attention's
    backward hands K's so) must not lend the buffer those strides: on the
    H100 that scrambled K's and V's gradients on the sequence-parallel
    path (grad norm 25.41 against 24.08).  A two-rank group is faked here,
    its reduce-scatter writing in memory order as NCCL does."""
    import torch.distributed as dist

    from repro_torch.models import collectives as C

    world, rank = 2, 1
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: world)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: dist.Backend.NCCL)

    def all_gather(out, t, group=None):
        for i, o in enumerate(out):
            o.copy_(t + i)

    def reduce_scatter_tensor(out, stacked, group=None):  # memory order, as NCCL
        own = stacked.reshape(world, -1)[rank] * world
        out.as_strided((out.numel(),), (1,)).copy_(own)

    monkeypatch.setattr(dist, "all_gather", all_gather)
    monkeypatch.setattr(dist, "reduce_scatter_tensor", reduce_scatter_tensor)
    x = torch.randn(2, 3, 4, requires_grad=True)
    parts = C.all_gather(x, group=None)
    g = torch.randn(4, 3, 2).permute(2, 1, 0)  # (2, 3, 4) with permuted strides
    assert not g.is_contiguous()
    (grad,) = torch.autograd.grad(parts, [x], grad_outputs=[g, g])
    torch.testing.assert_close(grad, g * world, rtol=0, atol=0)
