"""Serving on a mesh with the caches and the parameters placed across ranks:
the port in four gloo processes against the JAX package on four host
devices.

JAX runs once in a child process (``XLA_FLAGS`` set before import), the
port in four spawned gloo processes (rendezvous ``file://``), each on the
meshes (2, 2) and (1, 4) over ("data", "model") and (2, 1, 2) over ("pod",
"data", "model").  Inputs are numpy from seeds; the smoke configs compute
in float32 with ``moe_capacity_factor=16`` (no token dropped), and the
port takes JAX's initial weights.

Tolerances, each stated where it is held:

  * cache placements: for every decoder smoke config (hubert-xlarge has
    no decode), a 32-token prefill into 48 slots at batch 4 on each mesh
    and at batch 1 (below dp) on the two meshes with dp 2: each rank's
    block of every cache leaf (``h`` and ``conv`` included) has the shape
    of the block ``NamedSharding`` gives the device at its coordinate
    under ``cache_shardings``, and its values at that index of JAX's
    cache, ``kpos`` bitwise and the rest at ``BODY`` (rtol 1e-5, atol
    1e-5: tests/test_torch_seq_parallel.py's bound);
  * the tensor-parallel Mamba decode: falcon-mamba-7b and jamba-v0.1-52b
    on (1, 4) and (2, 2), a prefill and 8 decode steps fed JAX's greedy
    tokens, against JAX's jitted ``decode_step`` on the same mesh with its
    cache placed by ``cache_shardings``: logits at ``SERVE`` (rtol 1e-4,
    atol 1e-4), each rank's ``h`` and ``conv`` at ``BODY`` for the 2
    layers of falcon-mamba-7b and at ``SERVE`` for jamba's 16 (its last
    layers' states carry 15 layers' and 8 steps' float32 rounding: 1 of
    768 elements of a conv state lands 1.1e-5 from JAX's), and a rank's
    ``h`` a quarter of the one-device state's bytes on (1, 4);
  * placed parameters: gemma-2b, granite-moe-1b-a400m, falcon-mamba-7b,
    minicpm3-4b, jamba-v0.1-52b and qwen2-vl-2b (with ``pos3`` and
    ``visual_embeds``) on (2, 2), with ``fsdp`` on and off (and
    falcon-mamba once with ``mamba_tp`` off): the prefill and 8 decode
    steps with weights placed by ``param_shardings`` equal the same meshed
    run with whole weights bitwise (a gather moves values exactly), and
    both hold JAX's one-device logits at ``SERVE``;
  * ``launch.sharding.placed_compute_params`` (the leaf-by-leaf build):
    every block bitwise that of the whole ``compute_params(init_params)``.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_WORLD = 4
_TIMEOUT = 420
BODY = dict(rtol=1e-5, atol=1e-5)
SERVE = dict(rtol=1e-4, atol=1e-4)

# Shared by both sides: the cases and the configs.
_COMMON = r"""
import dataclasses
import numpy as np

ARCHS = ("gemma-2b", "gemma2-2b", "h2o-danube3-4b", "falcon-mamba-7b", "jamba-v0.1-52b",
         "granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "minicpm3-4b", "qwen2-vl-2b")
MESHES = {"22": ((2, 2), ("data", "model")), "14": ((1, 4), ("data", "model")),
          "212": ((2, 1, 2), ("pod", "data", "model"))}
CACHE_CASES = [(m, 4) for m in MESHES] + [("22", 1), ("212", 1)]  # (mesh, batch)
TP_ARCHS = ("falcon-mamba-7b", "jamba-v0.1-52b")
TP_MESHES = ("14", "22")
PLACED_ARCHS = ("gemma-2b", "granite-moe-1b-a400m", "falcon-mamba-7b", "minicpm3-4b",
                "jamba-v0.1-52b", "qwen2-vl-2b")


def placed_options(arch):
    opts = [(True, True), (False, True)]  # (fsdp, mamba_tp)
    return opts + [(True, False)] if arch == "falcon-mamba-7b" else opts


B, S, MAX_SEQ, STEPS = 4, 32, 48, 8


def cfg_of(configs, f32, arch):
    return dataclasses.replace(configs.smoke(arch), compute_dtype=f32, moe_capacity_factor=16.0)
"""

_JAX_SCRIPT = _COMMON + r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from repro import configs
from repro.compat import make_mesh
from repro.data.pipeline import synthetic_batch
from repro.launch.sharding import cache_shardings
from repro.models import model as M
from repro.models.common import init_params
from repro.models.model import ShardCtx

meshes = {m: make_mesh(shape, names) for m, (shape, names) in MESHES.items()}
out = {}


def ctx(m):
    names = MESHES[m][1]
    return ShardCtx(mesh=meshes[m], batch_axes=names[:-1], model_axis="model",
                    batch_shardable=True, seq_shard=False, remat="none")


def indices(mesh, sharding, shape):
    per = np.zeros((4, len(shape), 2), np.int64)
    for dev, index in sharding.devices_indices_map(tuple(shape)).items():
        coord = np.argwhere(mesh.devices == dev)[0]
        r = int(np.ravel_multi_index(tuple(coord), mesh.devices.shape))
        for d, sl in enumerate(index):
            per[r, d] = sl.indices(shape[d])[:2]
    return per


def greedy(logits):
    return jnp.argmax(logits, -1)[:, None].astype(jnp.int32)


for arch in ARCHS:
    c = cfg_of(configs, jnp.float32, arch)
    params = init_params(c, jax.random.key(0))
    for i, leaf in enumerate(jax.tree.leaves(params)):
        out[f"p_{arch}_{i}"] = np.asarray(leaf)
    batch = synthetic_batch(c, B, S, seed=3)
    batch.pop("labels")
    logits, cache = jax.jit(lambda p, b: M.prefill(c, p, b, max_seq=MAX_SEQ))(params, batch)
    for bsz in (4, 1):  # batch 1: row 0 (no token is dropped, so rows are independent)
        layers = [{k: (v if k == "kpos" else v[:, :bsz]) for k, v in layer.items()}
                  for layer in cache["layers"]]
        for i, layer in enumerate(layers):
            for k, v in layer.items():
                out[f"c_{arch}_{bsz}_{i}_{k}"] = np.asarray(v)
        for m, mesh in meshes.items():
            sh = cache_shardings(c, {"layers": layers}, mesh)["layers"]
            for i, layer in enumerate(layers):
                for k, v in layer.items():
                    out[f"ci_{arch}_{m}_{bsz}_{i}_{k}"] = indices(mesh, sh[i][k], v.shape)
    if arch in PLACED_ARCHS:  # one device: prefill, then 8 greedy steps
        dec = jax.jit(lambda p, cache, t: M.decode_step(c, p, cache, t))
        out[f"pl_{arch}"] = np.asarray(logits[:, -1, :c.vocab])
        tok, toks, steps = greedy(logits[:, -1, :c.vocab]), [], []
        for _ in range(STEPS):
            toks.append(np.asarray(tok))
            logits1, cache = dec(params, cache, tok)
            steps.append(np.asarray(logits1[:, 0, :c.vocab]))
            tok = greedy(logits1[:, 0, :c.vocab])
        out[f"dtok_{arch}"], out[f"dl_{arch}"] = np.stack(toks), np.stack(steps)
    if arch in TP_ARCHS:  # on the mesh, the cache placed by cache_shardings
        for m in TP_MESHES:
            tag, cc = f"{arch}_{m}", ctx(m)
            pre = jax.jit(lambda p, b: M.prefill(c, p, b, cc, max_seq=MAX_SEQ))
            dec = jax.jit(lambda p, cache, t: M.decode_step(c, p, cache, t, cc))
            logits, cache = pre(params, batch)
            cache = jax.device_put(cache, cache_shardings(c, cache, meshes[m]))
            out[f"tpl_{tag}"] = np.asarray(logits[:, -1, :c.vocab])
            tok, toks, steps = greedy(logits[:, -1, :c.vocab]), [], []
            for _ in range(STEPS):
                toks.append(np.asarray(tok))
                logits, cache = dec(params, cache, tok)
                steps.append(np.asarray(logits[:, 0, :c.vocab]))
                tok = greedy(logits[:, 0, :c.vocab])
            out[f"tdtok_{tag}"], out[f"tdl_{tag}"] = np.stack(toks), np.stack(steps)
            for i, layer in enumerate(cache["layers"]):
                for k in ("h", "conv"):
                    if k in layer:
                        out[f"tc_{tag}_{i}_{k}"] = np.asarray(layer[k])
np.savez(sys.argv[1], **out)
print("JAX_MESH_SERVE_OK")
"""

_TORCH_WORKER = _COMMON + r"""
import sys
import torch, torch.distributed as dist
from repro_torch import compat, configs, tree as T
from repro_torch.data.pipeline import synthetic_batch
from repro_torch.launch import sharding as SH, steps as TS
from repro_torch.models import model as M
from repro_torch.models.common import init_params

rank, init, jax_out, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=4)
meshes = {m: compat.make_mesh(shape, names, device="cpu") for m, (shape, names) in MESHES.items()}
jx = np.load(jax_out)
out = {}


def cfg(arch):
    return cfg_of(configs, torch.float32, arch)


def ctx(c, m, b=B):
    return TS.make_shard_ctx(c, meshes[m], b, TS.StepOptions(remat="none"))


def params_of(arch):
    p = init_params(cfg(arch), 0, device="cpu")
    leaves = [torch.from_numpy(jx[f"p_{arch}_{i}"]) for i in range(len(T.leaves(p)))]
    return M.compute_params(cfg(arch), T.unflatten(p, leaves))


def batch_of(arch, b=B):
    batch = synthetic_batch(cfg(arch), B, S, seed=3, device="cpu")
    batch.pop("labels")
    return {k: (v[:, :b] if k == "pos3" else v[:b]) for k, v in batch.items()}


def serve(c, params, batch, cc, tokens):
    # prefill, then one decode step per row of JAX's greedy tokens
    logits, cache = M.prefill(c, params, batch, cc, max_seq=MAX_SEQ)
    first, steps = logits[:, -1, :c.vocab].clone(), []
    for t in tokens:
        logits, cache = M.decode_step(c, params, cache, torch.from_numpy(t), cc)
        steps.append(logits[:, 0, :c.vocab].clone())
    return first, torch.stack(steps), cache


params = {arch: params_of(arch) for arch in ARCHS}
with torch.no_grad():
    # cache placements: each rank's blocks after a meshed prefill
    for arch in ARCHS:
        c = cfg(arch)
        for m, bsz in CACHE_CASES:
            cc = ctx(c, m, bsz)
            _, cache = M.prefill(c, M.local_params(c, params[arch], cc), batch_of(arch, bsz), cc,
                                 max_seq=MAX_SEQ)
            assert cache["max_seq"] == MAX_SEQ
            # cache_shardings of the global cache's shapes: each leaf's index
            shapes = {**cache, "layers": [
                {k: jx[f"c_{arch}_{bsz}_{i}_{k}"].shape for k in layer}
                for i, layer in enumerate(cache["layers"])]}
            sh = SH.cache_shardings(c, shapes, meshes[m])
            assert sh["pos"] is None and sh["max_seq"] is None
            coord = meshes[m].get_coordinate()
            for i, layer in enumerate(cache["layers"]):
                for k, v in layer.items():
                    out[f"c_{arch}_{m}_{bsz}_{i}_{k}"] = v.numpy().copy()
                    index = SH.block_index(shapes["layers"][i][k], sh["layers"][i][k].placements,
                                           tuple(meshes[m].shape), coord)
                    out[f"cs_{arch}_{m}_{bsz}_{i}_{k}"] = np.asarray(
                        [[sl.start, sl.stop] for sl in index])

    # the tensor-parallel Mamba decode, fed JAX's greedy tokens
    for arch in TP_ARCHS:
        c = cfg(arch)
        one = M.init_cache(c, B, MAX_SEQ, "cpu")
        out[f"h_one_{arch}"] = sum(l["h"].untyped_storage().nbytes() for l in one["layers"]
                                   if "h" in l)
        for m in TP_MESHES:
            tag, cc = f"{arch}_{m}", ctx(c, m)
            first, steps, cache = serve(c, M.local_params(c, params[arch], cc), batch_of(arch),
                                        cc, jx[f"tdtok_{tag}"])
            out[f"tpl_{tag}"], out[f"tdl_{tag}"] = first.numpy(), steps.numpy()
            out[f"h_bytes_{tag}"] = sum(l["h"].untyped_storage().nbytes()
                                        for l in cache["layers"] if "h" in l)
            for i, layer in enumerate(cache["layers"]):
                for k in ("h", "conv"):
                    if k in layer:
                        out[f"tc_{tag}_{i}_{k}"] = layer[k].numpy()

    # placed parameters against whole ones on (2, 2)
    mesh = meshes["22"]
    for arch in PLACED_ARCHS:
        c = cfg(arch)
        cc = ctx(c, "22")
        toks = jx[f"dtok_{arch}"]
        w_first, w_steps, w_cache = serve(c, M.local_params(c, params[arch], cc), batch_of(arch),
                                          cc, toks)
        out[f"wl_{arch}"], out[f"wd_{arch}"] = w_first.numpy(), w_steps.numpy()
        for fsdp, mtp in placed_options(arch):
            tag = f"{arch}_{int(fsdp)}{int(mtp)}"
            placed = SH.place(params[arch], SH.param_shardings(c, params[arch], mesh, fsdp, mtp))
            first, steps, cache = serve(c, placed, batch_of(arch), cc, toks)
            out[f"pl_{tag}"], out[f"pd_{tag}"] = first.numpy(), steps.numpy()
            out[f"eq_{tag}"] = np.asarray(
                [torch.equal(first, w_first), torch.equal(steps, w_steps)]
                + [torch.equal(a, b) for a, b in zip(T.leaves(cache["layers"]),
                                                     T.leaves(w_cache["layers"]))])

    # the serving driver on the mesh (weights built placed from the seed)
    # against the same driver on one device
    from repro_torch.launch.serve import serve
    c = cfg("jamba-v0.1-52b")
    kw = dict(config=c, n_requests=6, batch=4, prompt_len=16, max_new=4, seed=2, device="cpu")
    one, meshed = serve(**kw), serve(**kw, mesh=mesh)
    out["serve"] = np.asarray([one["tokens"], meshed["tokens"]])
    out["serve_samples"] = np.asarray([one["samples"], meshed["samples"]])

    # the leaf-by-leaf build against the whole tree's blocks
    for arch in ("jamba-v0.1-52b", "qwen2-vl-2b", "gemma2-2b"):
        c = configs.smoke(arch)
        whole = M.compute_params(c, init_params(c, 5, device="cpu"))
        out[f"lbl_{arch}_whole"] = np.asarray([  # no mesh: the whole tree
            t.dtype == w.dtype and torch.equal(t, w) for t, w in
            zip(T.leaves(SH.placed_compute_params(c, 5, device="cpu")), T.leaves(whole))])
        for fsdp, mtp in ((True, True), (False, False)):
            sh = SH.param_shardings(c, whole, mesh, fsdp, mtp)
            built = SH.placed_compute_params(c, 5, mesh, fsdp, mtp, device="cpu")
            # compute_params of the placed float32 masters casts block by block
            cast = M.compute_params(c, SH.place(init_params(c, 5, device="cpu"), sh))
            out[f"lbl_{arch}_{int(fsdp)}{int(mtp)}"] = np.asarray([
                t.placements == s.placements == u.placements and t.dtype == w.dtype == u.dtype
                and torch.equal(t.to_local(), SH.local_block(w, s))
                and torch.equal(u.to_local(), t.to_local())
                for t, u, w, s in zip(T.leaves(built), T.leaves(cast), T.leaves(whole),
                                      T.leaves(sh))])
np.savez(f"{outdir}/rank{rank}.npz", **out)
dist.destroy_process_group()
print("TORCH_MESH_SERVE_OK", rank)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_serve")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    jax_run = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "jax.npz")],
                             capture_output=True, text=True, timeout=_TIMEOUT, env=env)
    assert "JAX_MESH_SERVE_OK" in jax_run.stdout, jax_run.stdout[-2000:] + jax_run.stderr[-3000:]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TORCH_WORKER, str(r), str(d / "pg"), str(d / "jax.npz"), str(d)],
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
        assert p.returncode == 0 and f"TORCH_MESH_SERVE_OK {r}" in text, text[-3000:]
    return np.load(d / "jax.npz"), [np.load(d / f"rank{r}.npz") for r in range(_WORLD)]


_SHARED: dict = {}
exec(_COMMON, _SHARED)  # noqa: S102 - the cases, as the scripts hold them


def _rows_block(arr, mesh: str, rank: int, lead: int = 0) -> np.ndarray:
    """A rank's batch rows of ``arr`` (batch on dim ``lead``)."""
    shape, names = _SHARED["MESHES"][mesh]
    spec = (None,) * lead + (names[:-1],)
    return convert.block_from_jax(arr, spec, shape, names, rank)


# --------------------------------------------------------- cache placements
@pytest.mark.parametrize("case", [f"{m}_{b}" for m, b in _SHARED["CACHE_CASES"]])
@pytest.mark.parametrize("arch", _SHARED["ARCHS"])
def test_cache_blocks_equal_jax_cache_shardings_blocks(runs, arch, case):
    """Every leaf of every layer, Mamba's h (split on d_inner, dim 2) and
    conv (dim 3) included: the rank's block is JAX's cache at the index
    ``cache_shardings`` gives the device at the rank's coordinate, and the
    port's ``cache_shardings`` gives that index."""
    jx, ranks = runs
    mesh, bsz = case.split("_")
    keys = [k for k in jx.files if k.startswith(f"c_{arch}_{bsz}_")]
    assert keys
    for r, got in enumerate(ranks):
        for key in keys:
            rest = key[len(f"c_{arch}_{bsz}_"):]
            want_all, index = jx[key], jx[f"ci_{arch}_{mesh}_{bsz}_{rest}"][r]
            want = want_all[tuple(slice(a, b) for a, b in index)]
            have = got[f"c_{arch}_{mesh}_{bsz}_{rest}"]
            np.testing.assert_array_equal(got[f"cs_{arch}_{mesh}_{bsz}_{rest}"], index)
            assert have.shape == want.shape, (key, have.shape, want.shape)
            if rest.endswith("kpos"):
                np.testing.assert_array_equal(have, want)
            else:
                np.testing.assert_allclose(have, want, **BODY, err_msg=key)


def test_mamba_state_is_split_over_d_inner(runs):
    """On (1, 4) each rank's h and conv hold a quarter of d_inner, the
    batch of 4 whole; on (2, 2) at batch 1 (below dp) half of d_inner."""
    from repro_torch import configs

    _, ranks = runs
    c = configs.smoke("falcon-mamba-7b")
    NP, di, st, K = c.n_periods, c.d_inner, c.ssm_d_state, c.ssm_d_conv
    for got in ranks:
        assert got["c_falcon-mamba-7b_14_4_0_h"].shape == (NP, 4, di // 4, st)
        assert got["c_falcon-mamba-7b_14_4_0_conv"].shape == (NP, 4, K - 1, di // 4)
        assert got["c_jamba-v0.1-52b_22_1_0_h"].shape == (configs.smoke("jamba-v0.1-52b").n_periods,
                                                          1, di // 2, st)


# ------------------------------------------------- tensor-parallel decode
@pytest.mark.parametrize("mesh", _SHARED["TP_MESHES"])
@pytest.mark.parametrize("arch", _SHARED["TP_ARCHS"])
def test_tensor_parallel_mamba_decode_matches_jax(runs, arch, mesh):
    """Prefill and 8 decode steps: each rank's rows of the logits at SERVE,
    its blocks of h and conv after the steps at BODY (jamba's 16 layers at
    SERVE)."""
    jx, ranks = runs
    tag = f"{arch}_{mesh}"
    shape, names = _SHARED["MESHES"][mesh]
    state_tol = BODY if arch == "falcon-mamba-7b" else SERVE
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"tpl_{tag}"], _rows_block(jx[f"tpl_{tag}"], mesh, r),
                                   **SERVE)
        np.testing.assert_allclose(got[f"tdl_{tag}"], _rows_block(jx[f"tdl_{tag}"], mesh, r, 1),
                                   **SERVE)
        keys = [k for k in jx.files if k.startswith(f"tc_{tag}_")]
        assert keys
        for key in keys:
            spec = (None, names[:-1], "model") if key.endswith("_h") else \
                (None, names[:-1], None, "model")
            want = convert.block_from_jax(jx[key], spec, shape, names, r)
            np.testing.assert_allclose(got[key], want, **state_tol, err_msg=key)


@pytest.mark.parametrize("arch", _SHARED["TP_ARCHS"])
def test_tensor_parallel_state_holds_a_quarter_of_the_bytes(runs, arch):
    """On (1, 4) a rank's h takes a quarter of the one-device state's
    bytes: no leaf is a view of a whole state."""
    _, ranks = runs
    for got in ranks:
        assert int(got[f"h_bytes_{arch}_14"]) * 4 == int(got[f"h_one_{arch}"])


# --------------------------------------------------------- placed weights
def _placed_cases():
    return [(a, f"{int(f)}{int(m)}") for a in _SHARED["PLACED_ARCHS"]
            for f, m in _SHARED["placed_options"](a)]


@pytest.mark.parametrize("arch,opts", _placed_cases())
def test_placed_weights_serve_bitwise_as_whole_weights(runs, arch, opts):
    """Prefill logits, 8 decode steps' logits and every cache block after
    them: bitwise those of the same meshed run with whole weights."""
    _, ranks = runs
    for r, got in enumerate(ranks):
        eq = got[f"eq_{arch}_{opts}"]
        assert eq.size > 2 and eq.all(), (r, eq)


@pytest.mark.parametrize("arch,opts", _placed_cases())
def test_placed_weights_serve_within_serve_bound_of_jax(runs, arch, opts):
    """Each rank's rows of the prefill and decode logits against JAX's
    one-device run, placed and whole."""
    jx, ranks = runs
    for r, got in enumerate(ranks):
        want_pre = _rows_block(jx[f"pl_{arch}"], "22", r)
        want_dec = _rows_block(jx[f"dl_{arch}"], "22", r, 1)
        for pre, dec in ((f"pl_{arch}_{opts}", f"pd_{arch}_{opts}"), (f"wl_{arch}", f"wd_{arch}")):
            np.testing.assert_allclose(got[pre], want_pre, **SERVE)
            np.testing.assert_allclose(got[dec], want_dec, **SERVE)


def test_serve_driver_on_a_mesh_matches_one_device(runs):
    """launch.serve.serve(mesh=) on (2, 2) (the batch split over data, the
    weights placed from the seed, the next tokens gathered) serves jamba's
    smoke model's greedy tokens as serve on one device does, 6 requests in
    waves of 4 (the last padded)."""
    _, ranks = runs
    for got in ranks:
        assert list(got["serve"]) == [24, 24]
        np.testing.assert_array_equal(got["serve_samples"][1], got["serve_samples"][0])


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "qwen2-vl-2b", "gemma2-2b"])
def test_leaf_by_leaf_build_equals_the_whole_trees_blocks(runs, arch):
    """placed_compute_params: each leaf's block, placements and dtype those
    of local_block(compute_params(init_params)), bitwise, fsdp and mamba_tp
    on and off; and compute_params of the placed float32 masters gives the
    same blocks.  Without a mesh it builds the whole tree, bitwise."""
    _, ranks = runs
    for r, got in enumerate(ranks):
        for opts in ("11", "00", "whole"):
            ok = got[f"lbl_{arch}_{opts}"]
            assert ok.size > 0 and ok.all(), (r, opts, ok)
