"""Sequence and expert parallelism over the model axis: the port in four
gloo processes against the JAX package on four host devices.

The twin of tests/test_seq_parallel.py:17-35 and more.  JAX runs once per
session in a child process (``XLA_FLAGS`` set before import), the port in
four spawned gloo processes, each on two meshes, (2, 2) and (1, 4), over
("data", "model"), every case in turn.  Inputs are numpy from seeds; the
smoke configs compute in float32 with ``moe_capacity_factor=16``.  Each
rank writes its blocks and the test holds them against
``convert.block_from_jax`` of JAX's global arrays.

Tolerances, each stated where it is held:

  * the meshed forward of gemma2-2b, falcon-mamba-7b, jamba-v0.1-52b and
    minicpm3-4b at B 4, S 128 against JAX's single-device forward at
    tests/test_seq_parallel.py's own bound, 1e-3 + 1e-4·scale; jamba also
    against JAX's forward on the (2, 2) mesh, where sequence and expert
    parallelism compose;
  * each body against JAX's own function on the (1, 4) mesh (its
    ``shard_map`` inside): ``_attention_seq_parallel`` (causal, window,
    softcap, bidirectional), ``mamba_mixer_seq_parallel`` (both scan
    routes), ``moe_block(ep=)`` through ``_mlp_apply``,
    ``_attn_decode_sharded`` (a global layer and an SWA layer past its
    window) and ``_mla_decode_sharded``, at rtol 1e-5 (atol 1e-5 near
    zero): the gathers are exact, the sums differ only in order;
  * prefill of 64 tokens (past the smoke window of 32) and 8 greedy decode
    steps of gemma2-2b and minicpm3-4b on both meshes against JAX's
    ``decode_step`` on the mesh with its cache placed by
    ``cache_shardings``, logits at rtol 1e-4, atol 1e-4 (the port merges
    partial softmaxes where XLA takes one), each rank's cache block against
    the block ``cache_pspec`` gives it at 1e-5 (kpos exact), and a rank's
    cache takes a quarter of the one-device cache's bytes;
  * S < 16·tp leaves the sequence replicated and E % tp ≠ 0 takes
    ``ep=None`` (the global batch routed), each against JAX's forward at
    the first bound.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch import sharding as JSH  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import sharding as TSH  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_WORLD = 4
_TIMEOUT = 420
ARCHS = ("gemma2-2b", "falcon-mamba-7b", "jamba-v0.1-52b", "minicpm3-4b")
MESHES = {"22": (2, 2), "14": (1, 4)}
NAMES = ("data", "model")
SERVE_ARCHS = ("gemma2-2b", "minicpm3-4b")
B, S, S_SERVE, MAX_SEQ, STEPS = 4, 128, 64, 72, 8
ATTN = {"causal": (True, 0, 0.0), "window": (True, 32, 0.0), "softcap": (True, 0, 50.0),
        "bidirectional": (False, 0, 0.0)}
BODY = dict(rtol=1e-5, atol=1e-5)
SERVE = dict(rtol=1e-4, atol=1e-4)

# Shared by both sides: the configs and the body inputs, made from seeds.
_COMMON = r"""
import dataclasses
import numpy as np

ARCHS = ("gemma2-2b", "falcon-mamba-7b", "jamba-v0.1-52b", "minicpm3-4b")
SERVE_ARCHS = ("gemma2-2b", "minicpm3-4b")
B, S, S_SERVE, MAX_SEQ, STEPS = 4, 128, 64, 72, 8
ATTN = {"causal": (True, 0, 0.0), "window": (True, 32, 0.0), "softcap": (True, 0, 50.0),
        "bidirectional": (False, 0, 0.0)}
DECODE = {"global": ("full", 72, 64), "swa": ("swa", 32, 70)}  # mixer, slots, position


def cfg_of(configs, f32, arch, **kw):
    return dataclasses.replace(configs.smoke(arch), compute_dtype=f32,
                               moe_capacity_factor=16.0, **kw)


def body_inputs(cfg_gemma, cfg_mla):
    rng = np.random.default_rng(5)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)  # noqa: E731
    H, KV, hd = cfg_gemma.n_heads, cfg_gemma.n_kv_heads, cfg_gemma.head_dim
    out = {"q": f(B, S, H, hd), "k": f(B, S, KV, hd), "v": f(B, S, KV, hd),
           "u": f(B, S, cfg_gemma.d_model), "h": f(B, S, cfg_gemma.d_model)}
    for name, (_, Sc, pos) in DECODE.items():
        kpos = np.full((Sc,), -1, np.int32)
        for p in range(max(0, pos - Sc), pos):
            kpos[p % Sc] = p
        out.update({f"{name}_q": f(B, 1, H, hd), f"{name}_kn": f(B, 1, KV, hd),
                    f"{name}_vn": f(B, 1, KV, hd), f"{name}_ck": f(B, Sc, KV, hd),
                    f"{name}_cv": f(B, Sc, KV, hd), f"{name}_kpos": kpos})
    H, kvr, rope = cfg_mla.n_heads, cfg_mla.kv_lora_rank, cfg_mla.qk_rope_dim
    ckv, krope = f(B, MAX_SEQ, kvr), f(B, MAX_SEQ, rope)
    ckv[:, 64:] = 0.0
    krope[:, 64:] = 0.0
    out.update({"mla_qe": f(B, 1, H, kvr), "mla_qr": f(B, 1, H, rope), "mla_cn": f(B, 1, kvr),
                "mla_kn": f(B, 1, 1, rope), "mla_ckv": ckv, "mla_krope": krope})
    return out
"""

_JAX_SCRIPT = _COMMON + r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, jax.numpy as jnp
from repro import configs
from repro.compat import make_mesh
from repro.data.pipeline import synthetic_batch
from repro.launch.sharding import cache_shardings
from repro.models import mamba as MB, model as M
from repro.models.common import init_params
from repro.models.model import ShardCtx

meshes = {"22": make_mesh((2, 2), ("data", "model")), "14": make_mesh((1, 4), ("data", "model"))}
ctx = lambda m: ShardCtx(mesh=meshes[m], batch_axes=("data",), model_axis="model",  # noqa: E731
                         batch_shardable=True, seq_shard=True, remat="none")
cfg = lambda arch, **kw: cfg_of(configs, jnp.float32, arch, **kw)  # noqa: E731
out, params = {}, {}


def save_params(tag, p):
    for i, leaf in enumerate(jax.tree.leaves(p)):
        out[f"p_{tag}_{i}"] = np.asarray(leaf)


for arch in ARCHS:
    c = cfg(arch)
    params[arch] = init_params(c, jax.random.key(0))
    save_params(arch, params[arch])
    batch = synthetic_batch(c, B, S, seed=1)
    out[f"tok_{arch}"] = np.asarray(batch["tokens"])
    out[f"fwd_{arch}"] = np.asarray(M.forward(c, params[arch], batch))
c = cfg("jamba-v0.1-52b")
out["fwd22_jamba"] = np.asarray(jax.jit(lambda p, b: M.forward(c, p, b, ctx("22")))(
    params["jamba-v0.1-52b"], {"tokens": jnp.asarray(out["tok_jamba-v0.1-52b"])}))

# edges: S < 16 tp (replicated sequence), E % tp != 0 (ep=None)
c = cfg("gemma2-2b")
short = synthetic_batch(c, B, 32, seed=2)
out["tok_short"] = np.asarray(short["tokens"])
out["fwd_short"] = np.asarray(M.forward(c, params["gemma2-2b"], short))
c6 = cfg("granite-moe-1b-a400m", moe_experts=6)
p6 = init_params(c6, jax.random.key(0))
save_params("e6", p6)
b6 = synthetic_batch(c6, B, S, seed=1)
out["tok_e6"] = np.asarray(b6["tokens"])
out["fwd_e6"] = np.asarray(M.forward(c6, p6, b6))

# the bodies on the (1, 4) mesh
x = {k: jnp.asarray(v) for k, v in body_inputs(cfg("gemma2-2b"), cfg("minicpm3-4b")).items()}
c14 = ctx("14")
for name, (causal, window, cap) in ATTN.items():
    f = jax.jit(lambda q, k, v, causal=causal, window=window, cap=cap: M._attention_seq_parallel(
        q, k, v, c14, causal=causal, window=window, cap=cap))
    out[f"attn_{name}"] = np.asarray(f(x["q"], x["k"], x["v"]))
cm = cfg("falcon-mamba-7b")
pm = {k: v[0] for k, v in params["falcon-mamba-7b"]["layers"][0].items()}
mixer = jax.jit(lambda p, u: MB.mamba_mixer_seq_parallel(p, u, cm, c14, chunk=32))
out["mamba"] = np.asarray(mixer(pm, x["u"]))
state = M._mamba_prefill_state(cm, pm, x["u"])
out["mamba_h"], out["mamba_conv"] = np.asarray(state["h"]), np.asarray(state["conv"])
cj = cfg("jamba-v0.1-52b")
pj = {k: v[0] for k, v in params["jamba-v0.1-52b"]["layers"][1].items()}
out["moe"] = np.asarray(jax.jit(lambda p, h: M._mlp_apply(cj, cj.layout[1], p, h, c14))(pj, x["h"]))
cg = cfg("gemma2-2b")
for name, (mixer, Sc, pos) in DECODE.items():
    spec = cg.layout[0] if mixer == "swa" else cg.layout[1]
    cache = {"k": x[f"{name}_ck"], "v": x[f"{name}_cv"], "kpos": x[f"{name}_kpos"]}
    f = jax.jit(lambda q, kn, vn, cache, spec=spec, pos=pos: M._attn_decode_sharded(
        cg, spec, None, q, kn, vn, cache, jnp.int32(pos), c14))
    o, new = f(x[f"{name}_q"], x[f"{name}_kn"], x[f"{name}_vn"], cache)
    out[f"dec_{name}"] = np.asarray(o)
    for k in ("k", "v", "kpos"):
        out[f"dec_{name}_{k}"] = np.asarray(new[k])
cl = cfg("minicpm3-4b")
f = jax.jit(lambda qe, qr, cn, kn, cache: M._mla_decode_sharded(cl, None, qe, qr, cn, kn, cache,
                                                               jnp.int32(64), c14))
lat, new = f(x["mla_qe"], x["mla_qr"], x["mla_cn"], x["mla_kn"],
             {"ckv": x["mla_ckv"], "krope": x["mla_krope"]})
out["mla_lat"], out["mla_ckv"], out["mla_krope"] = (np.asarray(t) for t in (lat, new["ckv"],
                                                                            new["krope"]))

# meshed prefill and greedy decode, the cache placed by cache_shardings
for arch in SERVE_ARCHS:
    c = cfg(arch)
    batch = synthetic_batch(c, B, S_SERVE, seed=3)
    out[f"stok_{arch}"] = np.asarray(batch["tokens"])
    for m in ("22", "14"):
        tag = f"{arch}_{m}"
        pre = jax.jit(lambda p, b, cc=ctx(m), c=c: M.prefill(c, p, b, cc, max_seq=MAX_SEQ))
        dec = jax.jit(lambda p, cache, t, cc=ctx(m), c=c: M.decode_step(c, p, cache, t, cc))
        logits, cache = pre(params[arch], batch)
        cache = jax.device_put(cache, cache_shardings(c, cache, meshes[m]))
        for i, layer in enumerate(cache["layers"]):
            for k, v in layer.items():
                out[f"pc_{tag}_{i}_{k}"] = np.asarray(v)
        out[f"pl_{tag}"] = np.asarray(logits[:, -1, :c.vocab])
        tok = jnp.argmax(logits[:, -1, :c.vocab], -1)[:, None].astype(jnp.int32)
        toks, steps = [], []
        for _ in range(STEPS):
            toks.append(np.asarray(tok))
            logits, cache = dec(params[arch], cache, tok)
            steps.append(np.asarray(logits[:, 0, :c.vocab]))
            tok = jnp.argmax(logits[:, 0, :c.vocab], -1)[:, None].astype(jnp.int32)
        out[f"dtok_{tag}"], out[f"dl_{tag}"] = np.stack(toks), np.stack(steps)
        for i, layer in enumerate(cache["layers"]):
            for k, v in layer.items():
                out[f"dc_{tag}_{i}_{k}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
print("JAX_SEQ_OK")
"""

_TORCH_WORKER = _COMMON + r"""
import sys
import torch, torch.distributed as dist
from repro_torch import compat, configs, tree as T
from repro_torch.models import mamba as MB, model as M
from repro_torch.models.common import init_params
from repro_torch.models.moe import moe_block
from repro_torch.launch import steps as TS

rank, init, jax_out, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=4)
meshes = {m: compat.make_mesh(shape, ("data", "model"), device="cpu")
          for m, shape in (("22", (2, 2)), ("14", (1, 4)))}
jx = np.load(jax_out)
cfg = lambda arch, **kw: cfg_of(configs, torch.float32, arch, **kw)  # noqa: E731
opts = TS.StepOptions(seq_shard=True, remat="none")
ctx = lambda c, m, b=B: TS.make_shard_ctx(c, meshes[m], b, opts)  # noqa: E731
out = {}


def params_of(tag, c):
    p = init_params(c, 0, device="cpu")
    n = len(T.leaves(p))
    leaves = [torch.from_numpy(jx[f"p_{tag}_{i}"]) for i in range(n)]
    return M.compute_params(c, T.unflatten(p, leaves))


def tokens(key):
    return {"tokens": torch.from_numpy(jx[key])}


params = {arch: params_of(arch, cfg(arch)) for arch in ARCHS}
with torch.no_grad():
    for arch in ARCHS:
        c = cfg(arch)
        for m in meshes:
            cc = ctx(c, m)
            out[f"fwd_{arch}_{m}"] = M.forward(c, M.local_params(c, params[arch], cc),
                                               tokens(f"tok_{arch}"), cc).numpy()
    c = cfg("gemma2-2b")
    cc = ctx(c, "14")
    assert not cc.for_pass(B, 32).seq_shard
    out["fwd_short"] = M.forward(c, params["gemma2-2b"], tokens("tok_short"), cc).numpy()
    c6 = cfg("granite-moe-1b-a400m", moe_experts=6)
    p6 = params_of("e6", c6)
    for m in meshes:
        cc = ctx(c6, m)
        out[f"fwd_e6_{m}"] = M.forward(c6, M.local_params(c6, p6, cc), tokens("tok_e6"), cc).numpy()
    out["e6_ep"] = np.asarray([ctx(c6, m).ep_info(c6) is not None for m in ("22", "14")])

# the bodies on the (1, 4) mesh: each rank's blocks
x = {k: torch.from_numpy(v) for k, v in body_inputs(cfg("gemma2-2b"), cfg("minicpm3-4b")).items()}
c14 = ctx(cfg("gemma2-2b"), "14").for_pass(B, S)
r, S_loc = c14.model_rank, S // 4
rows = slice(r * S_loc, (r + 1) * S_loc)
for name, (causal, window, cap) in ATTN.items():
    o, _, _ = M._attention_seq_parallel(x["q"][:, rows], x["k"][:, rows], x["v"][:, rows], c14,
                                        causal=causal, window=window, cap=cap)
    out[f"attn_{name}"] = o.numpy()
cm = cfg("falcon-mamba-7b")
pm = {k: v[0] for k, v in params["falcon-mamba-7b"]["layers"][0].items()}
y = MB.mamba_mixer_seq_parallel(pm, x["u"][:, rows], cm, c14, chunk=32)
out["mamba_grad"] = y.detach().numpy()
with torch.no_grad():
    y, state = MB.mamba_mixer_seq_parallel(pm, x["u"][:, rows], cm, c14, chunk=32, with_state=True)
out["mamba_kernel"] = y.numpy()
out["mamba_h"], out["mamba_conv"] = state["h"].numpy(), state["conv"].numpy()
cj = cfg("jamba-v0.1-52b")
pj = {k: v[0] for k, v in M.local_params(cj, params["jamba-v0.1-52b"], c14)["layers"][1].items()}
out["moe"] = moe_block(pj, x["h"], cj, c14.ep_info(cj)).numpy()
cg = cfg("gemma2-2b")
for name, (mixer, Sc, pos) in DECODE.items():
    spec = cg.layout[0] if mixer == "swa" else cg.layout[1]
    n = Sc // 4
    blk = slice(r * n, (r + 1) * n)
    cache = {"k": x[f"{name}_ck"][:, blk].clone(), "v": x[f"{name}_cv"][:, blk].clone(),
             "kpos": x[f"{name}_kpos"][blk].clone()}
    o = M._attn_decode_sharded(cg, spec, None, x[f"{name}_q"], x[f"{name}_kn"], x[f"{name}_vn"],
                               cache, pos, c14)
    out[f"dec_{name}"] = o.numpy()
    for k in ("k", "v", "kpos"):
        out[f"dec_{name}_{k}"] = cache[k].numpy()
cl = cfg("minicpm3-4b")
blk = slice(r * MAX_SEQ // 4, (r + 1) * MAX_SEQ // 4)
cache = {"ckv": x["mla_ckv"][:, blk].clone(), "krope": x["mla_krope"][:, blk].clone()}
out["mla_lat"] = M._mla_decode_sharded(cl, None, x["mla_qe"], x["mla_qr"], x["mla_cn"], x["mla_kn"],
                                       cache, 64, c14).numpy()
out["mla_ckv"], out["mla_krope"] = cache["ckv"].numpy(), cache["krope"].numpy()

# meshed prefill and decode, fed JAX's greedy tokens


def storage_bytes(cache):  # k, v, ckv, krope; a view counts the whole storage behind it
    return sum(t.untyped_storage().nbytes() for layer in cache["layers"]
               for name, t in layer.items() if name != "kpos")


with torch.no_grad():
    for arch in SERVE_ARCHS:
        c = cfg(arch)
        out[f"cb_one_{arch}"] = storage_bytes(M.init_cache(c, B, MAX_SEQ, "cpu"))
        for m in meshes:
            tag, cc = f"{arch}_{m}", ctx(c, m)
            out[f"cb_init_{tag}"] = storage_bytes(M.init_cache(c, B, MAX_SEQ, "cpu", cc))
            logits, cache = M.prefill(c, params[arch], tokens(f"stok_{arch}"), cc, max_seq=MAX_SEQ)
            out[f"cb_pre_{tag}"] = storage_bytes(cache)
            out[f"pl_{tag}"] = logits[:, -1, :c.vocab].numpy()
            for i, layer in enumerate(cache["layers"]):
                for k, v in layer.items():
                    out[f"pc_{tag}_{i}_{k}"] = v.numpy().copy()
            steps = []
            for t in range(STEPS):
                logits, cache = M.decode_step(c, params[arch], cache,
                                              torch.from_numpy(jx[f"dtok_{tag}"][t]), cc)
                steps.append(logits[:, 0, :c.vocab].numpy())
            out[f"dl_{tag}"] = np.stack(steps)
            for i, layer in enumerate(cache["layers"]):
                for k, v in layer.items():
                    out[f"dc_{tag}_{i}_{k}"] = v.numpy()
np.savez(f"{outdir}/rank{rank}.npz", **out)
dist.destroy_process_group()
print("TORCH_SEQ_OK", rank)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("seq")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    jax_run = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, str(d / "jax.npz")],
                             capture_output=True, text=True, timeout=_TIMEOUT, env=env)
    assert "JAX_SEQ_OK" in jax_run.stdout, jax_run.stdout[-2000:] + jax_run.stderr[-3000:]
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
        assert p.returncode == 0 and f"TORCH_SEQ_OK {r}" in text, text[-3000:]
    return np.load(d / "jax.npz"), [np.load(d / f"rank{r}.npz") for r in range(_WORLD)]


def _block(arr, spec, mesh: str, rank: int) -> np.ndarray:
    return convert.block_from_jax(arr, spec, MESHES[mesh], NAMES, rank)


def _within_forward_bound(got, want):
    """tests/test_seq_parallel.py:32's bound."""
    d, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert d < 1e-3 + 1e-4 * scale, (d, scale)


HIDDEN = (("data",), "model", None)  # the logits' spec, as ShardCtx.hidden_spec


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_meshed_forward_matches_jax(runs, arch, mesh):
    jx, ranks = runs
    for r, got in enumerate(ranks):
        want = _block(jx[f"fwd_{arch}"], HIDDEN, mesh, r)
        assert got[f"fwd_{arch}_{mesh}"].shape == want.shape
        _within_forward_bound(got[f"fwd_{arch}_{mesh}"], want)


def test_jamba_meshed_forward_matches_jax_on_its_mesh(runs):
    """Sequence and expert parallelism composed, against JAX's own meshed
    forward on the (2, 2) mesh."""
    jx, ranks = runs
    for r, got in enumerate(ranks):
        _within_forward_bound(got["fwd_jamba-v0.1-52b_22"],
                              _block(jx["fwd22_jamba"], HIDDEN, "22", r))


def test_short_sequence_stays_replicated(runs):
    """S 32 < 16·tp at tp 4: no sequence parallelism; every rank holds the
    whole sequence of its batch rows, JAX's values."""
    jx, ranks = runs
    for got in ranks:
        assert got["fwd_short"].shape == jx["fwd_short"].shape
        _within_forward_bound(got["fwd_short"], jx["fwd_short"])


def test_indivisible_experts_take_ep_none(runs):
    """E 6: expert parallel over tp 2, not over tp 4, where the port routes
    the global batch as XLA does; both against JAX's forward."""
    jx, ranks = runs
    for r, got in enumerate(ranks):
        assert list(got["e6_ep"]) == [True, False]
        for mesh in MESHES:
            _within_forward_bound(got[f"fwd_e6_{mesh}"], _block(jx["fwd_e6"], HIDDEN, mesh, r))


# ------------------------------------------------------------------- bodies
@pytest.mark.parametrize("variant", list(ATTN))
def test_seq_parallel_attention_matches_jax(runs, variant):
    jx, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"attn_{variant}"],
                                   _block(jx[f"attn_{variant}"], (None, "model"), "14", r), **BODY)


@pytest.mark.parametrize("route", ["grad", "kernel"])
def test_seq_parallel_mamba_mixer_matches_jax(runs, route):
    """Both scan routes (the chunked scan under autograd, the scan kernel's
    plain version on the CPU without), and the state prefill caches: the
    prefix combine carried past the last rank against JAX's
    ``_mamba_prefill_state``, the conv state bitwise."""
    jx, ranks = runs
    for r, got in enumerate(ranks):
        want = _block(jx["mamba"], (None, "model"), "14", r)
        np.testing.assert_allclose(got[f"mamba_{route}"], want, **BODY)
        np.testing.assert_allclose(got["mamba_h"], jx["mamba_h"], **BODY)
        np.testing.assert_array_equal(got["mamba_conv"], jx["mamba_conv"])


def test_moe_block_ep_matches_jax(runs):
    """Two experts per rank, one all-reduce: every rank holds JAX's output."""
    jx, ranks = runs
    for got in ranks:
        np.testing.assert_allclose(got["moe"], jx["moe"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layer", ["global", "swa"])
def test_attn_decode_sharded_matches_jax(runs, layer):
    """The merge of four partial softmaxes, and the new key written into the
    block that owns its slot (the SWA ring's slot 70 % 32 = 6, rank 0)."""
    jx, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got[f"dec_{layer}"], jx[f"dec_{layer}"], **BODY)
        for k, spec in (("k", (None, "model")), ("v", (None, "model")), ("kpos", ("model",))):
            np.testing.assert_array_equal(got[f"dec_{layer}_{k}"],
                                          _block(jx[f"dec_{layer}_{k}"], spec, "14", r))


def test_mla_decode_sharded_matches_jax(runs):
    jx, ranks = runs
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["mla_lat"], jx["mla_lat"], **BODY)
        for k in ("ckv", "krope"):
            np.testing.assert_array_equal(got[f"mla_{k}"],
                                          _block(jx[f"mla_{k}"], (None, "model"), "14", r))


# ----------------------------------------------------------- prefill, decode
class _Mesh:
    """What ``cache_pspec`` reads of a mesh."""

    def __init__(self, shape):
        self.mesh_dim_names, self.shape = NAMES, shape


def _cache_spec(arch, mesh, key, shape):
    """``cache_pspec``'s block spec, JAX's full rule."""
    from repro_torch import configs

    return TSH.cache_pspec([key], shape, configs.smoke(arch), _Mesh(MESHES[mesh]))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_meshed_prefill_and_decode_match_jax(runs, arch, mesh):
    """Last-position logits of prefill and of 8 decode steps, each rank's
    batch rows."""
    jx, ranks = runs
    tag = f"{arch}_{mesh}"
    for r, got in enumerate(ranks):
        rows = (("data",), None)
        np.testing.assert_allclose(got[f"pl_{tag}"], _block(jx[f"pl_{tag}"], rows, mesh, r),
                                   **SERVE)
        np.testing.assert_allclose(got[f"dl_{tag}"],
                                   _block(jx[f"dl_{tag}"], (None,) + rows, mesh, r), **SERVE)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_meshed_caches_are_the_ranks_blocks_of_jax(runs, arch, mesh):
    """After prefill and after the decode steps, each rank's cache block is
    the block ``cache_pspec`` gives it of JAX's placed cache."""
    jx, ranks = runs
    tag = f"{arch}_{mesh}"
    keys = [k for k in jx.files if k.startswith(f"pc_{tag}_")]
    assert keys
    for r, got in enumerate(ranks):
        for when in ("pc", "dc"):
            for key in keys:
                name = f"{when}{key[2:]}"
                leaf = name.rsplit("_", 1)[1]
                want = _block(jx[name], _cache_spec(arch, mesh, leaf, jx[name].shape), mesh, r)
                assert got[name].shape == want.shape, (name, got[name].shape, want.shape)
                if leaf == "kpos":
                    np.testing.assert_array_equal(got[name], want)
                else:
                    np.testing.assert_allclose(got[name], want, **BODY)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_meshed_caches_hold_only_the_ranks_blocks(runs, arch, mesh):
    """On both meshes the keys, values and latents are split four ways
    (batch over data, sequence over model), so a rank's zeroed cache and
    its prefill cache hold a quarter of the one-device cache's bytes of
    them: no leaf is a view of a whole cache.  (kpos, (NP, Sc), splits
    over the model axis only; its blocks are held with the rest in
    test_meshed_caches_are_the_ranks_blocks_of_jax.)"""
    _, ranks = runs
    tag = f"{arch}_{mesh}"
    for got in ranks:
        one = int(got[f"cb_one_{arch}"])
        assert int(got[f"cb_init_{tag}"]) * _WORLD == one
        assert int(got[f"cb_pre_{tag}"]) * _WORLD == one


# ------------------------------------------------------------------ convert
def test_block_from_jax_takes_a_ranks_block_by_the_spec():
    """Ranks row-major over the mesh dims, a tuple entry split major to
    minor; specs from both packages' cache rules agree."""
    a = np.arange(4 * 8 * 6).reshape(4, 8, 6)
    for r in range(4):
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(
            convert.block_from_jax(a, ("data", "model"), (2, 2), NAMES, r),
            a[2 * i:2 * i + 2, 4 * j:4 * j + 4])
        np.testing.assert_array_equal(
            convert.block_from_jax(a, (None, ("data", "model")), (2, 2), NAMES, r),
            a[:, 2 * r:2 * r + 2])
    with pytest.raises(ValueError, match="split"):
        convert.block_from_jax(a, (None, None, "model"), (1, 4), NAMES, 0)
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs

    for key, shape in (("k", (1, 4, 72, 2, 16)), ("kpos", (1, 72)), ("ckv", (1, 4, 72, 32)),
                       ("h", (1, 4, 128, 8))):
        for mesh in MESHES.values():
            jspec = JSH.cache_pspec([key], shape, jconfigs.smoke("gemma2-2b"),
                                    type("M", (), {"shape": dict(zip(NAMES, mesh)),
                                                   "axis_names": NAMES})())
            tspec = TSH.cache_pspec([key], shape, tconfigs.smoke("gemma2-2b"), _Mesh(mesh))
            assert tuple(jspec) == tspec
