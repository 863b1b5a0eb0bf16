"""DeepSeek-V2-Lite in the port, on the CPU.

The JAX package has no such configuration, so the port is held against the
benchmark's plain float32 reference (``perfbench/reference/deepseek_v2.py``)
on seeded random weights, at smoke("deepseek-v2-lite")'s widths (d 64, 4
heads, latent 32, nope 8 + rope 8, v 16, 8 experts of width 32 and 2 shared)
with its published top-6, one dense and three MoE layers, and YaRN's
original length 8, below the 24-token prompts, so that the frequency ramp
lies inside the rope dim.  Beside it: YaRN's numbers at the published
sizes, the published parameter count, the new spans and counts, the
sharding rules of the shared experts, and guards that the configurations
sharing the changed code (minicpm3-4b's MLA, jamba's and granite-moe's
MoE) compute bit for bit what they computed before the new fields.
"""
import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import sharding as SH  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMOE  # noqa: E402
from repro_torch.models.common import MLA, MOE, init_params, param_shapes  # noqa: E402
from repro_torch.telemetry import selftrace as ST  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
from perfbench.reference import deepseek_v2 as R  # noqa: E402

B, S, STEPS = 4, 24, 4
# Float32 on both sides: only the order of the sums and the rope table
# (the reference's angles in float64) differ, ~5e-6 on logits of order 1.
# bf16 rounds every product at ~4e-3 relative, ~1e-1 on these logits.
LOGITS_F32 = 1e-4
GUARD = ROOT / "tests" / "data" / "mla_moe_outputs.pt"


def _cfg(dtype=torch.float32, **replace):
    cfg = tconfigs.smoke("deepseek-v2-lite")
    return dataclasses.replace(cfg, n_layers=4, layout=cfg.layout[:4], moe_topk=6,
                               yarn_original_max_pos=8, compute_dtype=dtype, **replace)


def _model_block(cfg) -> dict:
    """The configuration as the reference reads it (the benchmark's ``model`` block)."""
    m = dataclasses.asdict(cfg)
    m["layout"] = [[s.mixer, s.mlp] for s in cfg.layout]
    return m


def _served(cfg, params, prompts):
    """Prefill, then STEPS greedy decode steps through the latent cache ->
    (logits (B, STEPS + 1, vocab) at the prompt's last position and each
    decoded one, the STEPS tokens fed)."""
    logits, cache = TM.prefill(cfg, params, {"tokens": prompts}, max_seq=S + STEPS)
    out, fed = [logits[:, -1]], []
    for _ in range(STEPS):
        nxt = torch.argmax(out[-1][:, :cfg.vocab], dim=-1)[:, None].to(torch.int32)
        fed.append(nxt)
        logits, cache = TM.decode_step(cfg, params, cache, nxt)
        out.append(logits[:, 0])
    assert cache["pos"] == S + STEPS
    return torch.stack(out, dim=1)[..., :cfg.vocab].float(), torch.cat(fed, dim=1)


def _program_and_reference(cfg, seed=3):
    """The program's served logits in cfg's compute dtype, and the float32
    reference's full forward over each prompt and its fed tokens, the
    prompt rows routed together and each decoded position on its own."""
    master = init_params(dataclasses.replace(cfg, compute_dtype=torch.float32), seed, "cpu")
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(seed),
                            dtype=torch.int32)
    got, fed = _served(cfg, TM.compute_params(cfg, master), prompts)
    ref = R.logits(_model_block(cfg), master, torch.cat([prompts, fed], dim=1).long(),
                   STEPS + 1, groups=[list(range(B))], prompt_len=S)
    return got, ref


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])  # 0.5: the experts drop pairs
def test_prefill_and_decode_match_the_reference_in_float32(capacity_factor):
    got, ref = _program_and_reference(_cfg(moe_capacity_factor=capacity_factor))
    assert got.shape == ref.shape == (B, STEPS + 1, 512)
    assert (got - ref).abs().max().item() < LOGITS_F32


def test_the_same_program_in_bfloat16_fails_the_tolerance():
    got, ref = _program_and_reference(_cfg(torch.bfloat16))
    assert (got - ref).abs().max().item() > 10 * LOGITS_F32


@pytest.mark.parametrize("fault", ["renormalised", "no_shared", "no_mscale", "qk_freqs"])
def test_each_deepseek_field_is_seen_by_the_reference(monkeypatch, fault):
    """The program with one DeepSeek behaviour undone misses the reference."""
    cfg = _cfg()
    if fault == "renormalised":
        cfg = dataclasses.replace(cfg, moe_renormalize=True)
    elif fault == "no_shared":
        monkeypatch.setattr(TM, "shared_experts", lambda p, x, c: torch.zeros_like(x))
    elif fault == "no_mscale":
        monkeypatch.setattr(TM, "_mla_scale", lambda c: 1 / math.sqrt(c.qk_dim))
    else:
        cfg = dataclasses.replace(cfg, mla_rope_freqs="qk", yarn_factor=0.0)
    master = init_params(_cfg(), 3, "cpu")
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(3),
                            dtype=torch.int32)
    got, fed = _served(cfg, TM.compute_params(cfg, master), prompts)
    ref = R.logits(_model_block(_cfg()), master, torch.cat([prompts, fed], dim=1).long(),
                   STEPS + 1, groups=[list(range(B))], prompt_len=S)
    assert (got - ref).abs().max().item() > 10 * LOGITS_F32


def test_yarn_at_the_published_sizes():
    cfg = tconfigs.get_config("deepseek-v2-lite")
    m = _model_block(cfg)
    assert L.yarn_range(64, 10000.0, 4096) == R.yarn_range(m) == (10, 23)
    inv = L.yarn_inv_freq(64, 10000.0, 40.0, 4096, torch.device("cpu"))
    extra = 10000.0 ** (-torch.arange(32, dtype=torch.float64) / 32)
    torch.testing.assert_close(inv.double(), R.inv_freq(m), rtol=1e-6, atol=0)
    torch.testing.assert_close(inv[:11].double(), extra[:11], rtol=1e-6, atol=0)  # kept
    torch.testing.assert_close(inv[23:].double(), extra[23:] / 40, rtol=1e-6, atol=0)  # / 40
    assert extra[22] / 40 < inv[15] < extra[15]  # on the ramp
    # cos/sin: mscale(0.707) / mscale(0.707) = 1; the softmax scale 192^-1/2 · m²
    pos = torch.arange(16384)[None]
    cos, sin = TM._rope_cos_sin(cfg, pos)
    assert cos.shape == (1, 16384, 32)
    torch.testing.assert_close(cos, torch.cos(pos[..., None].float() * inv))
    assert L.yarn_mscale(40, 0.707) == pytest.approx(1.26080, abs=1e-5)
    assert TM._mla_scale(cfg) * math.sqrt(192) == pytest.approx(1.58963, abs=1e-5)
    assert TM._mla_scale(cfg) == pytest.approx(R.softmax_scale(m), rel=1e-12)


def test_minicpm3_keeps_its_qk_dim_rope_and_scale():
    cfg = tconfigs.get_config("minicpm3-4b")
    assert (cfg.mla_rope_freqs, cfg.yarn_factor) == ("qk", 0.0)
    assert TM._rope_cos_sin(cfg, torch.arange(4)[None])[0].shape == (1, 4, cfg.qk_dim // 2)
    assert TM._mla_scale(cfg) == 1.0 / math.sqrt(96)


def test_published_configuration_and_parameter_count():
    cfg = tconfigs.get_config("deepseek-v2-lite")
    assert "deepseek_v2_lite" not in tconfigs.ARCHS  # the JAX package has no twin
    assert cfg.n_params() == 15_706_484_224
    shapes = param_shapes(cfg)
    n = sum(math.prod(v) for k, v in shapes.items() if k != "layers")
    n += sum(math.prod(s) for layer in shapes["layers"] for s in layer.values())
    assert n == cfg.n_params()
    assert [s.mixer for s in cfg.layout] == [MLA] * 27 and cfg.n_periods == 1
    assert [s.mlp for s in cfg.layout] == ["dense"] + [MOE] * 26
    first, moe = shapes["layers"][0], shapes["layers"][1]
    assert first["wq"] == (1, 2048, 16 * 192) and "wdq" not in first and "q_ln" not in first
    assert first["w_gate"] == (1, 2048, 10944)
    assert moe["moe_gate"] == (1, 64, 2048, 1408) and moe["shared_gate"] == (1, 2048, 2816)


def test_shared_experts_are_added_beside_the_routed_ones():
    cfg = _cfg()
    p = {k: v[0] for k, v in init_params(cfg, 5, "cpu")["layers"][1].items()}
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator().manual_seed(5))
    out = TM._mlp_apply(cfg, cfg.layout[1], p, x)
    torch.testing.assert_close(out, TMOE.moe_block(p, x, cfg) + TMOE.shared_experts(p, x, cfg),
                               rtol=0, atol=0)
    renorm = TMOE.moe_local(p, x, dataclasses.replace(cfg, moe_renormalize=True), 0)
    assert not torch.allclose(renorm, TMOE.moe_local(p, x, cfg, 0))


def test_shared_experts_are_placed_as_the_dense_mlp():
    for dense, shared in (("w_gate", "shared_gate"), ("w_up", "shared_up"),
                          ("w_down", "shared_down")):
        shape = (1, 2048, 2816) if dense != "w_down" else (1, 2816, 2048)
        for fsdp in (True, False):
            assert SH.param_pspec(shared, shape, 4, ("data",), 2, True, fsdp) == \
                SH.param_pspec(dense, shape, 4, ("data",), 2, True, fsdp)


def test_prefill_records_the_mla_and_shared_expert_spans_and_the_pairs():
    cfg = _cfg(torch.bfloat16)
    params = TM.compute_params(cfg, init_params(cfg, 0, "cpu"))
    tracer = ST.get_self_tracer()
    was = tracer.enabled
    tracer.drain()
    tracer.set_enabled(True)
    try:
        TM.prefill(cfg, params, {"tokens": torch.zeros((B, S), dtype=torch.int32)})
        spans = tracer.snapshot()
    finally:
        tracer.set_enabled(was)
        tracer.drain()
    names = {s.id: s.name for s in spans}
    under = [(s.name, names.get(s.parent)) for s in spans]
    assert under.count(("mla/prefill", "model/prefill")) == cfg.n_layers
    assert under.count(("moe/shared", "model/prefill")) == cfg.n_layers - 1
    moe = [s for s in spans if s.name == "moe"]
    assert len(moe) == cfg.n_layers - 1
    assert all(s.args["pairs"] == B * S * cfg.moe_topk >= s.args["kept"] for s in moe)


MESH_SCRIPT = r"""
import dataclasses, sys
import torch, torch.distributed as dist
from repro_torch import compat, configs
from repro_torch.launch import steps as TS
from repro_torch.models import model as M
from repro_torch.models.common import init_params

rank, init, out, B, S = int(sys.argv[1]), sys.argv[2], sys.argv[3], 4, 24
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=2)
mesh = compat.make_mesh((1, 2), ("data", "model"), device="cpu")
cfg = configs.smoke("deepseek-v2-lite")
cfg = dataclasses.replace(cfg, n_layers=4, layout=cfg.layout[:4], moe_topk=6,
                          yarn_original_max_pos=8, compute_dtype=torch.float32)
params = M.compute_params(cfg, init_params(cfg, 3, "cpu"))
tokens = torch.randint(0, cfg.vocab, (B, S), generator=torch.Generator().manual_seed(3),
                       dtype=torch.int32)
got = {}
with torch.no_grad():
    one, cache = M.prefill(cfg, params, {"tokens": tokens}, max_seq=S + 1)
    nxt = torch.argmax(one[:, -1, :cfg.vocab], -1)[:, None].to(torch.int32)
    got["one"] = torch.cat([one[:, -1], M.decode_step(cfg, params, cache, nxt)[0][:, 0]])
    for seq_shard in (False, True):
        ctx = TS.make_shard_ctx(cfg, mesh, B, TS.StepOptions(remat="none", seq_shard=seq_shard))
        assert ctx.ep_info(cfg) is not None  # 4 of the 8 experts a rank
        local = M.local_params(cfg, params, ctx)
        first, cache = M.prefill(cfg, local, {"tokens": tokens}, ctx, max_seq=S + 1)
        got[f"mesh{int(seq_shard)}"] = torch.cat(
            [first[:, -1], M.decode_step(cfg, local, cache, nxt, ctx)[0][:, 0]])
torch.save(got, f"{out}/r{rank}.pt")
"""


def test_shared_experts_count_once_under_expert_parallelism(tmp_path):
    """On a (1, 2) mesh each rank holds 4 of the 8 experts and the routed
    output is summed over the model axis; the shared experts are added
    after that sum, so the meshed prefill and decode step (hidden state
    whole or sequence-sharded) equal one device's, in float32, up to the
    order of the sum.  Two gloo processes."""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(ROOT / "src"),
                                                        os.environ.get("PYTHONPATH", "")])}
    procs = [subprocess.Popen([sys.executable, "-c", MESH_SCRIPT, str(r), str(tmp_path / "pg"),
                               str(tmp_path)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    for r in range(2):
        got = torch.load(tmp_path / f"r{r}.pt")
        for key in ("mesh0", "mesh1"):
            torch.testing.assert_close(got[key], got["one"], rtol=1e-5, atol=1e-5)


def _guard_outputs():
    """jamba's and granite-moe's ``moe_local`` on one MoE layer, and
    minicpm3-4b's forward, prefill and four decode steps, in bf16 at their
    smoke sizes; tests/data/mla_moe_outputs.pt holds what the port computed
    before the DeepSeek-V2 fields."""
    out = {}
    for arch, pos in (("jamba-v0.1-52b", 1), ("granite-moe-1b-a400m", 0)):
        cfg = tconfigs.smoke(arch)
        params = TM.compute_params(cfg, init_params(cfg, 0, "cpu"))
        p = {k: v[0] for k, v in params["layers"][pos].items()}
        x = torch.randn((2, 24, cfg.d_model), generator=torch.Generator().manual_seed(1))
        out[arch + "/moe_local"] = TMOE.moe_local(p, x.to(cfg.compute_dtype), cfg, 0)
    cfg = tconfigs.smoke("minicpm3-4b")
    params = TM.compute_params(cfg, init_params(cfg, 0, "cpu"))
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)
    out["minicpm3-4b/forward"] = TM.forward(cfg, params, {"tokens": toks})
    logits, cache = TM.prefill(cfg, params, {"tokens": toks[:, :12]}, max_seq=16)
    out["minicpm3-4b/prefill"] = logits
    for i in range(12, 16):
        logits, cache = TM.decode_step(cfg, params, cache, toks[:, i:i + 1])
        out[f"minicpm3-4b/decode{i}"] = logits
    return out


def test_shared_code_computes_bit_for_bit_what_it_did():
    before = torch.load(GUARD)
    now = _guard_outputs()
    assert sorted(now) == sorted(before)
    for key, t in now.items():
        assert t.dtype == before[key].dtype and torch.equal(t, before[key]), key
