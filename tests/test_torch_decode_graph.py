"""The decode step's device position and its routing, on the CPU.

``models.model.decode_step`` takes the cache's ``pos`` as a host int or,
on one device, as a 0-d tensor that a CUDA graph fills before each replay
(``launch.steps.DecodeGraph``).  Here: the tensor position gives the host
int's logits and caches bit for bit over several steps, for every mixer
kind (GQA with MoE, the SWA ring past its window, MLA absorbed with and
without a query latent, Mamba, M-RoPE, the Jamba hybrid); the step that
``build_decode_step`` returns stays eager on the CPU and on meta tensors;
and a graph's call, with a stand-in for the graph, copies a new sequence's
cache in and refuses a cache that holds its state for another sequence.
The graph itself runs on the card: ``test_torch_decode_graph_cuda.py``.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.telemetry import selftrace as ST  # noqa: E402

B, S, STEPS = 2, 30, 6  # positions 30..35 cross the smoke window of 32


def _config(arch: str):
    cfg = configs.smoke(arch)
    if arch == "deepseek-v2-lite":  # one dense and three MoE layers, YaRN's ramp inside S
        cfg = dataclasses.replace(cfg, n_layers=4, layout=cfg.layout[:4],
                                  yarn_original_max_pos=8)
    return cfg


MIXERS = {"gqa_moe": "granite-moe-1b-a400m", "swa_ring": "gemma2-2b",
          "mla_no_q_latent": "deepseek-v2-lite", "mla_q_latent": "minicpm3-4b",
          "mamba": "falcon-mamba-7b", "mrope": "qwen2-vl-2b", "hybrid": "jamba-v0.1-52b"}


def _prefilled(arch: str, seed: int = 0):
    cfg = _config(arch)
    params = M.compute_params(cfg, init_params(cfg, seed, "cpu"))
    prompts = torch.from_numpy(np.random.default_rng(seed + 1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    logits, cache = M.prefill(cfg, params, {"tokens": prompts}, max_seq=S + STEPS)
    return cfg, params, logits, cache


def _copy(cache, pos):
    return {**cache, "pos": pos,
            "layers": [{k: t.clone() for k, t in layer.items()} for layer in cache["layers"]]}


@pytest.mark.parametrize("kind", sorted(MIXERS))
def test_a_device_position_decodes_as_the_host_int_bit_for_bit(kind):
    cfg, params, logits, cache = _prefilled(MIXERS[kind])
    host = _copy(cache, S)
    dev = _copy(cache, torch.tensor(S))
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    for step in range(STEPS):
        want, host = M.decode_step(cfg, params, host, nxt)
        got, dev = M.decode_step(cfg, params, dev, nxt)
        assert torch.equal(got, want), (kind, step)
        assert isinstance(dev["pos"], torch.Tensor) and int(dev["pos"]) == host["pos"]
        nxt = torch.argmax(want[:, 0], dim=-1)[:, None].to(torch.int32)
    assert host["pos"] == S + STEPS
    for lh, ld in zip(host["layers"], dev["layers"]):
        assert lh.keys() == ld.keys()
        assert all(torch.equal(lh[k], ld[k]) for k in lh), kind


def test_the_swa_ring_wraps_inside_the_steps():
    cfg, _, _, cache = _prefilled("gemma2-2b")
    slots = {tuple(layer["kpos"].shape) for layer in cache["layers"]}
    NP = cfg.n_periods
    assert slots == {(NP, cfg.window), (NP, S + STEPS)} and S < cfg.window < S + STEPS


def test_a_device_position_on_a_mesh_is_refused():
    cfg, params, logits, cache = _prefilled("gemma-2b")
    ctx = dataclasses.replace(M.ShardCtx(), mesh=object())
    with pytest.raises(ValueError, match="host int"):
        M.decode_step(cfg, params, _copy(cache, torch.tensor(S)), logits[:, -1:, 0].int(), ctx)


@pytest.fixture
def recorder():
    tracer = ST.get_self_tracer()
    was = tracer.enabled
    tracer.drain()
    tracer.set_enabled(True)
    yield tracer
    tracer.set_enabled(was)
    tracer.drain()


def _no_graphs(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA graph was built off the card")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(TS, "DecodeGraph", refuse)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b", "deepseek-v2-lite"])
def test_build_decode_step_stays_eager_on_the_cpu(monkeypatch, recorder, arch):
    _no_graphs(monkeypatch)
    cfg, params, logits, cache = _prefilled(arch)
    step = TS.build_decode_step(cfg, TS.make_shard_ctx(cfg, None, B, TS.StepOptions()),
                                TS.StepOptions())
    eager = _copy(cache, S)
    nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    kept = []
    for _ in range(3):
        got, cache = step(params, cache, nxt)
        want, eager = M.decode_step(cfg, params, eager, nxt)
        assert torch.equal(got, want) and cache["pos"] == eager["pos"]
        assert isinstance(cache["pos"], int)
        kept.append(got)
        nxt = torch.argmax(got[:, 0], dim=-1)[:, None].to(torch.int32)
    assert len({t.data_ptr() for t in kept}) == 3
    steps = [s for s in recorder.snapshot() if s.name == "model/decode_step"]
    assert len(steps) == 6 and all(s.args == {"graphed": 0} for s in steps)
    names = {s.name for s in recorder.snapshot()}
    assert "mamba/decode" in names if arch != "deepseek-v2-lite" else "attention/decode" in names


def test_build_decode_step_stays_eager_on_meta_tensors(monkeypatch):
    _no_graphs(monkeypatch)
    cfg = _config("jamba-v0.1-52b")
    params = M.compute_params(cfg, TS.meta_params(cfg))
    cache = M.init_cache(cfg, B, S + STEPS, device="meta")
    step = TS.build_decode_step(cfg, M.ShardCtx(), TS.StepOptions())
    logits, cache = step(params, cache, torch.empty((B, 1), dtype=torch.int32, device="meta"))
    assert logits.device.type == "meta" and logits.shape == (B, 1, cfg.vocab_padded)
    assert cache["pos"] == 1


def test_the_tracer_records_nothing_while_paused(recorder):
    with recorder.paused():
        assert not recorder.recording
        with recorder.span("model/decode_step") as span:
            assert span is ST._NULL
        recorder.record("ingest:ad", 0, 1)
        with recorder.paused():
            pass
        assert not recorder.recording
    assert recorder.recording
    with recorder.span("moe"):
        pass
    assert [s.name for s in recorder.snapshot()] == ["moe"]


def test_a_graph_refuses_its_cache_stepped_for_another_sequence():
    graph = object.__new__(TS.DecodeGraph)  # the call's bookkeeping, without a capture
    graph.slots, graph.returned, graph.next_pos = None, None, None
    graph.layers = [{"h": torch.zeros(1, B, 4)}]
    graph.tokens = torch.zeros((B, 1), dtype=torch.int32)
    graph.pos = torch.zeros((), dtype=torch.int64)
    graph.logits = torch.zeros((B, 1, 8))
    graph.graph = types.SimpleNamespace(replay=lambda: graph.logits.add_(graph.pos))
    tokens = torch.ones((B, 1), dtype=torch.int32)
    a = {"pos": S, "layers": [{"h": torch.ones(1, B, 4)}]}
    b = {"pos": S, "layers": [{"h": torch.full((1, B, 4), 2.0)}]}
    logits_a, a1 = graph(a, tokens)
    assert a1["layers"] is graph.layers and a1["pos"] == S + 1
    assert torch.equal(graph.layers[0]["h"], a["layers"][0]["h"])
    assert torch.equal(graph.tokens, tokens) and int(graph.pos) == S
    graph.layers[0]["h"].add_(5)  # the replay's writes: kept, not copied over
    logits_a2, a2 = graph(a1, tokens)
    assert torch.equal(graph.layers[0]["h"], torch.full((1, B, 4), 6.0))
    assert logits_a.data_ptr() != logits_a2.data_ptr() and not torch.equal(logits_a, logits_a2)
    _, b1 = graph(b, tokens)  # a new sequence of the shape: copied in
    assert torch.equal(graph.layers[0]["h"], b["layers"][0]["h"])
    for stale in (a2, a1, {**b1}, {**b1, "pos": S + 5}):
        with pytest.raises(ValueError, match="another sequence"):
            graph(stale, tokens)
    _, b2 = graph(b1, tokens)
    assert b2["pos"] == S + 2 and int(graph.pos) == S + 1
