"""The decode step's CUDA graph (``launch.steps.DecodeGraph``), on the card.

Tiny falcon-mamba, Jamba and DeepSeek-V2-Lite configurations, and the smoke
configurations of every other one-card serve path (gemma-2b, granite-moe's
GQA with MoE, minicpm3's MLA with a query latent, qwen2-vl's M-RoPE,
gemma2's SWA ring past its window and soft-capping), served through
``build_decode_step`` for two waves of one shape, each from its own
prefill, then a wave of another batch.  Against the eager
``models.model.decode_step`` in lockstep on a copy of each wave's cache:
the replayed logits equal the eager ones bit for bit, each step's logits
are a tensor of their own that later replays leave alone, a shape is
captured once and a new shape once more, and the step's span carries
``graphed`` 1 with no per-layer decode span under it.  Two sequences of
one shape stepped in turn are refused.  Marked ``cuda``:
skipped without a card.  Imports no JAX.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.common import init_params  # noqa: E402
from repro_torch.telemetry import selftrace as ST  # noqa: E402

S, STEPS = 30, 7  # positions 30..36 cross gemma2's smoke window of 32
ARCHS = ("falcon-mamba-7b", "jamba-v0.1-52b", "deepseek-v2-lite", "gemma-2b",
         "granite-moe-1b-a400m", "minicpm3-4b", "qwen2-vl-2b", "gemma2-2b")


def _config(arch: str):
    cfg = configs.smoke(arch)
    if arch == "deepseek-v2-lite":
        cfg = dataclasses.replace(cfg, n_layers=4, layout=cfg.layout[:4],
                                  yarn_original_max_pos=8)
    return cfg


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture
def recorder():
    tracer = ST.get_self_tracer()
    was = tracer.enabled
    tracer.drain()
    tracer.set_enabled(True)
    yield tracer
    tracer.set_enabled(was)
    tracer.drain()


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_replays_equal_the_eager_step_and_keep_their_logits(card, recorder, monkeypatch, arch):
    captures = []

    class Counted(TS.DecodeGraph):
        def __init__(self, *a, **kw):
            captures.append(a[3]["layers"][0][next(iter(a[3]["layers"][0]))].shape)
            super().__init__(*a, **kw)

    monkeypatch.setattr(TS, "DecodeGraph", Counted)
    cfg = _config(arch)
    params = M.compute_params(cfg, init_params(cfg, 0, card))
    step = TS.build_decode_step(cfg, M.ShardCtx(), TS.StepOptions())
    g = torch.Generator(device=card).manual_seed(1)
    worst = 0.0
    for wave, batch in enumerate((4, 4, 2)):
        prompts = torch.randint(0, cfg.vocab, (batch, S), generator=g, device=card,
                                dtype=torch.int32)
        logits, cache = M.prefill(cfg, params, {"tokens": prompts}, max_seq=S + STEPS + 1)
        eager = {**cache, "layers": [{k: t.clone() for k, t in layer.items()}
                                     for layer in cache["layers"]]}
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        kept, copies = [], []
        for _ in range(STEPS):
            got, cache = step(params, cache, nxt)
            want, eager = M.decode_step(cfg, params, eager, nxt)
            worst = max(worst, float((got - want).abs().max()))
            assert cache["pos"] == eager["pos"] and isinstance(cache["pos"], int)
            kept.append(got)
            copies.append(got.clone())
            nxt = torch.argmax(want[:, 0], dim=-1)[:, None].to(torch.int32)
        assert len({t.data_ptr() for t in kept}) == STEPS
        assert all(torch.equal(a, b) for a, b in zip(kept, copies)), (arch, wave)
        assert not torch.equal(kept[0], kept[-1])
    assert worst == 0.0, f"{arch}: replayed logits differ from the eager step's by {worst}"
    assert len(captures) == 2 and captures[0][1] == 4 and captures[1][1] == 2
    spans = recorder.snapshot()
    steps = [s for s in spans if s.name == "model/decode_step"]
    graphed = [s for s in steps if s.args == {"graphed": 1}]
    assert len(graphed) == 3 * STEPS
    assert len(steps) - len(graphed) == 3 * STEPS  # the eager twin's, graphed 0
    under = {s.parent for s in spans if s.name in ("mamba/decode", "attention/decode", "moe")}
    assert not under & {s.id for s in graphed}


@pytest.mark.cuda
def test_new_weights_are_captured_anew(card):
    cfg = _config("falcon-mamba-7b")
    step = TS.build_decode_step(cfg, M.ShardCtx(), TS.StepOptions())
    prompts = torch.randint(0, cfg.vocab, (2, S), device=card, dtype=torch.int32)
    out = []
    for seed in (0, 1):
        params = M.compute_params(cfg, init_params(cfg, seed, card))
        logits, cache = M.prefill(cfg, params, {"tokens": prompts}, max_seq=S + 2)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        got, _ = step(params, cache, nxt)
        want, _ = M.decode_step(cfg, params, M.prefill(cfg, params, {"tokens": prompts},
                                                       max_seq=S + 2)[1], nxt)
        assert torch.equal(got, want)
        out.append(got)
    assert not torch.equal(out[0], out[1])


@pytest.mark.cuda
def test_two_sequences_stepped_in_turn_are_refused(card):
    cfg = _config("jamba-v0.1-52b")
    params = M.compute_params(cfg, init_params(cfg, 0, card))
    step = TS.build_decode_step(cfg, M.ShardCtx(), TS.StepOptions())
    caches, nxt = [], None
    for seed in (1, 2):
        g = torch.Generator(device=card).manual_seed(seed)
        prompts = torch.randint(0, cfg.vocab, (2, S), generator=g, device=card,
                                dtype=torch.int32)
        logits, cache = M.prefill(cfg, params, {"tokens": prompts}, max_seq=S + 4)
        nxt = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
        caches.append(step(params, cache, nxt)[1])
    with pytest.raises(ValueError, match="another sequence"):
        step(params, caches[0], nxt)
    _, after = step(params, caches[1], nxt)  # the last sequence steps on
    assert after["pos"] == S + 2
    with pytest.raises(ValueError, match="another sequence"):
        step(params, caches[1], nxt)  # a cache already stepped
