"""The self-tracer's spans inside the port (``repro_torch.telemetry.selftrace``), on the CPU.

When it records (self-tracing on, or a ``torch.profiler`` recording), what
each span holds and its parent, the profiler ranges it opens, the counts
the MoE span carries, the buffer's bound; that the model's outputs do not
depend on it; and that the benchmark's device reduction keeps the
program's ranges out of its kernels.  The card's device timing is the
``cuda``-marked test at the end.
"""
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, schedule  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.telemetry import selftrace as ST  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PROGRAM = {"model/prefill", "model/decode_step", "mamba/prefill", "mamba/stage", "moe",
           "mamba/decode", "attention/decode", "monitor/record_step_times"}


@pytest.fixture
def recorder():
    """The process's recorder, empty and off before and after the test."""
    tracer = ST.get_self_tracer()
    was = tracer.enabled
    tracer.set_enabled(False)
    tracer.drain()
    yield tracer
    tracer.set_enabled(was)
    tracer.drain()


def _tiny(arch: str):
    cfg = configs.smoke(arch)
    params = M.compute_params(cfg, common.init_params(cfg, 0, "cpu"))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
                              .astype(np.int32))
    return cfg, params, tokens


def _serve_steps(cfg, params, tokens, steps: int = 2):
    """prefill, then ``steps`` greedy decode steps -> (every logits, the cache)."""
    logits, cache = M.prefill(cfg, params, {"tokens": tokens}, max_seq=tokens.shape[1] + steps)
    out = [logits]
    for _ in range(steps):
        nxt = torch.argmax(out[-1][:, -1], dim=-1)[:, None].to(torch.int32)
        logits, cache = M.decode_step(cfg, params, cache, nxt)
        out.append(logits)
    return out, cache


def test_the_off_path_records_nothing_and_returns_the_shared_noop(recorder):
    assert not recorder.recording
    ctx = recorder.span("model/prefill", timed_on=torch.zeros(1))
    assert ctx is ST._NULL and not ctx
    with recorder.span("moe") as span:
        assert span is ST._NULL
        span.set(kept=1)
    recorder.record("ingest:ad", 0, 1)
    cfg, params, tokens = _tiny("jamba-v0.1-52b")
    _serve_steps(cfg, params, tokens)
    assert len(recorder) == 0 and recorder.snapshot() == []
    # the off path keeps nothing: the interpreter's block count stays put
    site = recorder.span
    before = sys.getallocatedblocks()
    for _ in range(20000):
        with site("mamba/decode"):
            pass
    assert sys.getallocatedblocks() - before < 20


def test_self_tracing_records_name_thread_clock_parent_and_args(recorder):
    recorder.set_enabled(True)
    with recorder.span("outer") as outer:
        outer.set(ids=[1, 2])
        with recorder.span("inner") as inner:
            inner.set(kept=torch.tensor(3))
        recorder.record("ingest:ad", ST._now_us(), 5)
    got = {s.name: s for s in recorder.snapshot()}
    assert [s.name for s in recorder.snapshot()] == ["inner", "ingest:ad", "outer"]
    o, i, r = got["outer"], got["inner"], got["ingest:ad"]
    assert o.parent == 0 and i.parent == o.id and r.parent == o.id
    assert len({o.id, i.id, r.id}) == 3 and o.tid == i.tid
    assert o.t0_us <= i.t0_us and i.t0_us + i.dur_us <= o.t0_us + o.dur_us
    assert i.args == {"kept": 3} and isinstance(i.args["kept"], int)
    assert o.args == {"ids": [1, 2]} and o.device_ms is None  # CPU: host-timed only
    assert len(recorder) == 3  # snapshot keeps them
    drained = recorder.drain()
    assert [d[0] for d in drained] == ["inner", "ingest:ad", "outer"]
    assert drained[0][4] == {"kept": 3} and len(recorder) == 0


def test_the_buffer_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(ST, "MAX_SPANS", 4)
    tracer = ST.SelfTracer(enabled=True)
    for n in range(10):
        with tracer.span(f"s{n}"):
            pass
    assert len(tracer) == 4 and tracer.dropped == 6
    assert [s.name for s in tracer.snapshot()] == ["s6", "s7", "s8", "s9"]


def test_a_recording_profiler_turns_the_recorder_on(recorder):
    """Off, but a profiler records: the spans record, each as a profiler
    range nested as the spans are."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert recorder.recording
        with recorder.span("outer"):
            with recorder.span("inner"):
                torch.ones(4).sum()
    assert not recorder.recording
    spans = recorder.snapshot()
    assert [s.name for s in spans] == ["inner", "outer"]
    inner = next(e for e in prof.events() if e.name == "inner")
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "outer"


def _program_parent(e):
    p = e.cpu_parent
    while p is not None and p.name not in PROGRAM:
        p = p.cpu_parent
    return p.name if p is not None else None


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_every_span_is_a_profiler_range_with_its_parent(recorder, arch):
    cfg, params, tokens = _tiny(arch)
    _serve_steps(cfg, params, tokens)  # warm
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve_steps(cfg, params, tokens)
    spans = recorder.snapshot()
    names = {s.id: s.name for s in spans}
    want = Counter((s.name, names.get(s.parent)) for s in spans)
    ranges = [e for e in prof.events() if e.name in PROGRAM]
    assert Counter((e.name, _program_parent(e)) for e in ranges) == want
    n_mamba = sum(spec.mixer == common.MAMBA for spec in cfg.layout) * cfg.n_layers // cfg.period
    assert want[("mamba/prefill", "model/prefill")] == n_mamba
    assert want[("mamba/stage", "mamba/prefill")] == n_mamba
    assert want[("mamba/decode", "model/decode_step")] == 2 * n_mamba
    assert want[("model/decode_step", None)] == 2 and want[("model/prefill", None)] == 1
    if arch.startswith("jamba"):
        n_moe = sum(spec.mlp == common.MOE for spec in cfg.layout) * cfg.n_layers // cfg.period
        assert want[("moe", "model/prefill")] == n_moe
        assert want[("moe", "model/decode_step")] == 2 * n_moe
        assert want[("attention/decode", "model/decode_step")] > 0


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "jamba-v0.1-52b"])
def test_logits_and_caches_do_not_depend_on_the_recorder(recorder, arch):
    cfg, params, tokens = _tiny(arch)
    off, cache_off = _serve_steps(cfg, params, tokens)
    recorder.set_enabled(True)
    on, cache_on = _serve_steps(cfg, params, tokens)
    assert len(recorder) > 0
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert cache_off["pos"] == cache_on["pos"]
    for lo, ln in zip(cache_off["layers"], cache_on["layers"]):
        assert lo.keys() == ln.keys()
        assert all(torch.equal(lo[k], ln[k]) for k in lo)


@pytest.mark.parametrize("n_shards,rank", [(1, 0), (2, 1)])
def test_moe_counts_equal_a_direct_count_of_the_routing(recorder, n_shards, rank):
    cfg = configs.smoke("jamba-v0.1-52b")
    E, k = cfg.moe_experts, cfg.moe_topk
    g = torch.Generator().manual_seed(3)
    D, F = cfg.d_model, cfg.moe_dff
    p = {"router": torch.randn(D, E, generator=g),
         "moe_gate": torch.randn(E, D, F, generator=g) * 0.1,
         "moe_up": torch.randn(E, D, F, generator=g) * 0.1,
         "moe_down": torch.randn(E, F, D, generator=g) * 0.1}
    x = torch.randn(3, 40, D, generator=g) + 0.5 * p["router"][:, 0]  # expert 0 overfull
    e_loc = E // n_shards
    local = {**p, **{key: p[key][rank * e_loc:(rank + 1) * e_loc] for key in MOE.EXPERT_KEYS}}
    recorder.set_enabled(True)
    MOE.moe_local(local, x, cfg, rank * e_loc)
    (span,) = recorder.snapshot()
    N = 3 * 40
    C = MOE.capacity(cfg, N)
    _, _, ids = MOE._route(p, x.reshape(N, D), k)
    load = torch.bincount(ids.reshape(-1), minlength=E)[rank * e_loc:(rank + 1) * e_loc]
    assert span.name == "moe"
    assert span.args == {"kept": int(torch.clamp(load, max=C).sum()), "slots": e_loc * C,
                         "pairs": int(load.sum())}  # the pairs routed to the rank's experts
    assert n_shards > 1 or span.args["pairs"] == N * k
    full = torch.bincount(ids.reshape(-1), minlength=E)
    assert full[0] > C and (load < C).any()  # the cut drops pairs; not every slot is filled


def test_serve_takes_prompts_and_reports_per_request_times(recorder):
    prompts = np.random.default_rng(2).integers(0, 256, (3, 10))
    recorder.set_enabled(True)
    out = tserve.serve(arch="falcon-mamba-7b", batch=2, max_new=3, device="cpu",
                       prompts=prompts)
    assert out["requests"] == 3 and out["tokens"] == 9
    rows = out["per_request"]
    assert [r["rid"] for r in rows] == [0, 1, 2]
    for r in rows:
        assert 0 <= r["queued_s"] <= r["first_token_s"] <= r["done_s"]
    assert rows[0]["queued_s"] == rows[1]["queued_s"] < rows[2]["queued_s"]
    assert rows[1]["done_s"] <= rows[2]["queued_s"]
    names = [s.name for s in recorder.snapshot()]
    assert names.count("model/prefill") == 2 and names.count("model/decode_step") == 2 * 3
    with pytest.raises(ValueError, match="prompts"):
        tserve.serve(arch="falcon-mamba-7b", device="cpu", prompts=np.zeros(4, np.int64))


class _Event:
    """The fields of a profiler event that ``reduce_events`` reads."""

    def __init__(self, name, device, start, end, annotation=False):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.is_user_annotation = annotation
        self.time_range = type("R", (), {"start": start, "end": end})()


def test_the_device_reduction_lists_no_program_range_among_the_kernels():
    """As the card's trace gives them: each program range is a CPU event
    and a GPU user annotation; neither is a kernel, busy time or a host range."""
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import profile as PR

    ev = [_Event("ProfilerStep#1", False, 0, 100), _Event("bench/decode_step", False, 10, 90)]
    for name, (s, t) in {"model/decode_step": (12, 40), "mamba/decode": (14, 20),
                         "moe": (22, 30)}.items():
        ev += [_Event(name, False, s, t), _Event(name, True, s + 1, t + 30, annotation=True)]
    ev += [_Event("gemv_kernel", True, 50, 60), _Event("elementwise_kernel", True, 70, 75)]
    trace = PR.reduce_events(ev)
    assert set(trace.by_kernel) == {"gemv_kernel", "elementwise_kernel"}
    assert trace.busy_s == pytest.approx(15e-6)
    assert set(trace.idle_by_range) <= set(PR.HOST_RANGES) | {PR.OUTSIDE}
    assert [name for name, _ in trace.device_ops()] == ["gemv_kernel", "elementwise_kernel"]


@pytest.mark.cuda
def test_prefill_spans_are_device_timed_on_the_card(recorder):
    """On CUDA tensors: model/prefill and the spans under it carry device
    ms, decode spans none; under the profiler each program range's GPU
    annotation is flagged, so the benchmark's reduction leaves it out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    from perfbench.harness import profile as PR

    cfg = configs.smoke("jamba-v0.1-52b")
    params = M.compute_params(cfg, common.init_params(cfg, 0, "cuda"))
    tokens = torch.randint(0, cfg.vocab, (2, 64), dtype=torch.int32, device="cuda")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        for _ in range(2):  # the warm-up step records no span
            _serve_steps(cfg, params, tokens)
            torch.cuda.synchronize()
            prof.step()
    spans = recorder.snapshot()
    by_id = {s.id: s for s in spans}

    def in_prefill(s):
        while s.name != "model/prefill" and s.parent in by_id:
            s = by_id[s.parent]
        return s.name == "model/prefill"

    assert Counter(s.name for s in spans)["model/prefill"] == 1
    for s in spans:
        assert (s.device_ms is not None) == in_prefill(s), s
        assert s.device_ms is None or s.device_ms > 0
    stage = [s for s in spans if s.name == "mamba/stage"]
    assert stage and all(s.device_ms <= by_id[s.parent].device_ms for s in stage)
    trace = PR.reduce_events(prof.events())
    assert trace.by_kernel and not set(trace.by_kernel) & PROGRAM
    assert not any(PR._is_device(e) for e in prof.events() if e.name in PROGRAM)
