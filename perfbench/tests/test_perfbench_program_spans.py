"""The readers of the program's spans, on made-up spans, on a program
that records none (the parent of the change that added the spans) and on
the tiny traced Jamba cell."""
from __future__ import annotations

import types

import pytest

from conftest import run_tiny
from perfbench.harness import program_spans
from perfbench.harness import spec as SP

NEW = ("mamba_stage_ms", "mamba_prefill_ms", "moe_prefill_ms", "moe_slot_fill",
       "decode_dispatch_ms")


def _span(name, id, parent, t0_us, dur_us=1000, device_ms=None, **args):
    return types.SimpleNamespace(name=name, id=id, parent=parent, t0_us=t0_us, dur_us=dur_us,
                                 device_ms=device_ms, args=args)


def _with_spans(monkeypatch, spans):
    from repro_torch.telemetry import selftrace

    tracer = types.SimpleNamespace(snapshot=lambda: list(spans))
    monkeypatch.setattr(selftrace, "get_self_tracer", lambda: tracer)


RUN = types.SimpleNamespace(t_close=1.0)  # the window closed at 1 s: spans from 1e6 µs on


def test_the_readers_find_nothing_in_a_program_without_the_recorder(monkeypatch):
    from repro_torch.telemetry import selftrace

    monkeypatch.setattr(selftrace, "get_self_tracer", lambda: types.SimpleNamespace())
    assert [SP.metric_reader(m).read(RUN) for m in NEW] == [None] * 5
    _with_spans(monkeypatch, [])
    assert [SP.metric_reader(m).read(RUN) for m in NEW] == [None] * 5


def test_the_readers_arithmetic(monkeypatch):
    spans = [_span("model/prefill", 1, 0, 10, device_ms=1.0)]  # before the window closed
    for w, t0 in ((0, 2_000_000), (1, 3_000_000)):  # two traced waves
        base = 100 * (w + 1)
        spans += [_span("model/prefill", base, 0, t0, device_ms=50.0),
                  _span("mamba/prefill", base + 1, base, t0 + 1, device_ms=20.0),
                  _span("mamba/stage", base + 2, base + 1, t0 + 2, device_ms=8.0 + w),
                  _span("moe", base + 3, base, t0 + 3, device_ms=5.0, pairs=16, kept=12,
                        slots=20)]
        spans += [_span("model/decode_step", base + 10 + i, 0, t0 + 100 + i, dur_us=d)
                  for i, d in enumerate((3000, 1000, 2000))]
        spans += [_span("moe", base + 20, base + 10, t0 + 101, pairs=4, kept=4, slots=64)]
    _with_spans(monkeypatch, spans)
    read = {m: SP.metric_reader(m).read(RUN) for m in NEW}
    assert read["mamba_stage_ms"] == pytest.approx(8.5)
    assert read["mamba_prefill_ms"] == pytest.approx(20.0)
    assert read["moe_prefill_ms"] == pytest.approx(5.0)
    assert read["moe_slot_fill"] == pytest.approx(60.0)  # decode's moe spans left out
    assert read["decode_dispatch_ms"] == pytest.approx(3.0)  # nearest rank of 6 steps


def test_the_readers_find_nothing_where_the_prefills_were_not_timed_on_a_card(monkeypatch):
    spans = [_span("model/prefill", 1, 0, 2_000_000),
             _span("moe", 2, 1, 2_000_001, kept=12, slots=20),
             _span("model/decode_step", 3, 0, 2_000_100, dur_us=3000)]
    _with_spans(monkeypatch, spans)
    assert [SP.metric_reader(m).read(RUN) for m in NEW] == [None] * 5


def test_the_tiny_traced_jamba_cell_leaves_them_out_on_the_cpu(bench_root):
    res = run_tiny(bench_root, "tiny-jamba.tiny", trace=True)
    assert res["correct"] is True
    assert not set(NEW) & set(res["metrics"])


def test_the_tiny_traced_jamba_cell_reports_its_span_counts_and_host_times(bench_root,
                                                                          monkeypatch):
    # past the card's gate, the CPU's spans give the metrics that need no device time
    monkeypatch.setattr(program_spans, "_on_card", lambda spans_: True)
    res = run_tiny(bench_root, "tiny-jamba.tiny", trace=True)
    assert res["correct"] is True
    got = res["metrics"]
    assert {"moe_slot_fill", "decode_dispatch_ms"} <= set(got)
    assert not {"mamba_stage_ms", "mamba_prefill_ms", "moe_prefill_ms"} & set(got)
    assert 0 < got["moe_slot_fill"]["value"] <= 100 and got["decode_dispatch_ms"]["value"] > 0
