"""The reader of ``decode_graph_share`` on made-up spans: none carrying the
``graphed`` arg (a program whose decode steps run eagerly), a mix, and every
step replayed; nothing where the program recorded no spans on a card."""
from __future__ import annotations

import types

import pytest

from perfbench.harness import spec as SP

RUN = types.SimpleNamespace(t_close=1.0)  # the window closed at 1 s: spans from 1e6 µs on


def _span(name, id, parent, t0_us, device_ms=None, **args):
    return types.SimpleNamespace(name=name, id=id, parent=parent, t0_us=t0_us, dur_us=500,
                                 device_ms=device_ms, args=args or None)


def _read(monkeypatch, graphed):
    """The share over one traced wave whose decode steps carry ``graphed``
    (None: no arg), beside a step from before the window closed."""
    from repro_torch.telemetry import selftrace

    spans = [_span("model/decode_step", 1, 0, 10, graphed=0),
             _span("model/prefill", 2, 0, 2_000_000, device_ms=5.0)]
    for i, g in enumerate(graphed):
        args = {} if g is None else {"graphed": g}
        spans.append(_span("model/decode_step", 10 + i, 0, 2_000_100 + i, **args))
        if not g:
            spans.append(_span("mamba/decode", 100 + i, 10 + i, 2_000_100 + i))
    tracer = types.SimpleNamespace(snapshot=lambda: list(spans))
    monkeypatch.setattr(selftrace, "get_self_tracer", lambda: tracer)
    return SP.metric_reader("decode_graph_share").read(RUN)


@pytest.mark.parametrize("graphed,share", [((None,) * 7, 0.0), ((0,) * 7, 0.0),
                                           ((0, 1, 1, 1), 75.0), ((1,) * 7, 100.0)])
def test_the_share_of_replayed_steps(monkeypatch, graphed, share):
    assert _read(monkeypatch, graphed) == pytest.approx(share)


def test_nothing_to_read_without_the_spans(monkeypatch):
    from repro_torch.telemetry import selftrace

    monkeypatch.setattr(selftrace, "get_self_tracer", lambda: types.SimpleNamespace())
    assert SP.metric_reader("decode_graph_share").read(RUN) is None
    assert _read(monkeypatch, ()) is None
    tracer = types.SimpleNamespace(snapshot=lambda: [
        _span("model/prefill", 1, 0, 2_000_000), _span("model/decode_step", 2, 0, 2_000_100,
                                                       graphed=1)])
    monkeypatch.setattr(selftrace, "get_self_tracer", lambda: tracer)
    assert SP.metric_reader("decode_graph_share").read(RUN) is None  # not timed on a card
