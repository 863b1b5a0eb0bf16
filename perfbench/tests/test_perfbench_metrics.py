"""The metric arithmetic on synthetic timestamps."""
from __future__ import annotations

import numpy as np
import pytest

from perfbench.harness import stats
from perfbench.harness.serve import Wave


def closed_loop(n, stall=None, B=4, S=100, first_after=1.0, steps=3, step_s=0.1):
    """n waves of a closed loop: each wave's requests are sent when the
    previous wave's replies are complete; ``stall`` delays a wave's first
    token by its seconds."""
    out, t = [], 0.0
    for i in range(n):
        w = Wave(prompts=np.zeros((B, S), np.int64), submit=t)
        w.t_first = t + first_after + (stall or {}).get(i, 0.0)
        w.emitted = [(w.t_first, B * S + B)] + [(w.t_first + step_s * (k + 1), B)
                                                 for k in range(steps)]
        w.t_done = w.t_end = t = w.emitted[-1][0]
        out.append(w)
    return out


def test_nearest_rank():
    assert stats.nearest_rank([5, 1, 3, 2, 4], 0.9) == 5
    assert stats.nearest_rank(range(1, 101), 0.9) == 90
    assert stats.nearest_rank([7], 0.5) == 7
    with pytest.raises(ValueError):
        stats.nearest_rank([], 0.5)


def test_a_stall_lowers_tokens_per_s_and_raises_the_ttft_tail():
    steady = closed_loop(10)
    stalled = closed_loop(10, stall={5: 2.0, 6: 2.0})
    assert stats.tokens_per_s(stalled, 0.0, stalled[-1].t_end) < \
        stats.tokens_per_s(steady, 0.0, steady[-1].t_end)
    ttft = stats.ttfts(stalled)
    assert len(ttft) == 40  # every request, not one per wave
    assert stats.nearest_rank(stats.ttfts(steady), 0.9) == pytest.approx(1.0)
    assert stats.nearest_rank(ttft, 0.9) == pytest.approx(3.0)


def test_the_percentile_is_over_requests_not_waves():
    # one stalled wave of ten holds 4 of 40 requests: at the 90th percentile's edge
    one = stats.ttfts(closed_loop(10, stall={5: 2.0}))
    assert stats.nearest_rank(one, 0.9) == pytest.approx(1.0)
    assert stats.nearest_rank(one, 0.91) == pytest.approx(3.0)


def test_tokens_count_only_inside_the_window():
    w = closed_loop(2)
    everything = stats.tokens_per_s(w, 0.0, w[-1].t_end) * w[-1].t_end
    assert everything == pytest.approx(2 * (4 * 100 + 4 + 3 * 4))
    cut = w[1].emitted[0][0] - 1e-9  # the window closes before the second wave's first token
    assert stats.tokens_per_s(w, 0.0, cut) * cut == pytest.approx(4 * 100 + 4 + 3 * 4)


@pytest.mark.parametrize("name,chips", [("falcon-mamba-7b.score-1k", 1),
                                        ("jamba-v0.1-1p.doc-4k", 1), ("jamba-v0.1-1p.doc-4k", 4)])
def test_mfu_prefill_is_over_the_peak_of_the_cells_cards(name, chips):
    """A one-card cell reads what it read before the peak counted cards
    (one card's peak, bit for bit); a four-card cell a quarter of that."""
    import dataclasses

    from perfbench.harness import peaks
    from perfbench.harness import spec as SP
    from perfbench.harness.cli import Run

    cell = SP.load_cell(name)
    cell = dataclasses.replace(cell, workload={**cell.workload, "chips": chips})
    waves = closed_loop(3)
    for w, ms in zip(waves, (350.59, 351.25, 349.875)):
        w.prefill_ms = ms
    run = Run(cell, waves, 0.0, waves[-1].t_end, 1.0)
    t = cell.traffic
    seconds = sum(w.prefill_ms for w in waves) / len(waves) / 1e3
    one_card = 100.0 * (peaks.prefill_flops(cell.model, t["clients"], t["prompt_len"])
                        / (seconds * 989e12))  # the reader's arithmetic before cards counted
    got = SP.metric_reader("mfu.prefill").read(run)
    if chips == 1:
        assert got == one_card
    else:
        assert got == pytest.approx(one_card / chips, rel=1e-12)
