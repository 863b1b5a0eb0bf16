"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, everything else as a run drives it.
One chip, so there is no exchange between chips to leave out."""
from __future__ import annotations

import pytest
import torch

from conftest import run_tiny


def _stale_state(real):
    """A decode step that returns the cache as it found it."""
    def decode_step(cfg, params, cache, tokens, *a, **kw):
        before = {"pos": cache["pos"],
                  "layers": [{k: v.clone() for k, v in layer.items()} for layer in cache["layers"]]}
        logits, _ = real(cfg, params, cache, tokens, *a, **kw)
        return logits, before
    return decode_step


def _half_batch(real):
    """A prefill that computes the first half of the batch and repeats it."""
    def prefill(cfg, params, batch, *a, **kw):
        B = batch["tokens"].shape[0]
        h = max(B // 2, 1)
        logits, cache = real(cfg, params, {"tokens": batch["tokens"][:h]}, *a, **kw)
        rows = torch.arange(B) % h
        layers = [{k: (v if k == "kpos" else v[:, rows]) for k, v in layer.items()}
                  for layer in cache["layers"]]
        return logits[rows], {**cache, "layers": layers}
    return prefill


def _altered_token(real, rows=slice(None)):
    """A decode step whose tokens of ``rows`` are others where they are produced."""
    def decode_step(cfg, params, cache, tokens, *a, **kw):
        logits, cache = real(cfg, params, cache, tokens, *a, **kw)
        logits = logits.clone()
        part = logits[rows]
        top = part.argmax(-1, keepdim=True)
        part.scatter_(-1, (top + 1) % cfg.vocab, part.gather(-1, top) + 1.0)
        return logits, cache
    return decode_step


def _altered_token_in_one_slot(real):
    """The same in the first of the clients alone: a quarter of the tiny
    cells' served positions, which leaves the median position sound."""
    return _altered_token(real, slice(0, 1))


FAULTS = {"state_unchanged": ("decode_step", _stale_state),
          "half_batch": ("prefill", _half_batch),
          "token_altered": ("decode_step", _altered_token),
          "token_altered_in_one_slot": ("decode_step", _altered_token_in_one_slot)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", ["tiny-mamba.tiny", "tiny-jamba.tiny"])
def test_broken_model_path_is_not_correct(bench_root, monkeypatch, name, fault):
    from repro_torch.models import model as M

    where, make = FAULTS[fault]
    monkeypatch.setattr(M, where, make(getattr(M, where)))
    res = run_tiny(bench_root, name)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for k, c in res["checks"].items()
               if not k.startswith("ad_"))


@pytest.mark.parametrize("name", ["tiny-mamba.tiny", "tiny-jamba.tiny"])
def test_a_wrong_label_from_the_monitor_is_not_correct(bench_root, monkeypatch, name):
    import numpy as np

    from repro_torch.core import ad

    real = ad.SstdDetector.label

    def label(self, table, fids, runtimes):
        lab = real(self, table, fids, runtimes)
        if len(lab):
            lab = lab.copy()
            lab[-1] = np.int8(1 - lab[-1])  # the frame's last call labelled the other way
        return lab

    monkeypatch.setattr(ad.SstdDetector, "label", label)
    res = run_tiny(bench_root, name)
    assert res["correct"] is False
    assert res["checks"]["ad_labels"]["value"] > 0


@pytest.mark.parametrize("name", ["tiny-mamba.tiny", "tiny-jamba.tiny"])
def test_a_frame_missing_from_the_statistics_is_not_correct(bench_root, monkeypatch, name):
    from repro_torch.core import ps

    real = ps.ParameterServer.update_and_fetch
    seen = []

    def update_and_fetch(self, rank, step, delta):
        seen.append(step)
        if len(seen) == 2:  # the second frame's delta never reaches the table
            return self.global_stats.table.copy()
        return real(self, rank, step, delta)

    monkeypatch.setattr(ps.ParameterServer, "update_and_fetch", update_and_fetch)
    res = run_tiny(bench_root, name)
    assert res["correct"] is False
    assert res["checks"]["ad_stats"]["value"] > res["checks"]["ad_stats"]["limit"]
