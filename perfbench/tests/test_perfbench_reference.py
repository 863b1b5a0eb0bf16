"""The plain references against the program, both in float32, at a size
the CPU holds: the program's prefill and decode through the harness's
serving loop, the reference's full forward over each prompt and its served
tokens.  Float32 on both sides, so only the order of operations differs."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench.harness import check as CK
from perfbench.harness import model as MD
from perfbench.harness import serve as SV
from perfbench.harness import spec as SP


def float32_served(cell, seed, n_waves=2):
    cfg = dataclasses.replace(MD.port_config(cell.conf), compute_dtype=torch.float32)
    w = MD.make_weights(cell.conf, seed, "cpu")
    w32 = {k: (v if k == "layers" else v.float()) for k, v in w.items()}
    w32["layers"] = [{k: v.float() for k, v in layer.items()} for layer in w["layers"]]
    traffic = SV.Traffic(cell.traffic, cfg.vocab, seed)
    server = SV.Server(cfg, w32, traffic, "cpu")
    waves = [server.wave(traffic.next_prompts(), SV.now()) for _ in range(n_waves)]
    server.close()
    return w, waves


@pytest.mark.parametrize("name", ["tiny-mamba.tiny", "tiny-jamba.tiny"])
@pytest.mark.parametrize("seed", [3, 2**33 + 1])
def test_reference_matches_the_program_in_float32(bench_root, name, seed):
    cell = SP.load_cell(name, bench_root)
    w, waves = float32_served(cell, seed)
    numbers = CK.model_numbers(cell, w, waves, [0, 1], "cpu")
    assert numbers["tokens"] == 2 * cell.traffic["clients"] * cell.traffic["max_new"]
    assert numbers["gap"] == 0.0
    assert numbers["logit_err"] < 1e-4


def test_weights_have_the_program_layout_and_dtypes(bench_root):
    for name in ("tiny-mamba.tiny", "tiny-jamba.tiny"):
        cell = SP.load_cell(name, bench_root)
        cfg = MD.port_config(cell.conf)
        MD.check_layout(cfg, MD.weight_leaves(cell.conf))
        w = MD.make_weights(cell.conf, 5, "cpu")
        assert w["final_ln"].dtype == torch.float32 and w["embed"].dtype == torch.bfloat16
        assert all(v.dtype == (torch.float32 if k == "A_log" else torch.bfloat16)
                   for layer in w["layers"] for k, v in layer.items())
        again = MD.make_weights(cell.conf, 5, "cpu")
        assert torch.equal(w["embed"], again["embed"])  # the same seed, the same weights
        assert not torch.equal(w["embed"], MD.make_weights(cell.conf, 6, "cpu")["embed"])


def test_a_configuration_the_program_disagrees_with_is_refused(bench_root):
    cell = SP.load_cell("tiny-mamba.tiny", bench_root)
    cell.conf["model"]["ssm_d_state"] = 16
    with pytest.raises(ValueError, match="ssm_d_state"):
        MD.port_config(cell.conf)


def test_moe_capacity_keeps_tokens_in_order():
    from perfbench.reference import jamba

    m = {"moe_experts": 2, "moe_topk": 1, "moe_capacity_factor": 1.0}
    p = {"router": torch.tensor([[1.0, -1.0]])}
    x = torch.ones((40, 1))  # every token prefers expert 0
    kept, weight = jamba.route(p, x, m, None)
    bound = max(20, 16)  # ceil(1 * 40 / 2 * 1.0), min(40, 16)
    assert kept[:, 0].tolist() == [True] * bound + [False] * (40 - bound)
    assert not kept[:, 1].any() and torch.allclose(weight[:, 0], torch.ones(40))
