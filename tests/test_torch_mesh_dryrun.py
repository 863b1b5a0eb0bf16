"""The dry run on a mesh: rank 0's step counted on meta tensors in a fake
process group, against the JAX package's meshed cells.

Twins of tests/test_dryrun.py:84-135 on a fake group of 8 ranks and the
mesh (2, 2, 2) over ("pod", "data", "model"): the probe extrapolation of
gemma2-2b's smoke ``mini_train`` within 2 % of the direct count (eager
counting makes it exact), and the smoke ``mini`` (train) and ``mini_dec``
(decode) cells of jamba-v0.1-52b, qwen3-moe-30b-a3b and minicpm3-4b
counted without error.  Beyond JAX's tests:

  * each argument leaf's local shape equals JAX's
    ``NamedSharding.shard_shape`` of it (shapes, not bytes: the port's
    serving cells hold bf16 weights where JAX's hold float32);
  * a meshed train cell records its parameter all-gathers and gradient
    reduce-scatters: with ``fsdp`` off (each leaf split over the model
    axis only) the all-gathers' result bytes are the whole sharded
    leaves' and the reduce-scatters' the rank's blocks', exactly;
  * ``extrapolate_depth``: prefill and decode cells of 3 periods counted
    at 1 and 2 and extrapolated equal the direct count (the peak on the
    mesh an estimate at or above it);
  * DTensor's collectives (``_c10d_functional`` ops) under
    ``compat.CostCounter``: one all-gather of the gathered bytes, and no
    aten op or HBM byte counted for it;
  * ``main(["--arch", "gemma-2b", "--shape", "decode_32k", "--mesh",
    "both"])`` in a child writes two ``ok`` records, 256 and 512 devices,
    in a fake group it starts itself; a real group in place makes the
    meshed dry run raise.

JAX builds its cells in a child process on 8 host devices (no compile:
shapes only); the port counts in a child process that owns the fake group.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
_TIMEOUT = 300

_COMMON = r"""
MESH = ((2, 2, 2), ("pod", "data", "model"))
SHAPES = {"mini": (64, 8, "train"), "mini_dec": (64, 8, "decode"),
          "mini_train": (64, 8, "train"), "mini_pre": (64, 8, "prefill")}
DEPTH = [(a, s, on) for a in ("gemma2-2b", "jamba-v0.1-52b", "falcon-mamba-7b")
         for s in ("mini_pre", "mini_dec") for on in (0, 1)]
CELLS = [(a, s) for a in ("jamba-v0.1-52b", "qwen3-moe-30b-a3b", "minicpm3-4b")
         for s in ("mini", "mini_dec")]
"""

_JAX_SCRIPT = _COMMON + r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax
from repro import configs
from repro.compat import make_mesh
from repro.launch.steps import StepOptions, make_cell

mesh = make_mesh(*MESH)
for name, (seq, batch, mode) in SHAPES.items():
    configs.SHAPES[name] = configs.ShapeCell(name, seq, batch, mode)
out = {}
for arch, shape in CELLS + [("gemma2-2b", "mini_train")]:
    cell = make_cell(configs.smoke(arch), shape, mesh, StepOptions(ce_chunk=32))
    leaves = jax.tree_util.tree_flatten_with_path(cell.args)[0]
    out[f"{arch} {shape}"] = {jax.tree_util.keystr(path):
                              list(leaf.sharding.shard_shape(leaf.shape)) for path, leaf in leaves}
print(json.dumps(out))
"""

_TORCH_SCRIPT = _COMMON + r"""
import dataclasses, json
import torch, torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import compat, configs, tree as T
from repro_torch.launch import dryrun as D, roofline as R, steps as TS

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = DeviceMesh("cpu", torch.arange(8).reshape(MESH[0]), mesh_dim_names=MESH[1])
for name, (seq, batch, mode) in SHAPES.items():
    configs.SHAPES[name] = configs.ShapeCell(name, seq, batch, mode)
out = {"shapes": {}, "counts": {}}


def local_shapes(args):
    shapes = {}
    for i, arg in enumerate(args):
        for path, leaf in (T.paths(arg, f"[{i}]") if isinstance(arg, (dict, list))
                           else [(f"[{i}]", arg)]):
            if isinstance(leaf, torch.Tensor):
                t = leaf.to_local() if isinstance(leaf, DTensor) else leaf
                shapes[path] = list(t.shape)
    return shapes


for arch, shape in CELLS + [("gemma2-2b", "mini_train")]:
    cell = TS.make_cell(configs.smoke(arch), shape, mesh, TS.StepOptions(ce_chunk=32))
    out["shapes"][f"{arch} {shape}"] = local_shapes(cell.args)
    c = D.count(cell)
    out["counts"][f"{arch} {shape}"] = {k: c[k] for k in ("flops", "bytes_accessed", "peak_bytes",
                                                          "wire_bytes", "aten_ops")}

# the probe extrapolation against the direct count (tests/test_dryrun.py:84)
cfg = configs.smoke("gemma2-2b")
probe = D.probe_costs(cfg, "mini_train", mesh, {}, 1)
direct = D.count(TS.make_cell(cfg, "mini_train", mesh, TS.StepOptions(probe=True, microbatch=1)))
out["probe"] = {k: [probe[k], direct[k]] for k in ("flops", "bytes_accessed", "transcendentals",
                                                   "wire_bytes")}

# the train cell's gathers and reduce-scatters against its placed leaves
for fsdp in (False, True):
    opts = TS.StepOptions(fsdp=fsdp, remat="none", ce_chunk=64, microbatch=1)
    cell = TS.make_cell(cfg, "mini_train", mesh, opts)
    coll = D.count(cell)["collectives"]
    split = [t for t in T.leaves(cell.args[0]["params"]) if any(p.is_shard() for p in t.placements)]
    out[f"train_fsdp{int(fsdp)}"] = {
        "collectives": coll,
        "whole": sum(t.numel() * t.element_size() for t in split),
        "local": sum(t.to_local().numel() * t.element_size() for t in split)}

# prefill and decode extrapolated over depth against the direct count at 3 periods
out["depth"] = {}
for arch, shape, on in DEPTH:
    c = configs.smoke(arch)
    c = dataclasses.replace(c, n_layers=3 * c.period)
    m = mesh if on else None
    ev, points = D.evaluate(c, shape, TS.StepOptions(), m, extrapolate_depth=True)
    direct = D.count(TS.make_cell(c, shape, m, TS.StepOptions()))
    out["depth"][f"{arch} {shape} {on}"] = {
        "points": sorted(points), **{k: [ev[k], direct[k]] for k in D._COSTS + D._MEMORY}}

# a DTensor gather under the counter
t = DTensor.from_local(torch.empty(4, 8, device="meta"), mesh, [Shard(0), Replicate(), Replicate()],
                       run_check=False)
counter = compat.CostCounter()
with counter:
    counter.hold(t)
    whole = t.redistribute(mesh, [Replicate()] * 3)
out["gather"] = {"collectives": counter.collectives, "ops": counter.ops,
                 "bytes": counter.bytes_accessed, "whole": list(whole.to_local().shape),
                 "held": counter.peak_bytes}
print(json.dumps(out))
"""

_CLI_SCRIPT = r"""
import json, os, sys
import torch.distributed as dist
from repro_torch.launch import dryrun as D

out_dir = sys.argv[1]
dist.init_process_group("gloo", init_method="file://" + os.path.join(out_dir, "pg"), rank=0,
                        world_size=1)
try:
    D.run_cell("gemma-2b", "decode_32k", "single")
    raised = ""
except RuntimeError as e:
    raised = str(e)
dist.destroy_process_group()
rc = D.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--mesh", "both",
             "--out-dir", out_dir, "--probes"])
print(json.dumps({"rc": rc, "raised": raised}))
"""


def _child(script, *args):
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, "-c", script, *map(str, args)], capture_output=True,
                       text=True, timeout=_TIMEOUT, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs():
    return {"jax": _child(_JAX_SCRIPT), "torch": _child(_TORCH_SCRIPT)}


_SHARED: dict = {}
exec(_COMMON, _SHARED)  # noqa: S102 - the cases, as the scripts hold them


def test_probe_extrapolation_on_a_mesh_matches_the_direct_count(runs):
    """Twin of tests/test_dryrun.py:84 on (2, 2, 2): within 2 % (eager
    counting makes the affine extrapolation exact, collectives included)."""
    for k, (extrap, direct) in runs["torch"]["probe"].items():
        assert direct > 0 or k == "wire_bytes", k
        assert abs(extrap - direct) <= 0.02 * direct, (k, extrap, direct)
    assert runs["torch"]["probe"]["wire_bytes"][1] > 0


@pytest.mark.parametrize("cell", [f"{a} {s}" for a, s in _SHARED["CELLS"]])
def test_mini_mesh_cells_count(runs, cell):
    """Twin of tests/test_dryrun.py:108: jamba, qwen3-moe and minicpm3 smoke
    train and decode cells on the 3-axis mesh count, with collectives."""
    c = runs["torch"]["counts"][cell]
    assert c["flops"] > 0 and c["bytes_accessed"] > 0 and c["aten_ops"] > 0
    assert c["peak_bytes"] > 0 and c["wire_bytes"] > 0


@pytest.mark.parametrize("cell", [f"{a} {s}" for a, s in _SHARED["CELLS"]]
                         + ["gemma2-2b mini_train"])
def test_argument_local_shapes_equal_jax_shard_shapes(runs, cell):
    """Every argument leaf (the placed state or weights, the batch, the
    cache blocks, the tokens) has JAX's shard shape on the device at the
    rank's coordinate; JAX's scalar cache position is the port's host int."""
    want, got = runs["jax"][cell], runs["torch"]["shapes"][cell]
    want = {k: v for k, v in want.items() if k != "[1]['pos']"}
    assert got == want


def test_meshed_train_cell_records_gathers_and_reduce_scatters(runs):
    """With fsdp off every split leaf is gathered whole once (remat none,
    one microbatch) and its gradient reduce-scattered to the rank's block:
    the all-gathers' result bytes are the whole leaves', the
    reduce-scatters' the blocks'.  With fsdp on (leaves split over two
    mesh dims, gathered in two steps) both kinds are recorded, the
    all-gathers' bytes at least the whole leaves'."""
    off, on = runs["torch"]["train_fsdp0"], runs["torch"]["train_fsdp1"]
    assert off["collectives"]["all-gather"]["result_bytes"] == off["whole"]
    assert off["collectives"]["reduce-scatter"]["result_bytes"] == off["local"] < off["whole"]
    assert on["collectives"]["all-gather"]["result_bytes"] >= on["whole"]
    assert on["collectives"]["reduce-scatter"]["count"] > 0 and on["local"] < off["local"]


@pytest.mark.parametrize("case", [f"{a} {s} {on}" for a, s, on in _SHARED["DEPTH"]])
def test_depth_extrapolation_of_serving_cells(runs, case):
    """``extrapolate_depth``: a prefill or decode cell of 3 periods counted
    at 1 and 2 and extrapolated.  Every cost (FLOPs, bytes, transcendentals,
    wire bytes, aten ops) and the argument and output sizes equal the
    direct count exactly, on one device and on the mesh; the peak equals it
    on one device, and on the mesh is an estimate at or above it (within
    20 %: a one-period cell's gathers leave a larger share live)."""
    got = dict(runs["torch"]["depth"][case])
    assert got.pop("points") == ["p1m1", "p2m1"]
    peak_ev, peak_direct = got.pop("peak_bytes")
    for k, (ev, direct) in got.items():
        assert ev == direct, (k, ev, direct)
    if case.endswith(" 0"):
        assert peak_ev == peak_direct
    else:
        assert peak_direct <= peak_ev <= 1.2 * peak_direct, (peak_ev, peak_direct)


def test_dtensor_gather_is_a_collective_not_aten_ops(runs):
    """A redistribute of a (4·2, 8) float32 DTensor split over the pod dim to
    replicated: one all-gather of the 256 gathered bytes; no aten op, no
    byte accessed; the held argument counted as its local block."""
    g = runs["torch"]["gather"]
    assert g["collectives"] == [["all-gather", 8 * 8 * 4]]
    assert g["ops"] == 0 and g["bytes"] == 0 and g["whole"] == [8, 8]
    assert g["held"] == 4 * 8 * 4


def test_dryrun_cli_on_both_production_meshes(tmp_path):
    """Two ok records of JAX's names and device counts; a gloo group in
    place first makes run_cell on a mesh raise.  With --probes the single
    pod's record (only it, as JAX's) carries the probe's roofline, its
    score traffic and memory floor at tp 16: JAX's numbers."""
    from repro import configs as jconfigs
    from repro.launch import roofline as JR

    res = _child(_CLI_SCRIPT, tmp_path)
    assert res["rc"] == 0 and "fake process group" in res["raised"]
    jcfg = jconfigs.get_config("gemma-2b")
    for mesh, devices in (("single", 256), ("multi", 512)):
        rec = json.loads((tmp_path / f"gemma-2b__decode_32k__{mesh}.json").read_text())
        assert rec["status"] == "ok" and rec["devices"] == devices and rec["rank"] == 0
        assert rec["mesh"] == mesh and rec["memory"]["fits_80gb_hbm"]
        assert rec["wire_bytes_per_device"] > 0 and rec["collectives"]["all-gather"]["count"] > 0
        assert ("roofline_probe" in rec) == (mesh == "single")
    probe = json.loads((tmp_path / "gemma-2b__decode_32k__single.json").read_text())
    assert probe["roofline_probe"]["attn_scores_bytes"] == \
        JR.attn_scores_traffic(jcfg, "decode", 128, 32768, 256)
    assert probe["roofline_probe"]["memory_floor_bytes"] == \
        JR.analytic_memory_floor(jcfg, "decode", 128, 32768, 256, 1)
