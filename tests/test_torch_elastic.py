"""Elasticity on a mesh: the port's twin of tests/test_elastic.py.

Eight gloo processes (rendezvous ``file://``) train the smoke gemma-2b
(bf16 compute) on a (4, 2) mesh over ("data", "model") for six steps,
the state placed by ``steps.train_state_shardings``; save it (a placed,
collective save), restore it resharded onto a (2, 4) mesh
(``ckpt.load(shardings=)`` on a meta target) and train six more steps.
The batches are JAX's ``SyntheticStream(seed=3)``, the options JAX's
test's, and the initial state JAX's ``make_train_state(cfg, 0)`` (its
checkpoint, restored onto the (4, 2) placements).  The twelve losses are
held within JAX's 5e-2 of the port's uninterrupted single-device run from
the same state, and within the same bound of JAX's own elastic run
(tests/test_elastic.py's script, here in a child process on eight host
devices).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parents[1]
_WORLD = 8
_TIMEOUT = 300
BOUND = 5e-2  # tests/test_elastic.py:66

_JAX_INIT = r"""
import sys

from repro import configs
from repro.checkpoint import ckpt as CK
from repro.launch.steps import make_train_state

CK.save(sys.argv[1], 0, make_train_state(configs.smoke("gemma-2b"), 0))
print("JAX_INIT_OK")
"""

_JAX_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import functools, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.checkpoint import ckpt as CK
from repro.compat import make_mesh
from repro.data.pipeline import DataShard, SyntheticStream
from repro.launch import sharding as SH
from repro.launch.steps import StepOptions, build_train_step, make_shard_ctx, make_train_state
from repro.optim.adamw import OptConfig

cfg = configs.smoke("gemma-2b")
opts = StepOptions(ce_chunk=512, opt=OptConfig(peak_lr=1e-3, warmup_steps=5))
GB, SEQ = 8, 32
stream = SyntheticStream(cfg, DataShard(0, 1, GB), SEQ, seed=3)


def run_steps(mesh, state, lo, hi):
    step_fn = jax.jit(build_train_step(cfg, make_shard_ctx(cfg, mesh, GB, opts), opts,
                                       microbatch=1))
    losses = []
    for s in range(lo, hi):
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in stream.batch_at(s).items()})
        losses.append(float(m["loss"]))
    return state, losses


state, l_a = run_steps(make_mesh((4, 2), ("data", "model")), make_train_state(cfg, 0), 0, 6)
CK.save(sys.argv[1], 6, state)
mesh_b = make_mesh((2, 4), ("data", "model"))
target = jax.eval_shape(functools.partial(make_train_state, cfg))
ps = lambda t: SH.param_shardings(cfg, t, mesh_b)  # noqa: E731
sh = {"params": ps(target["params"]), "m": ps(target["m"]), "v": ps(target["v"]),
      "step": NamedSharding(mesh_b, P())}
_, state_b = CK.load(sys.argv[1], target=target, shardings=sh)
_, l_b = run_steps(mesh_b, state_b, 6, 12)
print(json.dumps(l_a + l_b))
"""

_TORCH_WORKER = r"""
import json, sys
import torch, torch.distributed as dist
from repro_torch import compat, configs
from repro_torch.checkpoint import ckpt as CK
from repro_torch.data.pipeline import DataShard, SyntheticStream
from repro_torch.launch import sharding as SH, steps as TS
from repro_torch.optim.adamw import OptConfig

rank, init, outdir, jax_init = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=8)
cfg = configs.smoke("gemma-2b")
opts = TS.StepOptions(ce_chunk=512, opt=OptConfig(peak_lr=1e-3, warmup_steps=5))
GB, SEQ = 8, 32
stream = SyntheticStream(cfg, DataShard(0, 1, GB), SEQ, seed=3)


def run_steps(mesh, state, lo, hi):
    step_fn = TS.build_train_step(cfg, TS.make_shard_ctx(cfg, mesh, GB, opts), opts, microbatch=1)
    losses = []
    for s in range(lo, hi):
        state, m = step_fn(state, {k: torch.from_numpy(v) for k, v in stream.batch_at(s).items()})
        losses.append(float(m["loss"]))
    return state, losses


mesh_a = compat.make_mesh((4, 2), ("data", "model"), device="cpu")
target = TS.make_train_state(cfg, 1, device="cpu")
_, state = CK.load(jax_init, target=target,
                   shardings=TS.train_state_shardings(cfg, target, mesh_a, opts))
state, l_a = run_steps(mesh_a, state, 0, 6)
CK.save(f"{outdir}/ck", 6, state)
mesh_b = compat.make_mesh((2, 4), ("data", "model"), device="cpu")
target = TS.meta_train_state(cfg)
step, state_b = CK.load(f"{outdir}/ck", target=target,
                        shardings=TS.train_state_shardings(cfg, target, mesh_b, opts))
assert step == 6 and str(state_b["params"]["embed"].device) == "cpu"
assert state_b["params"]["embed"].device_mesh is mesh_b
_, l_b = run_steps(mesh_b, state_b, 6, 12)
out = {"elastic": l_a + l_b}
if rank == 0:  # the uninterrupted single-device run
    _, out["single"] = run_steps(None, CK.load(jax_init, target=target)[1], 0, 12)
with open(f"{outdir}/rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
print("TORCH_ELASTIC_OK", rank)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}
    init = subprocess.run([sys.executable, "-c", _JAX_INIT, str(d / "jax_init")],
                          capture_output=True, text=True, timeout=_TIMEOUT, env=env)
    assert "JAX_INIT_OK" in init.stdout, init.stderr[-3000:]
    jax_run = subprocess.Popen([sys.executable, "-c", _JAX_SCRIPT, str(d / "jax_ck")],
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TORCH_WORKER, str(r), str(d / "pg"), str(d), str(d / "jax_init")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(_WORLD)]
    try:
        logs = [p.communicate(timeout=_TIMEOUT)[0] for p in procs]
        jax_out, jax_err = jax_run.communicate(timeout=_TIMEOUT)
    finally:
        for p in procs + [jax_run]:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"TORCH_ELASTIC_OK {r}" in text, text[-3000:]
    assert jax_run.returncode == 0, jax_err[-3000:]
    ranks = []
    for r in range(_WORLD):
        with open(d / f"rank{r}.json") as f:
            ranks.append(json.load(f))
    return json.loads(jax_out.strip().splitlines()[-1]), ranks


def test_elastic_rescale_matches_the_uninterrupted_run(runs):
    """(4, 2) for six steps, restored onto (2, 4) for six more: every rank
    holds the same losses, within 5e-2 of one device's twelve."""
    _, ranks = runs
    full = ranks[0]["elastic"]
    assert len(full) == 12 and all(np.isfinite(full))
    for got in ranks:
        assert got["elastic"] == full
    err = max(abs(a - b) for a, b in zip(full, ranks[0]["single"]))
    assert err < BOUND, (err, full, ranks[0]["single"])


def test_elastic_rescale_matches_jax_elastic_run(runs):
    jax_losses, ranks = runs
    assert len(jax_losses) == 12
    err = max(abs(a - b) for a, b in zip(ranks[0]["elastic"], jax_losses))
    assert err < BOUND, (err, ranks[0]["elastic"], jax_losses)
