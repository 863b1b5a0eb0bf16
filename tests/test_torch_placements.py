"""Parameter and batch placements on a mesh, the production meshes, and
checkpoints of placed trees: the port against the JAX package.

JAX runs in a child process on 512 host devices: for every smoke config,
on the meshes (2, 2) and (1, 4) over ("data", "model") and (2, 1, 2) over
("pod", "data", "model"), with ``fsdp`` and ``mamba_tp`` each on and off,
it records the index of the block ``NamedSharding`` gives each device of
every parameter leaf, and of ``tokens``, ``labels`` and ``pos3`` by
``batch_shardings`` (a batch of 4, of 2 and of 1, the last two smaller
than or equal to dp); its production meshes' shapes and names; the specs
``param_shardings`` gives every full config there; and a checkpoint of a
train state with bf16 params beside a float32 master.

The port runs in four gloo processes (rendezvous ``file://``): each places
numpy-made global trees with ``launch.sharding.place`` and holds its
blocks bitwise against the global array at JAX's index for the device at
the same mesh coordinate (ranks row-major over the mesh dims).  A child
process with a fake process group of world 256 and of world 512 builds
``make_production_mesh`` and the same specs; with fewer ranks it raises.

Checkpoints: a placed save is byte-identical to an unplaced save of the
same tree; the twin of tests/test_substrates.py:173
(``test_checkpoint_reshard``) on four ranks, ``P("data", None)``; JAX's
checkpoint restores onto the port's placements, each rank's blocks
bitwise, and the port's placed save restores in JAX under its
``NamedSharding``\\s, bitwise.
"""
import filecmp
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
_WORLD = 4
_TIMEOUT = 300

_COMMON = r"""
import numpy as np

ARCHS = ("gemma-2b", "gemma2-2b", "h2o-danube3-4b", "falcon-mamba-7b", "jamba-v0.1-52b",
         "granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "minicpm3-4b", "qwen2-vl-2b",
         "hubert-xlarge")
MESHES = {"22": ((2, 2), ("data", "model")), "14": ((1, 4), ("data", "model")),
          "212": ((2, 1, 2), ("pod", "data", "model"))}
OPTIONS = [(f, m) for f in (True, False) for m in (True, False)]  # (fsdp, mamba_tp)
BATCHES = (4, 2, 1)
SEQ = 8


def combo(arch, mesh, fsdp, mamba_tp):
    return f"{arch}__{mesh}__{int(fsdp)}{int(mamba_tp)}"


def batch_shapes(b):
    return {"tokens": (b, SEQ), "labels": (b, SEQ), "pos3": (3, b, SEQ)}


def leaf_values(shape, i):
    return np.random.default_rng(i).normal(size=shape).astype(np.float32)
"""

_JAX_SCRIPT = _COMMON + r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, jax.numpy as jnp
from repro import configs
from repro.checkpoint import ckpt as CK
from repro.compat import make_mesh
from repro.launch import sharding as SH
from repro.launch.mesh import make_production_mesh
from repro.launch.steps import make_train_state
from repro.models.common import init_params

out, ck_dir = {}, sys.argv[2]
devs = jax.devices()[:4]
meshes = {m: make_mesh(shape, names, devices=devs) for m, (shape, names) in MESHES.items()}


def indices(mesh, sharding, shape):
    per = np.zeros((4, len(shape), 2), np.int64)
    for dev, index in sharding.devices_indices_map(tuple(shape)).items():
        coord = np.argwhere(mesh.devices == dev)[0]
        r = int(np.ravel_multi_index(tuple(coord), mesh.devices.shape))
        for d, sl in enumerate(index):
            per[r, d] = sl.indices(shape[d])[:2]
    return per


def spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(spec)]


for arch in ARCHS:
    cfg = configs.smoke(arch)
    shapes = jax.eval_shape(lambda: init_params(cfg, jax.random.key(0)))
    for m, mesh in meshes.items():
        for fsdp, mtp in OPTIONS:
            sh = SH.param_shardings(cfg, shapes, mesh, fsdp, mtp)
            for i, (leaf, s) in enumerate(zip(jax.tree.leaves(shapes), jax.tree.leaves(sh))):
                out[f"p__{combo(arch, m, fsdp, mtp)}__{i}"] = indices(mesh, s, leaf.shape)
for m, mesh in meshes.items():
    for b in BATCHES:
        spec = {k: jax.ShapeDtypeStruct(v, jnp.int32) for k, v in batch_shapes(b).items()}
        for k, s in SH.batch_shardings(None, spec, mesh).items():
            out[f"b__{m}__{b}__{k}"] = indices(mesh, s, spec[k].shape)
prod = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    prod[str(multi)] = {"shape": list(mesh.devices.shape), "names": list(mesh.axis_names),
                        "specs": {}}
    for arch in ARCHS:
        cfg = configs.get_config(arch)
        shapes = jax.eval_shape(lambda: init_params(cfg, jax.random.key(0)))
        prod[str(multi)]["specs"][arch] = [
            spec_json(s.spec) for s in jax.tree.leaves(SH.param_shardings(cfg, shapes, mesh))]
out["production"] = np.asarray(json.dumps(prod))
# a train state with bf16 params and a float32 master, checkpointed
cfg = configs.smoke("gemma-2b")
state = make_train_state(cfg, 0, master_in_opt=True)
CK.save(ck_dir, 5, state)
for i, leaf in enumerate(jax.tree.leaves(state)):
    out[f"st__{i}"] = np.asarray(jnp.asarray(leaf, jnp.float32))
np.savez(sys.argv[1], **out)
print("JAX_PLACEMENTS_OK")
"""

_JAX_RESTORE = r"""
import os, sys, functools
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro import configs
from repro.checkpoint import ckpt as CK
from repro.compat import make_mesh
from repro.launch import sharding as SH
from repro.launch.steps import make_train_state

cfg = configs.smoke("gemma-2b")
mesh = make_mesh((2, 2), ("data", "model"))
target = jax.eval_shape(functools.partial(make_train_state, cfg, master_in_opt=True))
ps = lambda t: SH.param_shardings(cfg, t, mesh)  # noqa: E731
sh = {"params": ps(target["params"]), "master": ps(target["master"]), "m": ps(target["m"]),
      "v": ps(target["v"]), "step": NamedSharding(mesh, P())}
step, got = CK.load(sys.argv[1], target=target, shardings=sh)
assert step == 5, step
want = make_train_state(cfg, 0, master_in_opt=True)
for a, b, s in zip(jax.tree.leaves(got), jax.tree.leaves(want), jax.tree.leaves(sh)):
    assert a.dtype == b.dtype and a.sharding.is_equivalent_to(s, a.ndim), (a.dtype, a.sharding)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
print("JAX_RESTORE_OK")
"""

_FAKE_PG = _COMMON + r"""
import sys, json
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch import configs, tree as T
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.common import param_shapes

out = {}
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    out[str(multi)] = {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names),
                       "specs": {arch: [[list(e) if isinstance(e, tuple) else e for e in s.spec]
                                        for s in T.leaves(SH.param_shardings(
                                            configs.get_config(arch),
                                            param_shapes(configs.get_config(arch)), mesh))]
                                 for arch in ARCHS}}
    dist.destroy_process_group()
raised = []
for world, multi in ((255, False), (256, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        make_production_mesh(multi_pod=multi, device_type="cpu")
    except RuntimeError as e:
        raised.append(str(e))
    dist.destroy_process_group()
out["raised"] = raised
print(json.dumps(out))
"""

_TORCH_WORKER = _COMMON + r"""
import sys
import torch, torch.distributed as dist
from torch.distributed.tensor import Shard
from repro_torch import compat, configs, tree as T
from repro_torch.checkpoint import ckpt as CK
from repro_torch.launch import sharding as SH, steps as TS
from repro_torch.models.common import param_shapes

rank, init, jax_out, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + init, rank=rank, world_size=4)
meshes = {m: compat.make_mesh(shape, names, device="cpu") for m, (shape, names) in MESHES.items()}
jx = np.load(jax_out)
out = {}


def at(arr, per):
    return arr[tuple(slice(a, b) for a, b in per[rank])]


for arch in ARCHS:
    cfg = configs.smoke(arch)
    shapes = param_shapes(cfg)
    whole = T.unflatten(shapes, [torch.from_numpy(leaf_values(s, i))
                                 for i, s in enumerate(T.leaves(shapes))])
    for m, mesh in meshes.items():
        for fsdp, mtp in OPTIONS:
            c = combo(arch, m, fsdp, mtp)
            placed = SH.place(whole, SH.param_shardings(cfg, whole, mesh, fsdp, mtp))
            out[f"p__{c}"] = np.asarray([
                np.array_equal(t.to_local().numpy(), at(w.numpy(), jx[f"p__{c}__{i}"]))
                for i, (t, w) in enumerate(zip(T.leaves(placed), T.leaves(whole)))])
for m, mesh in meshes.items():
    for b in BATCHES:
        whole = {k: torch.arange(int(np.prod(s)), dtype=torch.int32).reshape(s)
                 for k, s in batch_shapes(b).items()}
        placed = SH.place(whole, SH.batch_shardings(None, whole, mesh))
        out[f"b__{m}__{b}"] = np.asarray([
            np.array_equal(placed[k].to_local().numpy(), at(whole[k].numpy(), jx[f"b__{m}__{b}__{k}"]))
            for k in sorted(whole)])

# a placed save and an unplaced save of the same train state
cfg = configs.smoke("gemma-2b")
opts = TS.StepOptions()
state = TS.make_train_state(cfg, 0, device="cpu")
placed = SH.place(state, TS.train_state_shardings(cfg, state, meshes["22"], opts))
CK.save(f"{outdir}/placed", 3, placed, extra={"note": "x"})
if rank == 0:
    CK.save(f"{outdir}/plain", 3, TS.make_train_state(cfg, 0, device="cpu"), extra={"note": "x"})

# tests/test_substrates.py:173's reshard, on four ranks
tree = {"w": torch.arange(32.0).reshape(8, 4)}
if rank == 0:
    CK.save(f"{outdir}/ck2", 1, tree)
dist.barrier()
mesh1 = compat.make_mesh((4,), ("data",), device="cpu")
step, restored = CK.load(f"{outdir}/ck2", target=tree,
                         shardings={"w": SH.Sharding(mesh1, ("data", None))})
w = restored["w"]
out["reshard"] = np.asarray([step == 1, tuple(w.placements) == (Shard(0),),
                             torch.equal(w.to_local(), tree["w"][2 * rank:2 * rank + 2]),
                             torch.equal(w.full_tensor(), tree["w"])])

# JAX's checkpoint onto the port's placements, then saved placed for JAX
target = TS.make_train_state(cfg, 1, master_in_opt=True, device="cpu")
step, got = CK.load(sys.argv[5], target=target,
                    shardings=TS.train_state_shardings(cfg, target, meshes["22"], opts))
out["jax_step"] = np.asarray(step)
for i, t in enumerate(T.leaves(got)):
    t = t.to_local() if hasattr(t, "to_local") else t
    out[f"jx__{i}"] = t.to(torch.float32 if t.is_floating_point() else t.dtype).numpy()
    out[f"jxdt__{i}"] = np.asarray(str(t.dtype))
CK.save(f"{outdir}/for_jax", 5, got)
np.savez(f"{outdir}/rank{rank}.npz", **out)
dist.destroy_process_group()
print("TORCH_PLACEMENTS_OK", rank)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("placements")
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"}

    def child(script, *args, ok):
        r = subprocess.run([sys.executable, "-c", script, *map(str, args)], capture_output=True,
                           text=True, timeout=_TIMEOUT, env=env)
        assert ok in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
        return r.stdout

    child(_JAX_SCRIPT, d / "jax.npz", d / "jax_ck", ok="JAX_PLACEMENTS_OK")
    fake = json.loads(child(_FAKE_PG, ok='"raised"').strip().splitlines()[-1])
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TORCH_WORKER, str(r), str(d / "pg"), str(d / "jax.npz"), str(d),
         str(d / "jax_ck")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(_WORLD)]
    try:
        logs = [p.communicate(timeout=_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, text) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"TORCH_PLACEMENTS_OK {r}" in text, text[-3000:]
    restore = child(_JAX_RESTORE, d / "for_jax", ok="JAX_RESTORE_OK")
    return {"jax": np.load(d / "jax.npz"), "ranks": [np.load(d / f"rank{r}.npz")
                                                     for r in range(_WORLD)],
            "fake": fake, "dir": d, "restore": restore}


_SHARED: dict = {}
exec(_COMMON, _SHARED)  # noqa: S102 - the cases, as the scripts hold them


@pytest.mark.parametrize("mesh", sorted(_SHARED["MESHES"]))
@pytest.mark.parametrize("arch", _SHARED["ARCHS"])
def test_param_blocks_equal_jax_named_sharding_blocks(runs, arch, mesh):
    """Every leaf, fsdp and mamba_tp each on and off, every rank: the
    placed block is the global array at JAX's index for that coordinate."""
    for fsdp, mtp in _SHARED["OPTIONS"]:
        c = _SHARED["combo"](arch, mesh, fsdp, mtp)
        n = sum(1 for k in runs["jax"].files if k.startswith(f"p__{c}__"))
        for r, got in enumerate(runs["ranks"]):
            assert got[f"p__{c}"].shape == (n,) and got[f"p__{c}"].all(), (c, r, got[f"p__{c}"])


@pytest.mark.parametrize("mesh", sorted(_SHARED["MESHES"]))
def test_batch_blocks_equal_jax_named_sharding_blocks(runs, mesh):
    """tokens, labels and pos3 at batch 4, 2 and 1: split over the batch
    axes where dp divides the batch and it is above 1, else whole."""
    for b in _SHARED["BATCHES"]:
        for r, got in enumerate(runs["ranks"]):
            assert got[f"b__{mesh}__{b}"].all(), (mesh, b, r)


@pytest.mark.parametrize("multi", [False, True], ids=["single_pod", "multi_pod"])
def test_production_mesh_shape_names_and_specs_match_jax(runs, multi):
    jax_prod = json.loads(str(runs["jax"]["production"]))[str(multi)]
    got = runs["fake"][str(multi)]
    assert got["shape"] == jax_prod["shape"] and got["names"] == jax_prod["names"]
    for arch in _SHARED["ARCHS"]:
        assert got["specs"][arch] == jax_prod["specs"][arch], arch


def test_production_mesh_raises_with_too_few_ranks(runs):
    raised = runs["fake"]["raised"]
    assert len(raised) == 2
    assert "(16, 16) needs 256 ranks" in raised[0] and "has 255" in raised[0]
    assert "(2, 16, 16) needs 512 ranks" in raised[1] and "has 256" in raised[1]


# -------------------------------------------------------------- checkpoints
def test_placed_save_is_byte_identical_to_an_unplaced_save(runs):
    d = runs["dir"]
    placed, plain = d / "placed" / "step_00000003", d / "plain" / "step_00000003"
    names = sorted(os.listdir(plain))
    assert names == sorted(os.listdir(placed)) and "manifest.json" in names
    _, mismatch, errors = filecmp.cmpfiles(plain, placed, names, shallow=False)
    assert not mismatch and not errors, (mismatch, errors)


def test_checkpoint_reshard_onto_four_ranks(runs):
    """tests/test_substrates.py:173's twin: saved whole, restored as
    ``P("data", None)`` over four ranks, each rank holding its two rows."""
    for got in runs["ranks"]:
        assert got["reshard"].all(), got["reshard"]


def test_jax_checkpoint_restores_onto_port_placements(runs):
    """JAX's train state (bf16 params, float32 master): each rank's block
    of every leaf bitwise, in the target's dtypes; step 5."""
    from repro_torch import convert
    from repro_torch.launch import sharding as TSH
    from repro_torch.models.common import param_shapes

    cfg = tconfigs.smoke("gemma-2b")

    class _Mesh:
        mesh_dim_names, shape = ("data", "model"), (2, 2)

    from repro_torch import tree as T

    specs = [s.spec for s in T.leaves(TSH.param_shardings(cfg, param_shapes(cfg), _Mesh()))]
    order = ["m", "master", "params", "step", "v"]  # the state's leaf order
    leaf_specs = [sp for k in order for sp in ([()] if k == "step" else specs)]
    jx = runs["jax"]
    for r, got in enumerate(runs["ranks"]):
        assert int(got["jax_step"]) == 5
        for i, spec in enumerate(leaf_specs):
            want = convert.block_from_jax(jx[f"st__{i}"], spec, (2, 2), ("data", "model"), r)
            np.testing.assert_array_equal(got[f"jx__{i}"], want)
        n = len(specs)
        params = range(2 * n, 3 * n)  # after m and master
        assert all(str(got[f"jxdt__{i}"]) == "torch.bfloat16" for i in params)


def test_port_placed_checkpoint_restores_in_jax(runs):
    """The port's placed save of that state, restored by JAX's ``load``
    under its NamedShardings on a (2, 2) mesh: JAX's own state, bitwise."""
    assert "JAX_RESTORE_OK" in runs["restore"]
