"""Port's checkpoint format and monitored training driver vs the JAX package.

A checkpoint written by either package restores in the other bit for bit
(bf16 leaves included), and both write the same files for the same tree.
The port's ``train()`` resumes exactly after an injected failure, and from
a checkpoint the JAX package wrote it trains as the JAX driver does: per-
step losses within rtol 2e-2, JAX run in a child process with XLA's excess
precision off (see tests/test_torch_models.py).
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.checkpoint import ckpt as JCK  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import ckpt as CK  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


def _mixed_tree(seed=0):
    """numpy leaves of every stored kind: float32, int32, bf16, a scalar."""
    rng = np.random.default_rng(seed)
    return {
        "w": rng.normal(0, 1, (5, 3)).astype(np.float32),
        "layers": [{"q": rng.normal(0, 1, (2, 4)).astype(ml_dtypes.bfloat16)},
                   {"q": rng.normal(0, 1, (2, 4)).astype(ml_dtypes.bfloat16)}],
        "step": np.asarray(7, np.int32),
        "ids": np.arange(6, dtype=np.int32).reshape(2, 3),
    }


def _torch_leaf(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        t = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        return t.numpy().tobytes()
    return np.asarray(t).tobytes()


# ------------------------------------------------------- substrate twins
def test_checkpoint_atomic_and_resume(tmp_path):
    """Twin of tests/test_substrates.py:135."""
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    p = str(tmp_path / "ck")
    CK.save(p, 10, tree)
    CK.save(p, 20, T.map(lambda x: x * 2, tree))
    assert CK.latest_step(p) == 20
    step, restored = CK.load(p, target=tree)
    assert step == 20
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(6).reshape(2, 3) * 2)
    assert restored["b"]["c"].dtype == torch.bfloat16
    step, r10 = CK.load(p, step=10, target=tree)  # older step still loadable
    np.testing.assert_array_equal(r10["a"].numpy(), np.arange(6).reshape(2, 3))
    os.makedirs(os.path.join(p, "step_00000030.tmp"))  # a stale tmp dir is not a checkpoint
    assert CK.latest_step(p) == 20
    CK.prune(p, keep=1)
    assert CK.latest_step(p) == 20
    with pytest.raises(FileNotFoundError):
        CK.load(p, step=10)


def test_checkpoint_manager_async(tmp_path):
    """Twin of tests/test_substrates.py:157."""
    mgr = CK.CheckpointManager(str(tmp_path / "ck"), interval=5, keep=2, async_save=True)
    tree = {"w": torch.zeros((8, 8))}
    saved = 0
    for step in range(1, 21):
        tree["w"].add_(1)  # in place, as the train step updates: the snapshot is a copy
        saved += int(mgr.maybe_save(step, tree))
    mgr.wait()
    assert saved == 4  # steps 5, 10, 15, 20
    step, restored = mgr.restore_or_none(target=tree)
    assert step == 20
    np.testing.assert_array_equal(restored["w"].numpy(), np.full((8, 8), 20.0))
    _, r15 = CK.load(str(tmp_path / "ck"), step=15)
    np.testing.assert_array_equal(r15[0].numpy(), np.full((8, 8), 15.0))


def test_checkpoint_reshard(tmp_path):
    """Twin of tests/test_substrates.py:173: restore onto another layout.
    Without meshes the port's elastic restore is a change of dtype and
    device taken from the target; ``shardings=`` waits for item 11."""
    p = str(tmp_path / "ck2")
    CK.save(p, 1, {"w": torch.arange(32.0).reshape(8, 4)})
    target = {"w": torch.empty((8, 4), dtype=torch.float64)}
    step, restored = CK.load(p, target=target)
    assert step == 1 and restored["w"].dtype == torch.float64
    np.testing.assert_array_equal(restored["w"].numpy(), np.arange(32.0).reshape(8, 4))
    with pytest.raises(NotImplementedError, match="item 11"):
        CK.load(p, target=target, shardings={"w": None})
    with pytest.raises(ValueError, match="differ from the target"):
        CK.load(p, target={"v": target["w"]})


# ------------------------------------------------------- cross-load
def test_jax_checkpoint_restores_bit_exactly_in_the_port(tmp_path):
    tree = _mixed_tree(1)
    JCK.save(str(tmp_path), 3, jax.tree.map(jnp.asarray, tree), extra={"k": 1})
    target = T.map(_torch_leaf, _mixed_tree(2))  # other values, same leaves
    step, got = CK.load(str(tmp_path), target=target)
    assert step == 3
    for (key, g), t, w in zip(T.paths(got), T.leaves(target), jax.tree.leaves(tree)):
        assert g.dtype == t.dtype and _bits(g) == np.asarray(w).tobytes(), key
    _, flat = CK.load(str(tmp_path))  # no target: CPU tensors in manifest order
    assert [_bits(g) for g in flat] == [np.asarray(w).tobytes() for w in jax.tree.leaves(tree)]
    assert flat[2].dtype == torch.bfloat16


def test_port_checkpoint_restores_bit_exactly_in_jax(tmp_path):
    tree = _mixed_tree(3)
    CK.save(str(tmp_path), 4, T.map(_torch_leaf, tree))
    target = jax.tree.map(jnp.asarray, _mixed_tree(4))
    step, got = JCK.load(str(tmp_path), target=target)
    assert step == 4
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(tree)):
        assert g.dtype == w.dtype and np.asarray(g).tobytes() == np.asarray(w).tobytes()


def test_both_packages_write_the_same_files(tmp_path):
    tree = _mixed_tree(5)
    JCK.save(str(tmp_path / "jax"), 9, jax.tree.map(jnp.asarray, tree), extra={"e": [1, 2]})
    CK.save(str(tmp_path / "port"), 9, T.map(_torch_leaf, tree), extra={"e": [1, 2]})
    dj, dt = tmp_path / "jax" / "step_00000009", tmp_path / "port" / "step_00000009"
    assert sorted(os.listdir(dj)) == sorted(os.listdir(dt))
    for name in os.listdir(dj):
        assert (dj / name).read_bytes() == (dt / name).read_bytes(), name
    manifest = json.loads((dt / "manifest.json").read_text())
    assert [leaf["key"] for leaf in manifest["leaves"]] == \
        [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert "bfloat16" in [leaf["dtype"] for leaf in manifest["leaves"]]


@pytest.mark.parametrize("master_in_opt", [False, True])
def test_train_state_cross_loads_both_ways(tmp_path, master_in_opt):
    """A JAX train state (bf16 params beside a float32 master too) restores
    into the port's make_train_state bit for bit, equals
    convert.train_state_from_jax, and goes back."""
    jcfg, tcfg = jconfigs.smoke("gemma-2b"), tconfigs.smoke("gemma-2b")
    jstate = JS.make_train_state(jcfg, 0, master_in_opt=master_in_opt)
    jstate["step"] = jnp.asarray(5, jnp.int32)
    JCK.save(str(tmp_path / "j"), 5, jstate)
    target = TS.make_train_state(tcfg, 1, master_in_opt=master_in_opt, device="cpu")
    step, got = CK.load(str(tmp_path / "j"), target=target)
    carried = convert.train_state_from_jax(jax.tree.map(np.asarray, jstate), tcfg, device="cpu")
    assert step == 5 and int(got["step"]) == 5 and got["step"].dtype == torch.int32
    assert sorted(got) == sorted(carried) == sorted(jstate)
    for (key, g), c, w in zip(T.paths(got), T.leaves(carried), jax.tree.leaves(jstate)):
        assert g.dtype == c.dtype and _bits(g) == _bits(c) == np.asarray(w).tobytes(), key
    CK.save(str(tmp_path / "t"), 5, got)
    _, back = JCK.load(str(tmp_path / "t"), target=jstate)
    for b, w in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        assert np.asarray(b).tobytes() == np.asarray(w).tobytes()
    as_np = convert.train_state_to_numpy(got)
    for a, w in zip(jax.tree.leaves(as_np), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(a, np.asarray(w, np.float32) if a.dtype == np.float32
                                      else np.asarray(w))


# ------------------------------------------------------- the driver
_KW = dict(arch="gemma-2b", global_batch=4, seq=32, log_every=100, device="cpu")


def test_restart_exact_resume(tmp_path):
    """Twin of tests/test_training.py:63: crash at step 12, resume from the
    step-10 checkpoint, the same final loss as an uninterrupted run."""
    kw = dict(steps=20, ckpt_interval=5, **_KW)
    full = train(ckpt_dir=str(tmp_path / "a"), **kw)
    with pytest.raises(RuntimeError):
        train(ckpt_dir=str(tmp_path / "b"), fail_at=12, **kw)
    resumed = train(ckpt_dir=str(tmp_path / "b"), **kw)
    assert resumed["history"][0]["step"] == 10  # resumed from step-10 ckpt
    np.testing.assert_allclose(full["final_loss"], resumed["final_loss"], rtol=1e-5)


@pytest.fixture
def one_thread():
    """One intra-op thread: a step of the smoke model then takes about as
    long under a loaded test run as alone, and the injected 0.5 s delay
    stands out of the step times as it does in the JAX twin (JAX's jitted
    step is steadier than eager ops spread over every core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_straggler_mitigation_hook(one_thread):
    """Twin of tests/test_training.py:78."""
    out = train(steps=30, inject_straggler_at=25, **_KW)
    assert out["monitor"]["stragglers"] >= 1


def test_monitored_run_writes_the_jax_drivers_outputs(tmp_path):
    mon = tmp_path / "mon"
    out = train(steps=6, monitor_dir=str(mon), export_trace=True, **_KW)
    assert sorted(os.listdir(mon)) == ["history.json", "provenance.jsonl", "stream.jsonl",
                                       "trace.json", "viz.json"]
    assert [h["step"] for h in json.loads((mon / "history.json").read_text())] == list(range(6))
    # step, data and fwd_bwd_update spans: an ENTRY and an EXIT each per step
    assert out["monitor"]["frames"] == 6 and out["monitor"]["events"] == 6 * 6
    info = json.loads((mon / "provenance.jsonl").read_text().splitlines()[0])
    assert info["type"] == "run_info" and info["arch"] == "gemma-2b"
    assert info["torch_version"] == torch.__version__ and info["device"] == "cpu"
    assert info["cuda_version"] == torch.version.cuda and info["device_name"] == "cpu"


@pytest.mark.parametrize("kw,item", [(dict(viz_port=0), "item 2d")])
def test_unported_driver_options_raise_naming_their_item(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        train(steps=1, **_KW, **kw)


@pytest.mark.parametrize("kw,want", [
    (dict(ps_transport="socket", shard_endpoints="spawn:2"), dict(ps_transport="socket")),
    (dict(provdb_transport="socket", shard_endpoints="spawn:2"),
     dict(provdb_transport="socket", provdb_shards=2)),
    (dict(ps_transport="socket", shard_endpoints="spawn:1", supervise=True),
     dict(ps_transport="socket", ps_shards=1)),
    (dict(ps_transport="socket", shard_endpoints="spawn:2", ps_wal="wal"),
     dict(ps_transport="socket", ps_shards=2)),
])
def test_driver_socket_and_wal_options_run(tmp_path, kw, want):
    """The options that waited for items 2a and 2b (socket transports,
    --shard-endpoints, --supervise, --ps-wal) run as in the JAX driver."""
    if "ps_wal" in kw:
        kw = {**kw, "ps_wal": str(tmp_path / kw["ps_wal"])}
    out = train(steps=2, **_KW, **kw)
    assert {k: out["monitor"][k] for k in want} == want
    assert out["monitor"]["frames"] == 2 and out["monitor"]["health"]["ok"]
    if "ps_wal" in kw:
        assert sorted(os.listdir(kw["ps_wal"])) == ["ps_shard0.wal", "ps_shard1.wal"]


def test_socket_transport_without_endpoints_raises_as_jax():
    with pytest.raises(ValueError, match="needs --shard-endpoints"):
        train(steps=1, ps_transport="socket", **_KW)


_JAX_DRIVER_SCRIPT = r"""
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
from repro.launch.train import train
out = train(arch="gemma-2b", steps=6, global_batch=4, seq=32, log_every=100,
            ckpt_dir=sys.argv[1])
print("LOSSES", json.dumps([h["loss"] for h in out["history"]]))
"""


def test_driver_parity_from_a_jax_checkpoint(tmp_path):
    """Both train() drivers resume from copies of one JAX step-0 checkpoint
    (the cross-load is the only bridge) and take 6 smoke steps."""
    jstate = JS.make_train_state(jconfigs.smoke("gemma-2b"), 0)
    JCK.save(str(tmp_path / "j0"), 0, jstate)
    shutil.copytree(tmp_path / "j0", tmp_path / "jax")
    shutil.copytree(tmp_path / "j0", tmp_path / "port")
    r = subprocess.run(
        [sys.executable, "-c", _JAX_DRIVER_SCRIPT, str(tmp_path / "jax")],
        capture_output=True, text=True, timeout=150,
        env={**os.environ, "PYTHONPATH": str(REPO / "src"), "JAX_PLATFORMS": "cpu"},
    )
    line = [s for s in r.stdout.splitlines() if s.startswith("LOSSES ")]
    assert line, r.stdout[-2000:] + r.stderr[-3000:]
    want = json.loads(line[0][len("LOSSES "):])
    got = train(steps=6, ckpt_dir=str(tmp_path / "port"), **_KW)
    assert [h["step"] for h in got["history"]] == list(range(6))
    np.testing.assert_allclose([h["loss"] for h in got["history"]], want, rtol=2e-2)
    assert CK.latest_step(str(tmp_path / "port")) == JCK.latest_step(str(tmp_path / "jax")) == 6
