"""No module of JAX or of the JAX package in the run's process: top-level
names compared whole."""
from __future__ import annotations

import subprocess
import sys

from conftest import ROOT
from perfbench.harness.guard import forbidden_modules


def test_names_are_compared_whole():
    assert forbidden_modules(["repro_torch", "repro_torch.models.model", "reprox", "jaxtyping"]) \
        == []
    assert forbidden_modules(["repro", "repro_torch"]) == ["repro"]
    assert forbidden_modules(["repro.core.ad", "jax._src.api", "jaxlib", "flax.linen"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    # a fresh process, so that nothing the test runner loaded counts
    code = f"""
import sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}, {str(ROOT / 'perfbench' / 'tests')!r}]
from pathlib import Path
import conftest
root = conftest.make_bench_root(Path({str(tmp_path)!r}))
res = conftest.run_tiny(root, "tiny-jamba.tiny", trace=True)
from perfbench.harness.guard import forbidden_modules
assert res["correct"], res["checks"]
print("FORBIDDEN", forbidden_modules())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert "FORBIDDEN []" in p.stdout


def test_a_loaded_jax_package_refuses_the_result(bench_root, monkeypatch):
    import types

    import pytest

    from perfbench.harness import cli

    monkeypatch.setitem(sys.modules, "repro", types.ModuleType("repro"))
    with pytest.raises(cli.ForbiddenModules, match="repro"):
        from conftest import run_tiny

        run_tiny(bench_root, "tiny-mamba.tiny")
