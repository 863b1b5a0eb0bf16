"""The train step on a mesh for the model families beside gemma-2b:
granite-moe-1b-a400m (expert parallelism), falcon-mamba-7b (the
sequence-parallel Mamba mixer), minicpm3-4b (MLA) and jamba-v0.1-52b (all
three composed), each on the (2, 2) mesh with ``seq_shard``, against JAX's
single-device ``build_train_step``.  The harness, the inputs and the
tolerances are tests/test_torch_mesh_train.py's (its docstring states
them); this file runs its own JAX child and gloo processes, so that the
two files run side by side.
"""
import pytest

pytest.importorskip("torch")

from test_torch_mesh_train import (  # noqa: E402
    cases_of, check_gradient_blocks, check_losses_and_grad_norms, check_updated_blocks,
    run_group,
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_group(tmp_path_factory, "families")


@pytest.mark.parametrize("case", cases_of("families"))
def test_meshed_losses_and_grad_norms_match_jax(runs, case):
    check_losses_and_grad_norms(runs, case)


@pytest.mark.parametrize("case", cases_of("families"))
def test_meshed_gradient_blocks_match_jax(runs, case):
    check_gradient_blocks(runs, case)


@pytest.mark.parametrize("case", cases_of("families"))
def test_meshed_updated_blocks_match_jax(runs, case):
    check_updated_blocks(runs, case)
