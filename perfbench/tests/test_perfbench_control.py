"""The control: the plain reference computed in float8 in the program's
place comes out not correct, where the program itself is correct.  At a
size the CPU holds; the cells' own readings are taken on the card by
``perfbench/control.py`` (PERF.md gives them)."""
from __future__ import annotations

import pytest
import torch

from perfbench.harness import check as CK
from perfbench.harness import spec as SP
from perfbench import control


@pytest.mark.parametrize("name", ["tiny-mamba.tiny", "tiny-jamba.tiny"])
def test_float8_control_fails_where_the_program_passes(bench_root, name):
    cell = SP.load_cell(name, bench_root)
    seeds = [21, 22, 2**32 + 23]
    rows = control.readings(cell, seeds, set(seeds), torch.device("cpu"))
    for row in rows:
        program = {k: row[k] for k in cell.limits}
        low = {k: row.get(f"fp8_{k}", row[k]) for k in cell.limits}
        assert CK.verdict(program, cell.limits), program
        assert not CK.verdict(low, cell.limits), low
