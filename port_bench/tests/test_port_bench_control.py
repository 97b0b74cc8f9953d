"""The control: the plain reference computed in float8, put in the
program's place, reads above the cell's limits, while the program reads
under them. At a small size on the CPU, and at each cell's own size on the
card (``cuda``)."""

from __future__ import annotations

import pytest
import torch

from port_bench import harness
from port_bench.control import serve_readings, train_readings

from .small import small_cell

CELLS = ["base384-train-bs24", "tiny224-serve-vol", "base384-serve-vol"]


def _readings(cell, seed, device):
    read = train_readings if cell["traffic_data"]["mode"] == "train" else serve_readings
    return {row["kind"]: row for row in read(cell, seed, True, device)}


def _fails(row, limits) -> bool:
    return any(row[k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", CELLS[:2])
def test_control_fails_at_a_small_size(name):
    cell = small_cell(name)
    rows = _readings(cell, 21, torch.device("cpu"))
    assert not _fails(rows["program"], cell["limits"]), rows
    assert _fails(rows["control_fp8"], cell["limits"]), rows
    if "fault_half_batch" in rows:
        assert _fails(rows["fault_half_batch"], cell["limits"]), rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cell_size(name, cuda_device):
    cell = harness.load_cell(name)
    rows = _readings(cell, 31, cuda_device)
    assert not _fails(rows["program"], cell["limits"]), rows
    assert _fails(rows["control_fp8"], cell["limits"]), rows
