"""The control: the plain reference computed one precision below the
configuration's (float8 below bfloat16, TF32 below float32), put in the
program's place, reads above the cell's limits, while the program reads
under them. At a small size on the CPU, and at each cell's own size on the
card (``cuda``)."""

from __future__ import annotations

import pytest
import torch

from port_bench import harness
from port_bench import reference as R
from port_bench.control import control_kind, serve_readings, train_readings

from .small import SMALL, small_cell

CELLS = ["base384-train-bs24", "tiny224-serve-vol", "base384-serve-vol", "base384-train-f32"]


def _readings(cell, seed, device):
    read = train_readings if cell["traffic_data"]["mode"] == "train" else serve_readings
    return {row["kind"]: row for row in read(cell, seed, True, device)}


def _fails(row, limits) -> bool:
    return any(row[k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", CELLS[:2] + CELLS[3:])
def test_control_fails_at_a_small_size(name):
    cell = small_cell(name)
    rows = _readings(cell, 21, torch.device("cpu"))
    assert not _fails(rows["program"], cell["limits"]), rows
    assert _fails(rows[control_kind(cell["config_data"])], cell["limits"]), rows
    if "fault_half_batch" in rows:
        assert _fails(rows["fault_half_batch"], cell["limits"]), rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_at_the_cell_size(name, cuda_device):
    cell = harness.load_cell(name)
    rows = _readings(cell, 31, cuda_device)
    assert not _fails(rows["program"], cell["limits"]), rows
    assert _fails(rows[control_kind(cell["config_data"])], cell["limits"]), rows


@pytest.mark.parametrize("dtype,kind", [("bfloat16", "control_fp8"), ("float32", "control_tf32")])
def test_the_control_follows_compute_dtype(dtype, kind):
    assert control_kind(dict(SMALL, compute_dtype=dtype)) == kind
    assert R.Numerics(dtype).low == kind.removeprefix("control_")
    assert R.Numerics().low is None


def test_no_control_for_another_dtype():
    with pytest.raises(ValueError):
        R.Numerics("float16")

