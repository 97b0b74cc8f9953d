"""The readings that a cell's limits are set from: the program's on many
seeds, and on a few seeds the control's and the planted faults'.

    python port_bench/control.py --workload <cell> --seeds 11 12 ... \
        --control-seeds 11 12 13 [--out FILE]

Each reading is the cell's compared numbers (``check``), with the program
as the cell runs it, against the float32 reference. The control is the
reference computed one precision below the configuration's
``compute_dtype`` (``reference.Numerics(compute_dtype)``: float8 below
bfloat16, TF32 below float32) in the program's place, its readings of kind
``control_<fp8|tf32>``. A training cell also reads, on the control seeds,
the program stepping on half of each batch (its loss the mean over that
half), and names the leaf that sets each leaf gap.
Not a benchmark run: nothing is timed. Prints one JSON line a reading and
writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from port_bench import harness  # noqa: E402
from port_bench.check import train_gaps  # noqa: E402
from port_bench.reference import CONTROLS  # noqa: E402


def control_kind(cfg: dict) -> str:
    """The kind of the control's readings of a configuration."""
    return "control_" + CONTROLS[cfg["compute_dtype"]][0]


def train_readings(cell: dict, seed: int, control: bool, device) -> list[dict]:
    from port_bench.drivers.train import TrainRun

    cfg, traffic, rows = cell["config_data"], cell["traffic_data"], cell["reference_rows"]
    r = TrainRun(cfg, traffic, seed, device)
    prog = r.checked_steps()
    half = None
    if control:
        r.free()
        h = TrainRun(cfg, traffic, seed, device)
        b = traffic["batch"] // 2
        half = h.checked_steps([(x[:b], y[:b]) for x, y in h.pool])
        h.free()
    r.free()
    ref = r.reference(rows)
    out = [dict(seed=seed, kind="program", **train_gaps(prog, ref, worst=True))]
    if control:
        out.append(dict(seed=seed, kind=control_kind(cfg),
                        **train_gaps(r.reference(rows, control=True), ref, worst=True)))
        out.append(dict(seed=seed, kind="fault_half_batch",
                        **train_gaps(half, ref, worst=True)))
    return out


def serve_readings(cell: dict, seed: int, control: bool, device) -> list[dict]:
    from port_bench.drivers.serve_volumes import ServeRun

    r = ServeRun(cell["config_data"], cell["traffic_data"], seed, device)
    r.warm()
    for _ in r.volumes:  # the pool once through, one client, closed loop
        r.send()
    r.free()
    rows = cell["reference_rows"]
    out = [dict(seed=seed, kind="program", logit_gap=r.gap(rows))]
    if control:
        out.append(dict(seed=seed, kind=control_kind(cell["config_data"]),
                        logit_gap=r.gap(rows, control=True)))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    read = train_readings if cell["traffic_data"]["mode"] == "train" else serve_readings
    rows = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        for row in read(cell, seed, seed in args.control_seeds, torch.device("cuda")):
            print(json.dumps(row), flush=True)
            rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
