"""Every configuration, cell, traffic and metric is found by its name, and a
new one is found by adding its file alone."""

from __future__ import annotations

import json
import shutil

import pytest

from port_bench import harness

BENCH = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_load(cell):
    c = harness.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c["config"] == entry["config"] and c["traffic"] == entry["traffic"]
    assert c["chips"] == entry["chips"]
    harness.driver(c["traffic_data"]["mode"])
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]])}
    assert set(c["end_to_end"]) == e2e


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_load(config):
    data = harness.load_json("configs", config["name"])
    assert (harness.HERE.parent / config["file"]).is_file()
    assert data["name"] == config["name"] and data["source"] == config["source"]


def test_every_per_layer_metric_has_a_reader():
    found = harness.readers()
    for m in BENCH["per_layer"]:
        assert m["name"] in found, m["name"]
        assert found[m["name"]].UNIT == m["unit"]


@pytest.mark.parametrize("name", sorted(p.stem for p in (harness.HERE / "workloads").glob("*.json")))
def test_every_workload_file_resolves(name):
    cell = harness.load_cell(name)
    assert set(cell["limits"]) and cell["chips"] == 1
    harness.driver(cell["traffic_data"]["mode"])


def test_new_files_are_found_with_no_edit(tmp_path):
    root = tmp_path / "port_bench"
    shutil.copytree(harness.HERE, root, ignore=shutil.ignore_patterns("__pycache__"))
    (root / "configs" / "small.json").write_text(json.dumps({"name": "small"}))
    (root / "traffic" / "short-volumes.json").write_text(json.dumps(
        {"mode": "serve_volumes", "depth_min": 20, "depth_max": 40, "pool": 3}))
    (root / "workloads" / "small-serve.json").write_text(json.dumps(
        {"config": "small", "traffic": "short-volumes", "chips": 1,
         "end_to_end": ["serve_slices_per_s", "setup_s"], "limits": {"logit_gap": 1.0}}))
    (root / "metrics" / "volumes_per_s.serve.py").write_text(
        'UNIT = "volumes/s"\n\n\ndef read(ctx):\n'
        '    return ctx.window["volumes"] / ctx.window["seconds"]\n')
    cell = harness.load_cell("small-serve", root)
    assert cell["config_data"]["name"] == "small"
    assert cell["traffic_data"]["depth_max"] == 40
    readers = harness.readers(root)
    assert "volumes_per_s.serve" in readers
    ctx = harness.Context("serve_volumes", {}, {}, {"volumes": 10, "seconds": 2.0}, None)
    assert readers["volumes_per_s.serve"].read(ctx) == 5.0
    with pytest.raises(FileNotFoundError):
        harness.load_cell("no-such-cell", root)
