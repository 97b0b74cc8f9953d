"""Nothing the benchmark runs loads JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), the plain
reference loads nothing of the port, and without the port a run fails."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest

from port_bench import harness

BANNED = set(harness.FORBIDDEN)
# The plain reference and the yardstick: no module of the program either.
STANDALONE = ("reference", "weights", "work", "check", "traffic", "trace", "rooflines")


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(p for p in harness.HERE.rglob("*.py")
                                        if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax_import_in_sources(path):
    assert not _imports(path) & BANNED
    if path.parent == harness.HERE and path.stem in STANDALONE:
        assert "cswin_unet_tpu_torch" not in _imports(path)


def _modules_after(code: str) -> list[str]:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.HERE.parent, timeout=600, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_loads_nothing_of_the_port():
    mods = _modules_after(
        "import sys, json\n"
        "import port_bench.reference, port_bench.weights, port_bench.check, port_bench.work\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('cswin_unet_tpu_torch', 'jax', 'jaxlib', 'flax', 'cswin_unet_tpu'))))")
    assert mods == []


def test_a_run_loads_no_jax():
    mods = _modules_after(
        "import sys, json\n"
        "from port_bench.tests.small import small_cell\n"
        "from port_bench.run import run_cell\n"
        "from port_bench import harness\n"
        "for name in ('base384-train-bs24', 'tiny224-serve-vol'):\n"
        "    run_cell(name, 5, 0.3, True, device='cpu', cell=small_cell(name))\n"
        "assert 'cswin_unet_tpu_torch' in sys.modules\n"
        "print(json.dumps(harness.forbidden_modules()))")
    assert mods == []


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.HERE.parent / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; sys.path.insert(0, '.')\n"
         "from port_bench.tests.small import small_cell\n"
         "from port_bench.run import run_cell\n"
         "run_cell('tiny224-serve-vol', 5, 0.3, False, device='cpu',"
         " cell=small_cell('tiny224-serve-vol'))\n"
         "print('result')"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and "result" not in out.stdout
    assert "cswin_unet_tpu_torch" in out.stderr
