"""The port and ``chip_smoke.py`` import nothing of JAX or the JAX package.

A subprocess installs a ``sys.meta_path`` finder that raises on ``jax``,
``jaxlib``, ``flax`` and ``cswin_unet_tpu`` (with its submodules; not
``cswin_unet_tpu_torch``), then imports every module of the port, walked
with ``pkgutil``, and ``chip_smoke`` as a module. The machine that runs the
port has no JAX, and the JAX package stays the reference: neither may be
needed to import the port.
"""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = """
import importlib, importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "flax", "cswin_unet_tpu")

def blocked(name):
    return name.split(".")[0] in BLOCKED

for name in [m for m in sys.modules if blocked(m)]:
    del sys.modules[name]

class Guard(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if blocked(name):
            raise ImportError(f"the port imported {name}")
        return None

sys.meta_path.insert(0, Guard())
"""

IMPORT_ALL = """
import pkgutil
import cswin_unet_tpu_torch
names = ["cswin_unet_tpu_torch"]
for info in pkgutil.walk_packages(cswin_unet_tpu_torch.__path__,
                                  "cswin_unet_tpu_torch."):
    importlib.import_module(info.name)
    names.append(info.name)
import chip_smoke
names.append(chip_smoke.__name__)
print(" ".join(names))
"""


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_and_chip_smoke_import_no_jax_package():
    res = _run(GUARD + IMPORT_ALL)
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(res.stdout.split())
    assert {"cswin_unet_tpu_torch.config", "cswin_unet_tpu_torch.serve",
            "cswin_unet_tpu_torch.eval.__main__", "cswin_unet_tpu_torch.train.__main__",
            "cswin_unet_tpu_torch.ops.edt", "cswin_unet_tpu_torch.ops.cuda.kernels",
            "cswin_unet_tpu_torch.tools.block_lab", "cswin_unet_tpu_torch.tools.probe_chain",
            "cswin_unet_tpu_torch.tools.tile_ab",
            "cswin_unet_tpu_torch.utils.checkpoint", "cswin_unet_tpu_torch.finetune",
            "cswin_unet_tpu_torch.universal_train", "cswin_unet_tpu_torch.universal_test",
            "cswin_unet_tpu_torch.train.surgical", "cswin_unet_tpu_torch.train.tpgm",
            "cswin_unet_tpu_torch.train.finetune", "cswin_unet_tpu_torch.train.continual",
            "cswin_unet_tpu_torch.data.synthetic", "chip_smoke"} <= names, sorted(names)


@pytest.mark.parametrize("module", ["jax", "flax.linen", "cswin_unet_tpu.config",
                                    "cswin_unet_tpu.utils.nifti"])
def test_guard_refuses_the_jax_side(module):
    """The finder is live: the same subprocess prologue refuses each name."""
    res = _run(GUARD + f"import {module}\n")
    assert res.returncode != 0 and f"the port imported {module.split('.')[0]}" in res.stderr
