"""The port's own configuration against the JAX package's, and the rule that
the port imports nothing of the JAX package.

`step_tpu_torch/config.py` is a copy of `step_tpu/config.py`: every preset
and the default config must give the same fields with the same values.
The import guard runs in a fresh interpreter whose import system refuses
`jax*` and `step_tpu` / `step_tpu.*`, and imports every module of the port
and `chip_smoke.py` (as a module, without running it).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import pytest

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.config import StepConfig as JaxStepConfig
from step_tpu_torch.config import PRESETS, StepConfig

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("name", [None, *sorted(JAX_PRESETS)])
def test_config_equals_the_jax_package(name):
    if name is None:
        ours, theirs = StepConfig(), JaxStepConfig()
    else:
        assert sorted(PRESETS) == sorted(JAX_PRESETS)
        ours, theirs = PRESETS[name], JAX_PRESETS[name]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for prop in ("total_frames", "num_cls_outputs", "feature_size",
                 "active_proposals"):
        assert getattr(ours, prop) == getattr(theirs, prop), prop


_GUARD = r"""
import importlib, importlib.util, pkgutil, sys

class Refuse:
    def find_spec(self, name, path=None, target=None):
        top = name.split(".")[0]
        if top in ("jax", "jaxlib") or top.startswith("jax") or top == "step_tpu":
            raise ImportError(f"refused import of {name}")
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in ("jax", "jaxlib", "step_tpu"):
        del sys.modules[mod]
sys.meta_path.insert(0, Refuse())

import step_tpu_torch
names = ["step_tpu_torch"]
for info in pkgutil.walk_packages(step_tpu_torch.__path__, "step_tpu_torch."):
    names.append(info.name)
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke_module", "chip_smoke.py")
smoke = importlib.util.module_from_spec(spec)
spec.loader.exec_module(smoke)
assert callable(smoke.main)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] == "step_tpu" or m.split(".")[0].startswith("jax"))
assert not bad, bad
print(len(names))
"""


def test_port_and_chip_smoke_import_nothing_of_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert int(proc.stdout.split()[-1]) >= 20          # every module was walked
