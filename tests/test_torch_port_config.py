"""The port's own configuration against the JAX package's, and the rule that
the port imports nothing of the JAX package.

`step_tpu_torch/config.py` is a copy of `step_tpu/config.py`: every preset
and the default config must give the same fields with the same values.
The import guard runs in a fresh interpreter whose import system refuses
`jax*`, `step_tpu` / `step_tpu.*` and flax, orbax and optax (which import
JAX), and imports every module of the port
(the CLIs and the UCF reader among them, with cv2 left unimported) and
`chip_smoke.py` (as a module, without running it); tensorstore and msgpack
are left unimported.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
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
        if (top.startswith("jax") or top in ("step_tpu", "flax", "orbax", "optax")):
            raise ImportError(f"refused import of {name}")
        return None

for mod in list(sys.modules):
    if mod.split(".")[0] in ("jax", "jaxlib", "step_tpu", "flax", "orbax", "optax"):
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
# the two-process test's worker, which the test spawns
spec = importlib.util.spec_from_file_location("dist_worker", "tests/_torch_dist_worker.py")
dist_worker = importlib.util.module_from_spec(spec)
spec.loader.exec_module(dist_worker)
dist_worker.eval_models(), dist_worker.fit_loader(2, 1)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("step_tpu", "flax", "orbax", "optax")
             or m.split(".")[0].startswith("jax"))
assert not bad, bad
# tensorstore (the orbax reader) and msgpack are never imported by the port
# (the variables files carry their own codec), tensorstore only lazily
assert "tensorstore" not in sys.modules and "msgpack" not in sys.modules
# cv2 is imported where a frame is read or written, never at import
assert "cv2" not in sys.modules
print(" ".join(names))
"""

# Modules the guard must reach: the evaluation slice's, AVA's and the
# pretrained start's, int8 moments', the classifier's, serving's, data
# parallelism's and the checkpoint and variables bridge's among them. The
# guard refuses flax, orbax and optax too, which import JAX.
_MUST_WALK = ("step_tpu_torch.cli.train", "step_tpu_torch.cli.test",
              "step_tpu_torch.data.ucf", "step_tpu_torch.data.native_loader",
              "step_tpu_torch.data.augmentations", "step_tpu_torch.utils.cli",
              "step_tpu_torch.evaluate", "step_tpu_torch.train_eval_synth",
              "step_tpu_torch.data.ava", "step_tpu_torch.eval.ava_eval",
              "step_tpu_torch.models.convert", "step_tpu_torch.train.optim_int8",
              "step_tpu_torch.cli.classify", "step_tpu_torch.utils.export",
              "step_tpu_torch.utils.vis", "step_tpu_torch.cli.export",
              "step_tpu_torch.cli.serve", "step_tpu_torch.cli.demo",
              "step_tpu_torch.parallel.mesh", "step_tpu_torch.parallel.distributed",
              "step_tpu_torch.data.memory", "step_tpu_torch.utils.msgpack_codec",
              "step_tpu_torch.utils.jax_checkpoint", "step_tpu_torch.utils.checkpoint",
              "step_tpu_torch.train.fit", "step_tpu_torch.convert")


def test_port_and_chip_smoke_import_nothing_of_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", _GUARD], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    walked = proc.stdout.split()
    assert len(walked) >= 20                            # every module was walked
    assert not set(_MUST_WALK) - set(walked), set(_MUST_WALK) - set(walked)
