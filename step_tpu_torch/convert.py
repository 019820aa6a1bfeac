"""The weight bridge: JAX variables → this package's state_dict.

Takes the JAX package's `{"params", "batch_stats"}` tree of
`step_tpu.models.detector.STEPDetector` — nested dicts of numpy (or JAX)
arrays, unfolded or BN-folded by `step_tpu.models.optimize` — and returns
the `state_dict` of `step_tpu_torch.models.detector.STEPDetector`:

  * conv kernels DHWIO → OIDHW (the inverse of
    `step_tpu/models/convert.py::_conv_kernel`);
  * Dense kernels `[in, out]` → `[out, in]`;
  * BatchNorm `scale/bias` → `weight/bias`, `mean/var` →
    `running_mean/running_var`;
  * the per-step parameters, stacked on axis 0 by `nn.scan`
    (`step_tpu/models/detector.py:177-186`) under `steps/head/…`, →
    `steps.{s}.…`.

Every leaf is mapped or the conversion raises; the names otherwise carry
over unchanged (`features/stem_rgb/Mixed_3b/b0/conv/kernel` →
`features.stem_rgb.Mixed_3b.b0.conv.weight`).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from step_tpu_torch.config import StepConfig

_STATS = {"mean": "running_mean", "var": "running_var"}


def _leaves(tree, path=()):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    else:
        yield path, tree


def _leaf(collection: str, path, arr: np.ndarray):
    """(torch parameter name, converted array) for one JAX leaf."""
    name = path[-1]
    if collection == "batch_stats" and name in _STATS:
        return _STATS[name], arr
    if collection == "params":
        if name == "kernel" and arr.ndim == 5:
            return "weight", arr.transpose(4, 3, 0, 1, 2)
        if name == "kernel" and arr.ndim == 2:
            return "weight", arr.T
        if name == "scale":
            return "weight", arr
        if name == "bias":
            return "bias", arr
    raise KeyError(f"no mapping for {collection}/{'/'.join(path)} "
                   f"with shape {arr.shape}")


def from_jax_variables(variables, cfg: StepConfig) -> Dict[str, torch.Tensor]:
    """JAX detector variables → state_dict for the detector built from
    `cfg` (with `bn_folded` set as the tree is folded or not)."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            arr = np.asarray(leaf, np.float32)
            if path[0] == "steps":
                if path[1] != "head" or arr.shape[0] != cfg.num_steps:
                    raise KeyError(f"{collection}/{'/'.join(path)}: expected "
                                   f"steps/head/… stacked {cfg.num_steps} deep, "
                                   f"got shape {arr.shape}")
                for s in range(cfg.num_steps):
                    name, value = _leaf(collection, path, arr[s])
                    key = ".".join(("steps", str(s)) + path[2:-1] + (name,))
                    sd[key] = torch.tensor(value)
            else:
                name, value = _leaf(collection, path, arr)
                sd[".".join(path[:-1] + (name,))] = torch.tensor(value)
    return sd
