"""The weight bridge: JAX variables ↔ this package's state_dict.

Takes the JAX package's `{"params", "batch_stats"}` tree of
`step_tpu.models.detector.STEPDetector` — nested dicts of numpy (or JAX)
arrays, unfolded or BN-folded by `step_tpu.models.optimize` — and returns
the `state_dict` of `step_tpu_torch.models.detector.STEPDetector`
(`from_jax_variables`); or the tree of the JAX package's `I3DClassifier`
(`stem`, `tail`, `logits`), and returns that of the port's
(`from_jax_classifier_variables`):

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

`to_jax_variables` is the exact inverse of both, float32 to float32 bit
for bit: a 5-D or 2-D `weight` is a kernel, a 1-D one a BatchNorm scale
(`jax_path`), and the `steps.{s}.` tensors of one name are stacked in
step order.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from step_tpu_torch.config import StepConfig

_STATS = {"mean": "running_mean", "var": "running_var"}
_JAX_STATS = {v: k for k, v in _STATS.items()}


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
    return convert_tree(variables, cfg.num_steps)


def from_jax_classifier_variables(variables) -> Dict[str, torch.Tensor]:
    """JAX `I3DClassifier` variables (`stem`, `tail`, `logits`) → state_dict
    for `step_tpu_torch.models.i3d.I3DClassifier`."""
    for collection in ("params", "batch_stats"):
        extra = set(variables.get(collection, {})) - {"stem", "tail", "logits"}
        if extra:
            raise KeyError(f"{collection}/{sorted(extra)}: not an I3DClassifier tree "
                           "(stem, tail, logits)")
    return convert_tree(variables, None)


def convert_tree(variables, num_steps) -> Dict[str, torch.Tensor]:
    """Every leaf of `variables` mapped (`_leaf`), the per-step head
    parameters unstacked into `num_steps` heads (a tree without them, such
    as the classifier's, takes None)."""
    sd: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            arr = np.asarray(leaf, np.float32)
            if path[0] == "steps":
                if path[1] != "head" or arr.shape[0] != num_steps:
                    raise KeyError(f"{collection}/{'/'.join(path)}: expected "
                                   f"steps/head/… stacked {num_steps} deep, "
                                   f"got shape {arr.shape}")
                for s in range(num_steps):
                    name, value = _leaf(collection, path, arr[s])
                    key = ".".join(("steps", str(s)) + path[2:-1] + (name,))
                    sd[key] = torch.tensor(value)
            else:
                name, value = _leaf(collection, path, arr)
                sd[".".join(path[:-1] + (name,))] = torch.tensor(value)
    return sd


def jax_path(name: str, shape) -> tuple[str, tuple, int | None]:
    """The JAX leaf of the port's tensor `name` of `shape`: (collection,
    path in that collection, step) — for a per-step head's tensor the
    path under `steps/head/` and its step, else step None."""
    parts = name.split(".")
    leaf = parts[-1]
    if leaf in _JAX_STATS:
        collection, jleaf = "batch_stats", _JAX_STATS[leaf]
    elif leaf == "weight" and len(shape) in (2, 5):
        collection, jleaf = "params", "kernel"
    elif leaf == "weight" and len(shape) == 1:
        collection, jleaf = "params", "scale"
    elif leaf == "bias":
        collection, jleaf = "params", "bias"
    else:
        raise KeyError(f"no JAX leaf for {name} with shape {tuple(shape)}")
    if parts[0] == "steps":
        return collection, ("steps", "head", *parts[2:-1], jleaf), int(parts[1])
    return collection, (*parts[:-1], jleaf), None


def _to_jax_layout(arr: np.ndarray) -> np.ndarray:
    """One tensor in the JAX package's layout: OIDHW → DHWIO, `[out, in]`
    → `[in, out]`, any other as it is."""
    if arr.ndim == 5:
        return arr.transpose(2, 3, 4, 1, 0)
    if arr.ndim == 2:
        return arr.T
    return arr


def _numpy(t) -> np.ndarray:
    if torch.is_tensor(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(t)


def to_jax_variables(state_dict, cfg: StepConfig | None = None) -> dict:
    """The port's detector or `I3DClassifier` state_dict → the JAX package's
    `{"params", "batch_stats"}` tree of numpy arrays (C-contiguous;
    bfloat16 tensors widened to float32), the inverse of
    `from_jax_variables` and `from_jax_classifier_variables`. The per-step
    heads are stacked on axis 0 in step order; `cfg`, when given, must
    agree on their number."""
    tree: dict = {"params": {}, "batch_stats": {}}
    stacks: dict = {}
    for name, value in state_dict.items():
        arr = _numpy(value)
        collection, path, step = jax_path(name, arr.shape)
        arr = np.ascontiguousarray(_to_jax_layout(arr))
        if step is None:
            _put(tree[collection], path, arr)
        else:
            stacks.setdefault((collection, path), {})[step] = arr
    for (collection, path), steps in stacks.items():
        n = len(steps) if cfg is None else cfg.num_steps
        if sorted(steps) != list(range(n)):
            raise KeyError(f"{collection}/{'/'.join(path)}: steps {sorted(steps)}, "
                           f"expected 0..{n - 1}")
        _put(tree[collection], path, np.stack([steps[s] for s in range(n)]))
    return {k: v for k, v in tree.items() if v}


def _put(tree: dict, path, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    if path[-1] in tree:
        raise KeyError(f"{'/'.join(path)} twice")
    tree[path[-1]] = value
