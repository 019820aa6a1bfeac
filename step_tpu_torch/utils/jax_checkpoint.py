"""The JAX package's orbax checkpoints, read into the port.

`step_tpu/utils/checkpoint.py::save_checkpoint` writes a CheckpointManager
step `<ckpt_dir>/<step>/default/`: an OCDBT database (`manifest.ocdbt`,
`ocdbt.process_0/`) holding one zarr v2 array per leaf of
`{params, batch_stats, opt_state, step, data_iter}`, stored under its tree
path joined by "." (`params.context.proj.kernel`, `step`,
`data_iter.epoch`), and `_METADATA`, whose `tree_metadata` lists those
paths with their key types. `read_orbax_checkpoint` reads them through
`tensorstore`, which is imported only there: where it is missing (the
card's machine) it raises an ImportError that says so; convert the run
with `convert_jax_checkpoint` where `tensorstore` is installed and copy
the port's `<step>.pt` instead.

What was read maps onto the port (`restore_orbax_checkpoint`):

  * `params` and `batch_stats` through `convert.from_jax_variables` (or
    `from_jax_classifier_variables` for an `I3DClassifier` tree), the
    number of refinement steps read from the stacked heads;
  * `opt_state`, the optax chain of `step_tpu/train/trainer.py::
    make_optimizer` (clip, then AdamW, int8 AdamW or decayed SGD), onto
    `trainer.Optimizer`'s state in `TrainState.trainable_names()` order:
    each AdamW moment and SGD trace through its parameter's transform,
    in its stored dtype; int8 codes and scales copied one to one, each
    JAX leaf a row range of the port's blocks (`train/optim_int8.py::
    blocking`); the step count;
  * `step` and `data_iter` as they are.

The dropout generator has no JAX counterpart: it keeps the state the port
seeded from the run's seed. A run with `freeze_submodules` (optax
`multi_transform`) restores its weights only (`load_model_state`).
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from step_tpu_torch.convert import convert_tree, from_jax_classifier_variables, jax_path


def _tensorstore():
    try:
        import tensorstore
    except ImportError as e:
        raise ImportError(
            "reading the JAX package's orbax checkpoints needs the `tensorstore` "
            "package, which is not installed here; convert the run where it is "
            "(step_tpu_torch.utils.jax_checkpoint.convert_jax_checkpoint) and use "
            "the port's <step>.pt checkpoint") from e
    return tensorstore


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, str(step), "default")


def orbax_steps(ckpt_dir: str) -> list[int]:
    """The steps of the finished orbax checkpoints in `ckpt_dir`, oldest
    first (a step whose `_METADATA` is not written yet is left out)."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit()
                  and os.path.isfile(os.path.join(_step_dir(ckpt_dir, int(d)), "_METADATA")))


def read_orbax_checkpoint(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The tree of the orbax checkpoint at `step` (the newest by default)
    as nested dicts of numpy arrays: dict keys as they are, sequence
    indices as str ("0", "1", ...), each 0-d leaf a numpy scalar. Raises
    FileNotFoundError if there is none, ImportError without `tensorstore`."""
    steps = orbax_steps(ckpt_dir)
    if step is None and steps:
        step = steps[-1]
    if step is None or step not in steps:
        raise FileNotFoundError(f"no orbax checkpoint in {ckpt_dir}"
                                + ("" if step is None else f" at step {step}"))
    ts = _tensorstore()
    root = os.path.abspath(_step_dir(ckpt_dir, step))
    with open(os.path.join(root, "_METADATA")) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt") or meta.get("use_zarr3"):
        raise ValueError(f"{root}: not the OCDBT database of zarr v2 arrays that "
                         "the JAX package's save_checkpoint writes")
    context = ts.Context()
    opened = []
    for entry in meta["tree_metadata"].values():
        if entry["value_metadata"].get("skip_deserialize"):
            continue                        # an empty node (optax's EmptyState)
        keys = [str(k["key"]) for k in entry["key_metadata"]]
        kvstore = {"driver": "ocdbt", "base": f"file://{root}", "path": ".".join(keys)}
        opened.append((keys, ts.open({"driver": "zarr", "kvstore": kvstore},
                                     context=context, open=True, read=True)))
    reads = [(keys, fut.result().read()) for keys, fut in opened]
    tree: dict = {}
    for keys, fut in reads:
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        arr = np.asarray(fut.result())
        node[keys[-1]] = arr[()] if arr.ndim == 0 else arr
    return tree


def _num_steps(params) -> Optional[int]:
    """The refinement steps stacked under `steps/head/`, or None."""
    head = params.get("steps", {}).get("head")
    while isinstance(head, dict):
        head = next(iter(head.values()))
    return None if head is None else int(np.shape(head)[0])


def variables_state_dict(variables) -> dict:
    """JAX `{params, batch_stats}` of a detector or an `I3DClassifier` →
    the port's state_dict (float32)."""
    params = variables.get("params", {})
    if set(params) <= {"stem", "tail", "logits"}:
        return from_jax_classifier_variables(variables)
    n = _num_steps(params)
    if n is None:
        raise KeyError("not a detector tree: no steps/head/ parameters")
    return convert_tree(variables, n)


def _get(tree, path, what: str):
    for k in path:
        if not isinstance(tree, dict) or k not in tree:
            raise KeyError(f"{what}: no {'/'.join(path)} in the checkpoint's opt_state")
        tree = tree[k]
    return tree


def _moments(tree, names, params, num_steps, like) -> list:
    """A tree of per-parameter moments (the params' structure) → one
    tensor a trainable tensor, in the port's layout, each in the dtype and
    on the device of `like`'s."""
    sd = convert_tree({"params": tree}, num_steps)
    out = []
    for name, p, ref in zip(names, params, like):
        if name not in sd or tuple(sd[name].shape) != tuple(p.shape):
            raise KeyError(f"the checkpoint's moments hold no {name} {tuple(p.shape)}")
        out.append(sd[name].to(device=ref.device, dtype=ref.dtype))
    return out


def _int8_blocks(tree, state: dict, named: dict) -> dict:
    """The JAX package's int8 moments (per leaf `{q, scale}`) copied into
    the port's flat blocks, leaf by leaf, each leaf the row range that
    `optim_int8.blocking` gave it."""
    out = dict(state)
    for key in ("mu", "mu_scale", "nu", "nu_scale"):
        out[key] = state[key].clone()
    for leaf, first, n in state["leaves"]:
        name = leaf.replace("steps.*.", "steps.0.")
        _, path, _ = jax_path(name, named[name].shape)
        for moment in ("mu", "nu"):
            q = _get(tree[moment], (*path, "q"), moment)
            scale = _get(tree[moment], (*path, "scale"), moment)
            if q.shape != (n, out[moment].shape[1]) or scale.shape != (n,):
                raise ValueError(f"int8 {moment} of {leaf}: {q.shape} blocks in the "
                                 f"checkpoint, the port blocks it in {n}")
            dev = out[moment].device
            out[moment][first:first + n] = torch.from_numpy(np.ascontiguousarray(q)).to(dev)
            out[f"{moment}_scale"][first:first + n] = torch.from_numpy(
                np.ascontiguousarray(scale, np.float32)).to(dev)
    return out


def optimizer_state(opt_tree, state) -> dict:
    """The JAX package's `opt_state` tree → the port's optimizer state for
    `state` (a `trainer.TrainState` whose optimizer has the run's config),
    built on the fresh state's own (its int8 blocking, devices and
    dtypes)."""
    cfg = state.optimizer.cfg
    if cfg.freeze_submodules:
        raise ValueError("the optimizer state of a run with freeze_submodules (optax "
                         "multi_transform) is not read; restore its weights with "
                         "load_model_state and start the moments anew")
    names = state.trainable_names()
    params = state.trainable()
    named = dict(state.model.named_parameters())
    num_steps = state.model.cfg.num_steps
    current = state.opt_state
    chain = _get(opt_tree, ("1",), "the clip's chain")
    if cfg.optimizer == "sgd":
        trace = _get(chain, ("1", "0", "trace"), "SGD trace")
        count = _get(chain, ("1", "1", "count"), "SGD count")
        return {"count": int(count),
                "trace": _moments(trace, names, params, num_steps, current["trace"])}
    adam = _get(chain, ("0",), "AdamW")
    count = int(_get(adam, ("count",), "AdamW count"))
    if state.optimizer.int8:
        return dict(_int8_blocks(adam, current, named), count=count)
    return {"count": count,
            "mu": _moments(adam["mu"], names, params, num_steps, current["mu"]),
            "nu": _moments(adam["nu"], names, params, num_steps, current["nu"])}


def restore_orbax_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Load the JAX package's orbax checkpoint at `step` (the newest by
    default) into the port's `state`, on its model's device → (state,
    data_iter_state), as `utils/checkpoint.py::restore_checkpoint` does
    for the port's own."""
    tree = read_orbax_checkpoint(ckpt_dir, step)
    state.model.load_state_dict(variables_state_dict(tree))
    state.opt_state = optimizer_state(tree["opt_state"], state)
    state.step = int(tree["step"])
    data_iter = {k: int(tree.get("data_iter", {}).get(k, 0))
                 for k in ("epoch", "batch_index")}
    return state, data_iter


def convert_jax_checkpoint(src: str, dst: str, cfg, step: Optional[int] = None) -> int:
    """The JAX package's orbax checkpoint at `step` (the newest by
    default) in `src`, for a run of `cfg`, written as the port's
    `<step>.pt` in `dst` (`utils/checkpoint.py`), on the CPU → the step.
    This is how a run trained on a TPU reaches the card: convert where
    `tensorstore` is installed, copy the file."""
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.train.trainer import create_train_state
    from step_tpu_torch.utils.checkpoint import save_checkpoint

    state = create_train_state(cfg, 0, model=STEPDetector(cfg), device="cpu")
    state, data_iter = restore_orbax_checkpoint(src, state, step)
    return save_checkpoint(dst, state, data_iter)
