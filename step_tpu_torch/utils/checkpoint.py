"""Checkpoint save and restore of a training run.

Port of `step_tpu/utils/checkpoint.py`, in torch's own format in place of
orbax: one file `<step>.pt` a checkpoint in `ckpt_dir`, holding the
model's parameters and BatchNorm statistics (under "model"), the
optimizer state (int8 moments as their int8, uint8 and float32 tensors,
so they restore bit for bit, with the name of their blocking; moments
saved in another blocking are refused, `train/optim_int8.py`), the step,
the dropout generator's state and the data iterator's position
`{epoch, batch_index}` (the loader's per-epoch order is seeded, so `fit`
resumes mid-epoch without replaying a batch). The newest `max_to_keep` are
kept.

`load_model_state` and `restore_checkpoint` also read the JAX package's
orbax checkpoints (`<step>/default/` directories, `utils/jax_checkpoint.py`)
where `tensorstore` is installed: the newest step of either format is
read, the port's file where both hold it. So `cli.test`, `cli.serve`,
`cli.demo`, `cli.classify --ckpt-dir` and `fit(resume=True)` take a run
trained by the JAX package; `jax_checkpoint.convert_jax_checkpoint` writes
it as the port's `<step>.pt` for a machine without `tensorstore`.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from step_tpu_torch.train import optim_int8
from step_tpu_torch.train.trainer import TrainState


def _normalize_iter_state(data_iter_state: Optional[dict]) -> dict:
    out = {"epoch": 0, "batch_index": 0}
    for k in out:
        if data_iter_state and k in data_iter_state:
            out[k] = int(data_iter_state[k])
    return out


def checkpoint_steps(ckpt_dir: str) -> list[int]:
    """The steps of the checkpoints in `ckpt_dir`, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(f[:-3]) for f in os.listdir(ckpt_dir)
                  if f.endswith(".pt") and f[:-3].isdigit())


def save_checkpoint(ckpt_dir: str, state: TrainState,
                    data_iter_state: Optional[dict] = None,
                    max_to_keep: int = 3) -> int:
    """Write the state at its step (atomically: a temporary file renamed
    into place), then delete all but the newest `max_to_keep`. Returns the
    step saved."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "step": state.step,
        "model": state.model.state_dict(),
        "opt_state": state.opt_state,
        "generator": state.generator.get_state(),
        "data_iter": _normalize_iter_state(data_iter_state),
    }
    path = os.path.join(ckpt_dir, f"{state.step}.pt")
    torch.save(payload, path + ".tmp")
    os.replace(path + ".tmp", path)
    for step in checkpoint_steps(ckpt_dir)[:-max_to_keep]:
        os.remove(os.path.join(ckpt_dir, f"{step}.pt"))
    return state.step


def _checkpoint(ckpt_dir: str, step: Optional[int]) -> tuple[str, int]:
    """("pt", step) or ("orbax", step) of the checkpoint at `step` (the
    newest of either format by default; the port's where both hold a
    step); raises FileNotFoundError if there is none."""
    from step_tpu_torch.utils.jax_checkpoint import orbax_steps

    pt, orbax = checkpoint_steps(ckpt_dir), orbax_steps(ckpt_dir)
    if step is None and (pt or orbax):
        step = max(pt + orbax)
    if step is not None and step in pt:
        return "pt", step
    if step is not None and step in orbax:
        return "orbax", step
    raise FileNotFoundError(f"no checkpoint found in {ckpt_dir}"
                            + ("" if step is None else f" at step {step}"))


def load_model_state(ckpt_dir: str, step: Optional[int] = None) -> dict:
    """The model state_dict of the checkpoint at `step` (the newest by
    default), on the CPU: what the CLIs' `--ckpt-dir` reads. A JAX orbax
    checkpoint gives its detector or `I3DClassifier` variables, converted."""
    kind, step = _checkpoint(ckpt_dir, step)
    if kind == "orbax":
        from step_tpu_torch.utils import jax_checkpoint

        return jax_checkpoint.variables_state_dict(
            jax_checkpoint.read_orbax_checkpoint(ckpt_dir, step))
    return torch.load(os.path.join(ckpt_dir, f"{step}.pt"), map_location="cpu")["model"]


def restore_checkpoint(ckpt_dir: str, state: TrainState,
                       step: Optional[int] = None):
    """Load the checkpoint at `step` (the newest by default) into `state`,
    on the model's device → (state, data_iter_state). Raises
    FileNotFoundError if there is none, and ValueError for int8 moments
    blocked otherwise than `state`'s optimizer blocks them. A JAX orbax
    checkpoint goes through `jax_checkpoint.restore_orbax_checkpoint`; the
    dropout generator then keeps its seeded state."""
    kind, step = _checkpoint(ckpt_dir, step)
    if kind == "orbax":
        from step_tpu_torch.utils.jax_checkpoint import restore_orbax_checkpoint

        return restore_orbax_checkpoint(ckpt_dir, state, step)
    device = next(state.model.parameters()).device
    path = os.path.join(ckpt_dir, f"{step}.pt")
    payload = torch.load(path, map_location=device)
    optim_int8.check_restorable(payload["opt_state"], state.opt_state, path)
    state.model.load_state_dict(payload["model"])
    state.opt_state = payload["opt_state"]
    state.generator.set_state(payload["generator"].cpu())
    state.step = int(payload["step"])
    return state, payload["data_iter"]
