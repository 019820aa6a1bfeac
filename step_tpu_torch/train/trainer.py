"""Train state, optimizer, learning-rate schedule and the train step.

Port of `step_tpu/train/trainer.py`. The optimizer is the JAX package's
optax chain computed with the same operations in the same order, not
`torch.optim`:

    clip_by_global_norm(10)  (no epsilon: g * 1 or (g / norm) * 10)
    → AdamW (b1 0.9, b2 0.999, eps 1e-8; first moment stored in
      `cfg.adam_mu_dtype`, or with `cfg.adam_moments="int8"` both moments
      in 8-bit blocks, `train/optim_int8.py`) or SGD (decoupled weight
      decay added first, then momentum)
    → × -lr(step), the schedule's step counted from 0 (so warmup-cosine
      applies lr 0 at step 0, as optax does).

Subtrees named in `cfg.freeze_submodules` get no update, no weight decay
and no part in the clip's norm (optax `set_to_zero` under
`multi_transform`): their parameters stop requiring gradients, so the
backward stops at them, and they run in eval mode (`models/detector.py`).

`train_step` is one optimizer step over `cfg.grad_accum_steps`
micro-batches: the mean of their gradients and of their BatchNorm running
updates, the loss metrics averaged and `num_positive_per_step` summed, and
`grad_norm` the global norm of the trainable gradients before the clip.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from step_tpu_torch.config import StepConfig
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.models.i3d import BatchNorm, running_updates
from step_tpu_torch.parallel.mesh import mesh_group
from step_tpu_torch.train import optim_int8
from step_tpu_torch.train.losses import step_losses
from step_tpu_torch.utils.init import init_detector_train_
from step_tpu_torch.utils.spans import span

CLIP_NORM = 10.0
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
BATCH_KEYS = ("rgb", "proposals", "prop_mask", "gt_tubes", "gt_labels", "gt_mask")
# in a batch when the dataset reads optical flow (`step_tpu/train/fit.py:27`)
OPTIONAL_KEYS = ("flow",)


def make_schedule(cfg: StepConfig) -> Callable[[int], float]:
    """step → learning rate, in float32 as optax computes it:
    `cfg.lr_schedule` "warmup_cosine" (linear warmup from 0 over
    `warmup_steps`, then cosine decay to 0 at `total_steps`) or "step"
    (linear warmup into a constant rate, times `lr_decay_rate` at each of
    the absolute `lr_decay_milestones`)."""
    f32 = np.float32
    lr = f32(cfg.learning_rate)
    if cfg.lr_schedule == "step":
        milestones = tuple(int(m) for m in cfg.lr_decay_milestones)

        def step_schedule(step: int) -> float:
            warm = (min(f32(step) / f32(cfg.warmup_steps), f32(1.0))
                    if cfg.warmup_steps else f32(1.0))
            drops = f32(sum(step >= m for m in milestones))
            return float(lr * warm * f32(cfg.lr_decay_rate) ** drops)

        return step_schedule
    if cfg.lr_schedule != "warmup_cosine":
        raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")
    warmup = cfg.warmup_steps
    decay = max(cfg.total_steps, warmup + 1) - warmup

    def warmup_cosine(step: int) -> float:
        if warmup > 0 and step < warmup:
            frac = f32(1.0) - f32(min(max(step, 0), warmup)) / f32(warmup)
            return float((f32(0.0) - lr) * frac + lr)
        count = f32(min(step - warmup, decay))
        cosine = f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * count / f32(decay)))
        return float(lr * cosine)          # optax's alpha = 0: (1 - 0) * c + 0

    return warmup_cosine


class Optimizer:
    """The optax chain above, over a list of parameter tensors: `init`
    makes its state, `update` applies one step in place."""

    def __init__(self, cfg: StepConfig):
        if cfg.optimizer not in ("adamw", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        if cfg.adam_moments not in ("float32", "int8"):
            raise ValueError(f"unknown adam_moments {cfg.adam_moments!r}")
        self.cfg = cfg
        self.schedule = make_schedule(cfg)
        self.int8 = cfg.optimizer == "adamw" and cfg.adam_moments == "int8"

    def init(self, params, names) -> dict:
        """The state for `params`, whose names in the model are `names`;
        int8 moments block them by those names (`optim_int8.blocking`), as
        the JAX package blocks its leaves, and the optimizer keeps the
        blocking's gather index."""
        if self.cfg.optimizer == "sgd":
            return {"count": 0, "trace": [torch.zeros_like(p) for p in params]}
        if self.int8:
            self.index, leaves = optim_int8.blocking(params, names)
            return optim_int8.init_state(leaves, params[0].device)
        mu_dtype = getattr(torch, self.cfg.adam_mu_dtype)
        return {"count": 0,
                "mu": [torch.zeros_like(p, dtype=mu_dtype) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def update(self, params, grads, state: dict, norm: torch.Tensor | None = None) -> None:
        """One step on `params` (in place) from their `grads`, whose global
        norm `norm` is computed here unless the caller has it."""
        cfg = self.cfg
        norm = global_norm(grads) if norm is None else norm
        keep = (norm < CLIP_NORM).to(torch.float32)
        clipped = torch._foreach_mul(torch._foreach_div(grads, norm), CLIP_NORM)
        # select without a host sync: g * 1 + c * 0 = g, g * 0 + c * 1 = c
        g = torch._foreach_add(torch._foreach_mul(grads, keep),
                               torch._foreach_mul(clipped, 1.0 - keep))
        count = state["count"]
        if cfg.optimizer == "sgd":
            u = torch._foreach_add(g, torch._foreach_mul(params, cfg.weight_decay))
            trace = torch._foreach_add(u, torch._foreach_mul(state["trace"], cfg.momentum))
            state["trace"] = trace
            u = trace
        elif self.int8:
            u = optim_int8.adam_step(g, state, self.index, count + 1, ADAM_B1, ADAM_B2,
                                     ADAM_EPS)
            u = torch._foreach_add(u, torch._foreach_mul(params, cfg.weight_decay))
        else:
            # b1 in mu's dtype, as optax scales a bfloat16 first moment
            b1 = torch.tensor(ADAM_B1, dtype=state["mu"][0].dtype, device=g[0].device)
            mu = torch._foreach_add(torch._foreach_mul(g, 1 - ADAM_B1),
                                    torch._foreach_mul(state["mu"], b1))
            nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), 1 - ADAM_B2),
                                    torch._foreach_mul(state["nu"], ADAM_B2))
            t = count + 1
            bc1 = float(np.float32(1.0) - np.float32(ADAM_B1) ** np.float32(t))
            bc2 = float(np.float32(1.0) - np.float32(ADAM_B2) ** np.float32(t))
            denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)),
                                       ADAM_EPS)
            u = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            u = torch._foreach_add(u, torch._foreach_mul(params, cfg.weight_decay))
            state["mu"] = [m.to(s.dtype) for m, s in zip(mu, state["mu"])]
            state["nu"] = nu
        lr = float(np.float32(-self.schedule(count)))
        torch._foreach_add_(params, torch._foreach_mul(u, lr))
        state["count"] = count + 1


def make_optimizer(cfg: StepConfig) -> Optimizer:
    return Optimizer(cfg)


def global_norm(tensors) -> torch.Tensor:
    """The norm of all elements together (optax.global_norm), from the
    per-tensor norms of one multi-tensor operation."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@dataclasses.dataclass
class TrainState:
    """What a training run carries from step to step: the step count, the
    model (its parameters and BatchNorm statistics), the optimizer and its
    state over the trainable parameters, and the generator of the dropout
    masks."""

    step: int
    model: STEPDetector
    optimizer: Optimizer
    opt_state: dict
    generator: torch.Generator

    def trainable(self):
        return [p for p in self.model.parameters() if p.requires_grad]

    def trainable_names(self):
        return [n for n, p in self.model.named_parameters() if p.requires_grad]


def resolve_device(device) -> torch.device:
    """The training device: the card unless the caller asks for the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on a CUDA card and none is available; "
                           "pass device='cpu' to train on the CPU")
    return device


def create_train_state(cfg: StepConfig, seed: int = 0,
                       model: STEPDetector | None = None,
                       device="cuda") -> TrainState:
    """A fresh state on `device`: `model` as given, or a new detector with
    the training init from `seed`; frozen subtrees stop requiring
    gradients; the dropout generator is seeded with `seed + 1`."""
    if cfg.bn_folded:
        raise ValueError("a BN-folded configuration cannot train: "
                         "optimize_for_inference is for serving")
    device = resolve_device(device)
    if model is None:
        model = init_detector_train_(STEPDetector(cfg), cfg, seed)
    model = model.to(device)
    for name in cfg.freeze_submodules:
        getattr(model, name).requires_grad_(False)
    optimizer = make_optimizer(cfg)
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    generator = torch.Generator(device=device).manual_seed(seed + 1)
    return TrainState(0, model, optimizer,
                      optimizer.init([p for _, p in named], [n for n, _ in named]),
                      generator)


def batch_to_device(batch: dict, device, non_blocking: bool = False) -> dict:
    """The model's keys of a host batch (numpy or tensors), and its flow
    where it has one, as tensors on `device`; `non_blocking` pins host
    memory first, so the copy can run beside the card's work."""
    out = {}
    for k in BATCH_KEYS + tuple(k for k in OPTIONAL_KEYS if batch.get(k) is not None):
        v = batch[k]
        t = torch.as_tensor(v)
        if non_blocking and torch.device(device).type == "cuda":
            t = t.pin_memory()
        out[k] = t.to(device, non_blocking=non_blocking)
    return out


def _bn_updates(model: STEPDetector):
    """(modules, means, variances): flax's running update of every
    BatchNorm that ran in train mode since the last call, which clears
    their batch statistics."""
    bns = [m for m in model.modules()
           if isinstance(m, BatchNorm) and m.batch_stats is not None]
    means, variances = running_updates(bns) if bns else ([], [])
    for m in bns:
        m.batch_stats = None
    return bns, means, variances


def model_inputs(batch: dict, cfg: StepConfig):
    """(primary input, second stream) of a batch, as the JAX package feeds
    them (`step_tpu/train/trainer.py:146-155, :266-271`): the flow is the
    primary input of a flow-stream detector and the second stream of a
    two-stream one; otherwise the RGB goes alone."""
    if cfg.input_stream != "rgb" and "flow" not in batch:
        raise ValueError(
            f"input_stream={cfg.input_stream!r} training needs a "
            "flow-enabled dataset (batch has no 'flow'; use "
            "UCFDataset(with_flow=True) — synthetic/AVA carry no flow)")
    primary = batch["rgb"] if cfg.input_stream == "rgb" else batch["flow"]
    return primary, batch.get("flow") if cfg.two_stream else None


def train_step(state: TrainState, batch: dict, cfg: StepConfig, _reduce=None):
    """One optimizer step on `batch` (tensors on the model's device: rgb,
    proposals, prop_mask, gt_tubes, gt_labels, gt_mask, and flow for a
    flow or two-stream detector) → (state, metrics). The state is
    updated in place; the metrics are tensors on the device (`loss`, the
    per-step losses and positives, `grad_norm`), read without a host
    sync. `_reduce(grads, metrics)`, where given, turns the rank's
    gradients and metrics into the global batch's before the norm
    (`make_parallel_train_step`)."""
    model = state.model
    params = state.trainable()
    for p in params:
        p.grad = None
    accum = cfg.grad_accum_steps
    B = batch["rgb"].shape[0]
    if B % accum:
        raise ValueError(f"batch dim {B} not divisible by grad_accum_steps={accum}")
    mb = B // accum
    bn_sum, m_sum = None, None
    for i in range(accum):
        part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        primary, flow = model_inputs(part, cfg)
        with span("train.forward"):
            outputs = model(primary, part["proposals"], flow, train=True,
                            generator=state.generator)
        with span("train.loss"):
            loss, metrics = step_losses(outputs, part["gt_tubes"], part["gt_labels"],
                                        part["gt_mask"], part["prop_mask"], cfg)
        with span("train.backward"):
            loss.backward()
        bns, means, variances = _bn_updates(model)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if m_sum is None:
            m_sum, bn_sum = metrics, (means, variances)
        else:
            m_sum = {k: m_sum[k] + v for k, v in metrics.items()}
            bn_sum = (torch._foreach_add(bn_sum[0], means),
                      torch._foreach_add(bn_sum[1], variances))
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    if accum > 1:
        inv = 1.0 / accum
        grads = torch._foreach_mul(grads, inv)
        m_sum = {k: (v if k == "num_positive_per_step" else v * inv)
                 for k, v in m_sum.items()}
        bn_sum = tuple(torch._foreach_mul(stats, inv) if stats else stats
                       for stats in bn_sum)
    if _reduce is not None:
        with span("train.reduce"):
            grads, m_sum = _reduce(grads, m_sum)
    with span("train.optimizer"):
        metrics = dict(m_sum, grad_norm=global_norm(grads))
        state.optimizer.update(params, grads, state.opt_state, metrics["grad_norm"])
    with span("train.bn_commit"), torch.no_grad():
        if bns:
            torch._foreach_copy_([m.running_mean for m in bns], bn_sum[0])
            torch._foreach_copy_([m.running_var for m in bns], bn_sum[1])
    for p in params:
        p.grad = None
    state.step += 1
    return state, metrics


def make_parallel_train_step(cfg: StepConfig, model: STEPDetector, mesh):
    """`train_step` over the "data" axis of `mesh`: each rank passes its
    rows of the global batch (its loader's batch, the same size on every
    rank) and `model` (its state's) gets the step the global batch would
    give one process → `step(state, batch) -> (state, metrics)`.

    What GSPMD does for the JAX package (`step_tpu/train/trainer.py:239-262`)
    is written out: BatchNorm's batch statistics are the global batch's
    (`BatchNorm.batch_group`); the dropout masks are the global batch's,
    of which the rank keeps rows `rank::world` (`STEPDetector.data_shard`);
    after the backward one all-reduce of the flat gradients and metrics
    (no `DistributedDataParallel`), the gradients and losses divided by the
    world size, `num_positive_per_step` a sum. Every rank then takes the
    same optimizer step and commits the same BatchNorm update.

    With `grad_accum_steps` = k each rank splits its rows into k slices and
    micro-batch i is every rank's i-th slice: rows [i·mb, (i+1)·mb) of the
    global batch in `process_shard`'s order (ROADMAP §3)."""
    group, rank, world = mesh_group(mesh)
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]

    def reduce(grads, metrics):
        keys = list(metrics)
        parts = list(grads) + [metrics[k].reshape(-1).to(torch.float32) for k in keys]
        flat = torch.cat([t.reshape(-1) for t in parts])
        torch.distributed.all_reduce(flat, group=group)
        out = list(torch.split(flat, [t.numel() for t in parts]))
        grads = [o.view_as(g) for o, g in zip(out, grads)]
        if world > 1:
            grads = torch._foreach_div(grads, float(world))
        reduced = {}
        for k, o in zip(keys, out[len(grads):]):
            o = o.view_as(metrics[k])
            reduced[k] = o if k == "num_positive_per_step" else o / world
        return grads, reduced

    def step(state: TrainState, batch: dict):
        if state.model is not model:
            raise ValueError("the state's model is not the model this step was made for")
        for m in bns:
            m.batch_group = group
        model.data_shard = (rank, world)
        try:
            return train_step(state, batch, cfg, _reduce=reduce)
        finally:
            for m in bns:
                m.batch_group = None
            model.data_shard = None

    return step


@torch.no_grad()
def eval_forward(state: TrainState, batch: dict, cfg: StepConfig):
    """The inference forward: no dropout, running BatchNorm statistics."""
    primary, flow = model_inputs(batch, cfg)
    return state.model(primary, batch["proposals"], flow)
