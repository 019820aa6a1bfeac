"""Seeded parameter initialization: a serving init and a training init.

The JAX package initializes through `flax` (`step_tpu/utils/init.py`); the
GPU machine has no JAX, so the port draws its own weights from a
`torch.Generator`. Not the same numbers as the JAX initializer — a test
that needs both frameworks on one set of weights converts JAX's with
`step_tpu_torch.convert.from_jax_variables`.

`init_detector_train_` draws flax's distributions, what training from
scratch starts from (`step_tpu/models/nets.py`, `detector.py:121-124`):

  * conv and dense kernels lecun-normal (a normal truncated at two
    standard deviations, scaled to variance 1 / fan_in), biases 0;
  * the box-regression Dense normal with std 1e-3 (`nets.py:202`);
  * the class bias logit(cls_prior) for a multilabel head, else 0
    (`nets.py:157`);
  * BatchNorm weight 1, bias 0, running mean 0, running variance 1.

`init_detector_` is the serving init:

  * conv weights: normal with std sqrt(2 / fan_in) (every I3D conv feeds a
    ReLU, so activations keep their scale through the ~25 layers);
  * dense weights: normal with std sqrt(1 / fan_in); the box-regression
    Dense normal with std 1e-3, as in the JAX head (`nets.py:202`);
  * biases 0;
  * BatchNorm near the identity: weight 1 ± 0.1, bias ± 0.1, running mean
    ± 0.1, running variance in [0.8, 1.2] — non-trivial to fold, and the
    activations stay finite in bfloat16 through the whole network.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from step_tpu_torch.models.i3d import BatchNorm
from step_tpu_torch.models.nets import TwoBranchHead


# flax's lecun_normal: variance_scaling(1, "fan_in", "truncated_normal"),
# whose truncated normal on [-2, 2] is rescaled by this to unit variance.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_detector_train_(model: nn.Module, cfg, seed: int = 0) -> nn.Module:
    """Initialize `model` in place with flax's training distributions
    (above) from `seed`; `cfg` gives the class-bias prior."""
    g = torch.Generator().manual_seed(seed)

    # the standard normal truncated to [-2, 2] by its inverse CDF
    lo, hi = (0.5 * (1.0 + math.erf(z / math.sqrt(2.0))) for z in (-2.0, 2.0))

    def lecun(t: torch.Tensor, fan_in: int) -> None:
        u = lo + (hi - lo) * torch.rand(t.shape, generator=g, dtype=torch.float64)
        z = torch.clamp(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0), -2.0, 2.0)
        t.copy_((z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)).to(t.dtype))

    cls_bias = (math.log(cfg.cls_prior / (1.0 - cfg.cls_prior))
                if cfg.multilabel else 0.0)
    heads = [m for m in model.modules() if isinstance(m, TwoBranchHead)]
    regression = {id(h.reg) for h in heads}
    classifier = {id(h.cls) for h in heads}
    for module in model.modules():
        if isinstance(module, nn.Conv3d):
            lecun(module.weight, module.weight[0].numel())
        elif isinstance(module, nn.Linear):
            if id(module) in regression:
                module.weight.copy_(torch.randn(module.weight.shape, generator=g) * 1e-3)
            else:
                lecun(module.weight, module.in_features)
        elif isinstance(module, BatchNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
            module.running_mean.zero_()
            module.running_var.fill_(1.0)
            continue
        else:
            continue
        if module.bias is not None:
            module.bias.fill_(cls_bias if id(module) in classifier else 0.0)
    return model


@torch.no_grad()
def init_detector_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Initialize `model`'s parameters and BN statistics in place from
    `seed`; the values do not depend on the model's device or dtype."""
    g = torch.Generator().manual_seed(seed)

    def fill(t: torch.Tensor, values: torch.Tensor) -> None:
        t.copy_(values.to(t.dtype))

    def normal(shape, std):
        return torch.randn(shape, generator=g) * std

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g)

    regression = {id(m.reg) for m in model.modules() if isinstance(m, TwoBranchHead)}
    for module in model.modules():
        if isinstance(module, nn.Conv3d):
            fan_in = module.weight[0].numel()
            fill(module.weight, normal(module.weight.shape, math.sqrt(2.0 / fan_in)))
        elif isinstance(module, nn.Linear):
            std = (1e-3 if id(module) in regression
                   else math.sqrt(1.0 / module.in_features))
            fill(module.weight, normal(module.weight.shape, std))
        elif isinstance(module, BatchNorm):
            c = module.weight.shape
            fill(module.weight, uniform(c, 0.9, 1.1))
            fill(module.bias, uniform(c, -0.1, 0.1))
            fill(module.running_mean, uniform(c, -0.1, 0.1))
            fill(module.running_var, uniform(c, 0.8, 1.2))
            continue
        else:
            continue
        if module.bias is not None:
            module.bias.zero_()
    return model
