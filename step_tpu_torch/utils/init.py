"""Seeded parameter initialization.

The JAX package initializes through `flax` (`step_tpu/utils/init.py`); the
GPU machine has no JAX, so the port draws its own weights from a
`torch.Generator`. Not the same numbers as the JAX initializer — a test
that needs both frameworks on one set of weights converts JAX's with
`step_tpu_torch.convert.from_jax_variables`.

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
