"""Inference-time BN folding.

Port of `step_tpu/models/optimize.py:51-85` (`fold_bn_variables`) and of
the bn_folded part of `optimize_for_inference` (:177-179). In eval mode a
BatchNorm is a per-channel affine, so it folds into the preceding conv:

    k' = k * g / sqrt(v + eps)        b' = beta - mean * g / sqrt(v + eps)

Exact up to float reassociation. The folded model has no BatchNorm and
cannot train.
"""

from __future__ import annotations

from typing import Dict

import torch

from step_tpu.config import StepConfig
from step_tpu_torch.models.i3d import BN_EPS


def fold_bn(state_dict: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Fold every `<unit>.bn.*` into `<unit>.conv.{weight,bias}`.

    Takes the state_dict of a model built with `bn_folded=False` and
    returns one for the same model built with `bn_folded=True`.
    """
    out = {k: v for k, v in state_dict.items() if ".bn." not in k}
    for key in state_dict:
        if not key.endswith(".bn.weight"):
            continue
        unit = key[: -len("bn.weight")]
        gamma = state_dict[unit + "bn.weight"].to(torch.float32)
        beta = state_dict[unit + "bn.bias"].to(torch.float32)
        mean = state_dict[unit + "bn.running_mean"].to(torch.float32)
        var = state_dict[unit + "bn.running_var"].to(torch.float32)
        scale = gamma / torch.sqrt(var + BN_EPS)
        bias = beta - mean * scale
        if unit + "conv.bias" in state_dict:
            bias = bias + state_dict[unit + "conv.bias"].to(torch.float32) * scale
        kernel = state_dict[unit + "conv.weight"].to(torch.float32)
        out[unit + "conv.weight"] = kernel * scale.reshape(-1, 1, 1, 1, 1)
        out[unit + "conv.bias"] = bias
    return out


def optimize_for_inference(cfg: StepConfig, state_dict):
    """(cfg, state_dict) → (cfg with `bn_folded=True`, folded state_dict)."""
    if cfg.bn_folded:
        raise ValueError("a bn_folded config's weights are already folded")
    return cfg.replace(bn_folded=True), fold_bn(state_dict)
