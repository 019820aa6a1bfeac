"""Inference-time variable optimization: BN folding and Inception fusion.

Port of `step_tpu/models/optimize.py`: `fold_bn_variables` (:51-85),
`fuse_inception_variables` (:88-114), `fuse_inception3_variables`
(:117-161) and `optimize_for_inference` (:164-209), on state_dicts. In eval
mode a BatchNorm is a per-channel affine, so it folds into the preceding
conv:

    k' = k * g / sqrt(v + eps)        b' = beta - mean * g / sqrt(v + eps)

Then the three folded 1x1x1 branch convs of each Inception block, which
all read the block input, concatenate on output channels into one "b012"
conv; optionally the two 3x3x3 branch convs merge into one block-diagonal
"b12" conv (zeros off the diagonal, so exact). All of it is exact up to
float reassociation. The optimized model has no BatchNorm and cannot
train.
"""

from __future__ import annotations

from typing import Dict

import torch

from step_tpu_torch.config import StepConfig
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


def _blocks(state_dict, branch: str):
    """The prefixes `<...>.<block>.` of every Inception block that holds
    `<prefix><branch>.conv.weight`."""
    suffix = f"{branch}.conv.weight"
    return [k[: -len(suffix)] for k in state_dict if k.endswith("." + suffix)]


def fuse_inception(folded: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Merge each Inception block's folded b0/b1a/b2a convs into one "b012"
    conv, concatenated on output channels. Takes a folded state_dict
    (`fold_bn`)."""
    out = dict(folded)
    for block in _blocks(folded, "b1a"):
        parts = [f"{block}{b}.conv." for b in ("b0", "b1a", "b2a")]
        if any(p + "bias" not in folded for p in parts):
            raise ValueError("fuse_inception needs BN-folded convs (run fold_bn first)")
        for name in ("weight", "bias"):
            out[f"{block}b012.conv.{name}"] = torch.cat(
                [out.pop(p + name) for p in parts], dim=0)
    return out


def fuse_inception3(fused: Dict[str, torch.Tensor],
                    scope: str = "tail") -> Dict[str, torch.Tensor]:
    """Merge each Inception block's b1b/b2b 3x3x3 convs into one
    block-diagonal "b12" conv. Takes a `fuse_inception` state_dict. Scope
    "tail" rewrites the Mixed_5* blocks only, "all" every block."""
    if scope not in ("tail", "all"):
        raise ValueError(f"scope must be 'tail' or 'all', got {scope!r}")
    out = dict(fused)
    for block in _blocks(fused, "b1b"):
        name = block[:-1].rsplit(".", 1)[-1]
        if scope == "tail" and not name.startswith("Mixed_5"):
            continue
        if block + "b012.conv.weight" not in fused:
            raise ValueError("fuse_inception3 needs fused b012 convs "
                             "(run fuse_inception first)")
        k1 = out.pop(block + "b1b.conv.weight")
        k2 = out.pop(block + "b2b.conv.weight")
        (co1, ci1), (co2, ci2) = k1.shape[:2], k2.shape[:2]
        kernel = k1.new_zeros((co1 + co2, ci1 + ci2) + tuple(k1.shape[2:]))
        kernel[:co1, :ci1] = k1
        kernel[co1:, ci1:] = k2
        out[block + "b12.conv.weight"] = kernel
        out[block + "b12.conv.bias"] = torch.cat(
            [out.pop(block + "b1b.conv.bias"), out.pop(block + "b2b.conv.bias")])
    return out


# optimize_for_inference's keyword arguments shadow these two names.
_fuse_1x1, _fuse_3x3 = fuse_inception, fuse_inception3


def optimize_for_inference(cfg: StepConfig, state_dict,
                           fuse_inception: bool = True,
                           fuse_inception3: str = "none"):
    """(cfg, state_dict) → the serving (cfg, state_dict): BN folded, and by
    default the Inception 1x1x1 convs fused, as in the JAX package. The
    config is the JAX package's `inference_optimized_config`."""
    if cfg.bn_folded:
        raise ValueError("a bn_folded config's weights are already folded")
    if fuse_inception3 != "none" and not fuse_inception:
        raise ValueError("fuse_inception3 requires fuse_inception")
    sd = fold_bn(state_dict)
    if fuse_inception:
        sd = _fuse_1x1(sd)
    if fuse_inception3 != "none":
        sd = _fuse_3x3(sd, fuse_inception3)
    cfg_opt = cfg.replace(bn_folded=True, fused_inception=fuse_inception,
                          fused_inception3=fuse_inception3,
                          fused_bn_relu=False, scan_unroll=True)
    return cfg_opt, sd
