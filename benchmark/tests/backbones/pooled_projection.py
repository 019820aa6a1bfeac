"""A stand-in backbone for the tests of the detector's seam: an average
pool of 2 frames by `feature_stride`², a LayerNorm over the three colours,
and a 1x1x1 projection to Mixed_4f's 832 channels with a ReLU. It records
its pool as a kernel of a kind no other backbone records."""

from __future__ import annotations

import torch.nn.functional as F

CHANNELS = 832
KIND = "avg_pool3d"


def parameter_shapes(cfg) -> dict:
    return {"features.norm.weight": ((3,), "ln_weight"), "features.norm.bias": ((3,), "ln_bias"),
            "features.proj.weight": ((CHANNELS, 3), "linear"),
            "features.proj.bias": ((CHANNELS,), "bias")}


def out_channels(cfg) -> int:
    return CHANNELS


def forward(P, cfg, x, run):
    s = cfg.feature_stride
    y = F.avg_pool3d(x.permute(0, 4, 1, 2, 3), (2, s, s)).permute(0, 2, 3, 4, 1)
    run.record(KIND, (x.numel() + y.numel()) * run.width)
    y = F.layer_norm(y, (3,), P["features.norm.weight"], P["features.norm.bias"])
    y = F.linear(run.prec(y), run.prec(P["features.proj.weight"]),
                 run.prec(P["features.proj.bias"]))
    return run.prec(F.relu(y))
