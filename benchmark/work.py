"""The yardstick's arithmetic: the H100's published peaks, the seeded
weights, and the work of a clip worked out from the configuration's shapes.

FLOPs are those `torch.utils.flop_counter` counts over the plain reference
(`reference/detector.py`, `reference/training.py`) on meta tensors, at one
clip with every proposal slot: the convolutions, linear layers and the
head's masked temporal mean. ROI-align, pools, NMS and elementwise work
count none. Bytes of a kernel are its inputs read once and its outputs
written once at the compute dtype's width.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference import detector as ref
from benchmark.reference import training as ref_train

# NVIDIA H100 SXM, the data sheet's dense rates at 700 W.
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12
# std * sqrt(fan_in) of the weights drawn from a normal, by kind
GAIN = {"conv": math.sqrt(2.0), "linear": 1.0, "reg": 0.25}
# the range of the weights drawn uniformly, by kind (BatchNorm's and
# LayerNorm's affine and BatchNorm's statistics); kind "bias" is 0
UNIFORM = {"bn_weight": (0.9, 1.1), "bn_bias": (-0.1, 0.1), "bn_mean": (-0.1, 0.1),
           "bn_var": (0.8, 1.2), "ln_weight": (0.9, 1.1), "ln_bias": (-0.1, 0.1)}


def sub_seeds(seed: int) -> dict:
    """Independent seeds for each input of a run, all drawn from `seed`
    (any whole number): weights, data, request order, loader order,
    dropout masks and the sample of answers checked."""
    state = np.random.SeedSequence(abs(int(seed))).generate_state(6, dtype=np.uint32)
    names = ("weights", "data", "order", "loader", "masks", "sample")
    return {n: int(s) for n, s in zip(names, state)}


def make_weights(cfg, seed: int, device) -> dict:
    """The detector's raw, unfolded float32 weights drawn on `device` from
    `seed` in two calls, each kind as `GAIN` and `UNIFORM` say: one normal
    draw for every kind of `GAIN`, at std gain * sqrt(1 / fan_in) (the box
    regression's gain is a quarter of a linear layer's, so its deltas come
    out near unit scale, as the encoding's variances make a trained
    regressor's; at the full std they saturate the decoder's clamp), one
    uniform draw for every kind of `UNIFORM`, biases 0. A kind in neither
    is refused."""
    shapes = ref.parameter_shapes(cfg)
    g = torch.Generator(device=device).manual_seed(seed)
    sizes = {n: math.prod(s) for n, (s, _) in shapes.items()}
    normal = torch.randn(sum(sizes[n] for n, (_, k) in shapes.items() if k in GAIN),
                         generator=g, device=device)
    uniform = torch.rand(sum(sizes[n] for n, (_, k) in shapes.items() if k in UNIFORM),
                         generator=g, device=device)
    out, i, j = {}, 0, 0
    for name, (shape, kind) in shapes.items():
        n = sizes[name]
        if kind in GAIN:
            std = GAIN[kind] * math.sqrt(shape[0] / n)
            out[name] = (normal[i:i + n] * std).reshape(shape)
            i += n
        elif kind in UNIFORM:
            lo, hi = UNIFORM[kind]
            out[name] = (lo + (hi - lo) * uniform[j:j + n]).reshape(shape)
            j += n
        elif kind == "bias":
            out[name] = torch.zeros(shape, device=device)
        else:
            raise ValueError(f"no draw for {name}, a weight of kind {kind!r}")
    return out


def _meta_inputs(cfg, batch: int = 1):
    S, T = cfg.image_size, cfg.total_frames
    rgb = torch.empty((batch, T, S, S, 3), dtype=torch.uint8, device="meta")
    tubes, mask = ref.initial_cuboids(cfg, "meta")
    props = tubes[None].expand(batch, *tubes.shape)
    weights = {n: torch.empty(s, device="meta") for n, (s, _) in ref.parameter_shapes(cfg).items()}
    return weights, rgb, props, mask[None].expand(batch, -1)


def flops_per_clip(cfg, train: bool) -> int:
    """FLOPs of one clip served (the forward) or trained (forward and
    backward, no recomputation), counted over the reference."""
    from torch.utils.flop_counter import FlopCounterMode

    weights, rgb, props, mask = _meta_inputs(cfg)
    with FlopCounterMode(display=False) as counter:
        if not train:
            with torch.no_grad():
                ref.forward(weights, cfg, rgb, props, ref.Run())
        else:
            P = {n: t.requires_grad_(not ref.is_statistic(n)) for n, t in weights.items()}
            G = cfg.max_gt_tubes
            batch = {"gt_tubes": torch.empty((1, G, cfg.total_frames, 4), device="meta"),
                     "gt_mask": torch.empty((1, G), device="meta"),
                     "gt_labels": (torch.empty((1, G, cfg.num_classes), device="meta")
                                   if cfg.multilabel else
                                   torch.empty((1, G), dtype=torch.int64, device="meta")),
                     "prop_mask": mask}
            out = ref.forward(P, cfg, rgb, props, ref.Run(train=True))
            value, _ = ref_train.loss(out, batch, cfg)
            torch.autograd.grad(value, [p for p in P.values() if p.requires_grad])
    return int(counter.get_total_flops())


def kernel_work_per_clip(cfg) -> dict:
    """`<kind>_bytes` (and `<kind>_ops`, where the kind's records give
    operations) of one clip, summed over every kernel the reference's
    forward records (`Run.record`), at the compute dtype's width: the 3-D
    max pools' `pool3d_bytes`, the tube ROI-aligns' `roi_align_bytes` and
    `roi_align_ops`, and whatever kinds the configuration's backbone
    records."""
    weights, rgb, props, _ = _meta_inputs(cfg)
    width = torch.tensor([], dtype=getattr(torch, cfg.compute_dtype)).element_size()
    rec = []
    with torch.no_grad():
        ref.forward(weights, cfg, rgb, props, ref.Run(rec=rec, width=width))
    out = {}
    for kind, nbytes, ops in rec:
        out[f"{kind}_bytes"] = out.get(f"{kind}_bytes", 0) + nbytes
        if ops is not None:
            out[f"{kind}_ops"] = out.get(f"{kind}_ops", 0) + ops
    return out


def work_per_clip(cfg) -> dict:
    """Every count a configuration's file holds."""
    return {"flops_serve": flops_per_clip(cfg, train=False),
            "flops_train": flops_per_clip(cfg, train=True),
            **kernel_work_per_clip(cfg)}
