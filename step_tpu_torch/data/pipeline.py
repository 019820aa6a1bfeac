"""Batch assembly: proposals, GT-jitter augmentation, the wire formats.

Port of `step_tpu/data/pipeline.py`, which imports `jax.numpy` (through
`step_tpu/preprocess.py` and `step_tpu/tubes/proposals.py`), so the port
keeps its own copy on its own `tubes/proposals.py`, held equal to the
original by `tests/test_torch_port_train.py` and
`tests/test_torch_port_video.py`. Everything here is numpy on the host:
batches carry rgb as [0, 1] float32 or uint8, and the detector normalizes
on the card (`step_tpu_torch/preprocess.py`).
"""

from __future__ import annotations

import numpy as np

from step_tpu_torch.config import StepConfig
from step_tpu_torch.preprocess import RGB_MEAN as _RGB_MEAN
from step_tpu_torch.preprocess import RGB_STD as _RGB_STD
from step_tpu_torch.tubes.proposals import initial_cuboids_np

RGB_MEAN = np.asarray(_RGB_MEAN, np.float32)
RGB_STD = np.asarray(_RGB_STD, np.float32)


def normalize_rgb(rgb: np.ndarray) -> np.ndarray:
    """Host-side normalization, for consumers that bypass the model's own."""
    return (rgb - RGB_MEAN) / RGB_STD


def rgb_to_uint8_wire(rgb: np.ndarray) -> np.ndarray:
    """The [0, 1] float → uint8 wire quantizer, rounding half up (not
    numpy's round half to even), so every surface that ships uint8
    quantizes bit-identically."""
    return (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def flow_to_int8_wire(flow: np.ndarray) -> np.ndarray:
    """The [-1, 1] float → int8 wire quantizer of optical flow."""
    return np.clip(np.round(flow * 127.0), -127, 127).astype(np.int8)


def jitter_gt_proposals(gt_tubes: np.ndarray, gt_mask: np.ndarray, num: int,
                        image_size: float, rng: np.random.RandomState,
                        jitter_frac: float = 0.1):
    """`num` jittered copies of the valid GT tubes `[G, T, 4]` → (`[num, T,
    4]`, mask `[num]`): one whole-tube offset and scale a copy, so the tube
    stays coherent in time."""
    T = gt_tubes.shape[1]
    out = np.zeros((num, T, 4), np.float32)
    mask = np.zeros((num,), np.float32)
    valid = np.flatnonzero(gt_mask > 0)
    if len(valid) == 0:
        return out, mask
    for i in range(num):
        tube = gt_tubes[valid[i % len(valid)]].copy()
        w = tube[:, 2] - tube[:, 0]
        h = tube[:, 3] - tube[:, 1]
        dx = rng.uniform(-jitter_frac, jitter_frac) * w.mean()
        dy = rng.uniform(-jitter_frac, jitter_frac) * h.mean()
        ds = 1.0 + rng.uniform(-jitter_frac, jitter_frac)
        cx = (tube[:, 0] + tube[:, 2]) / 2 + dx
        cy = (tube[:, 1] + tube[:, 3]) / 2 + dy
        nw, nh = w * ds / 2, h * ds / 2
        tube = np.stack([cx - nw, cy - nh, cx + nw, cy + nh], -1)
        out[i] = np.clip(tube, 0.0, image_size)
        mask[i] = 1.0
    return out, mask


def _fit_g(x: np.ndarray, G: int) -> np.ndarray:
    """Pad or truncate axis 1 to G slots."""
    if x.shape[1] >= G:
        return x[:, :G]
    pad = [(0, 0)] * x.ndim
    pad[1] = (0, G - x.shape[1])
    return np.pad(x, pad)


def build_model_batch(raw: dict, cfg: StepConfig, train: bool = False,
                      seed: int = 0, emit_uint8: bool = False) -> dict:
    """raw batch (rgb `[B, T, H, W, 3]` in [0, 1], gt_*) → model batch.

    Adds `proposals` `[B, P, T, 4]` (the initial cuboids, and in training
    jittered GT copies in the padding slots when `cfg.gt_jitter_proposals`)
    and `prop_mask` `[B, P]`; pads or truncates the GT to
    `cfg.max_gt_tubes`; rgb stays [0, 1] float32, or uint8 with
    `emit_uint8`. Multilabel configurations get multi-hot float labels,
    softmax ones int32 labels.
    """
    B, T = raw["rgb"].shape[:2]
    base_tubes, base_mask = initial_cuboids_np(cfg.image_size, T,
                                               cfg.max_proposals,
                                               cfg.cuboid_layout)
    proposals = np.tile(base_tubes[None], (B, 1, 1, 1))
    prop_mask = np.tile(base_mask[None], (B, 1))

    if train and cfg.gt_jitter_proposals > 0:
        rng = np.random.RandomState(seed)
        n_init = int(base_mask.sum())
        n_jit = min(cfg.gt_jitter_proposals, cfg.max_proposals - n_init)
        for b in range(B):
            jt, jm = jitter_gt_proposals(raw["gt_tubes"][b], raw["gt_mask"][b],
                                         n_jit, cfg.image_size, rng)
            proposals[b, n_init:n_init + n_jit] = jt
            prop_mask[b, n_init:n_init + n_jit] = jm

    gt_tubes, gt_mask, labels = raw["gt_tubes"], raw["gt_mask"], raw["gt_labels"]
    G = cfg.max_gt_tubes
    if gt_tubes.shape[1] != G:
        gt_tubes, gt_mask, labels = (_fit_g(gt_tubes, G), _fit_g(gt_mask, G),
                                     _fit_g(labels, G))

    batch = {
        "rgb": (rgb_to_uint8_wire(raw["rgb"]) if emit_uint8
                else raw["rgb"].astype(np.float32)),
        "proposals": proposals.astype(np.float32),
        "prop_mask": prop_mask.astype(np.float32),
        "gt_tubes": gt_tubes.astype(np.float32),
        "gt_mask": gt_mask.astype(np.float32),
    }
    if "flow" in raw:
        batch["flow"] = (flow_to_int8_wire(raw["flow"]) if emit_uint8
                         else raw["flow"].astype(np.float32))
    if cfg.multilabel and labels.ndim == 2:
        onehot = np.zeros((*labels.shape, cfg.num_classes), np.float32)
        for b in range(labels.shape[0]):
            for g in range(labels.shape[1]):
                if gt_mask[b, g] > 0:
                    onehot[b, g, int(labels[b, g])] = 1.0
        batch["gt_labels"] = onehot
    elif cfg.multilabel:
        batch["gt_labels"] = labels.astype(np.float32)
    else:
        batch["gt_labels"] = labels.astype(np.int32)
    return batch
