"""Tube-aware clip augmentation, applied alike to all T frames so that the
GT tubes stay valid: photometric distortion, zoom-out expand, a random crop
that keeps most of every tube, horizontal mirror; and `resize_clip`.

A copy of `step_tpu/data/augmentations.py` (the port imports nothing of the
JAX package), held bit-equal to it under the same `np.random.RandomState`
by `tests/test_torch_port_ucf.py`. Host-side numpy; `resize_clip` imports
cv2 when it is called.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class TubeAugmentConfig:
    hflip_prob: float = 0.5
    photometric_prob: float = 0.5
    brightness_delta: float = 0.12      # additive, [0,1] scale
    contrast_range: tuple = (0.7, 1.3)
    saturation_range: tuple = (0.7, 1.3)
    expand_prob: float = 0.3
    expand_max_ratio: float = 1.6
    crop_prob: float = 0.5
    crop_min_scale: float = 0.6
    crop_min_overlap: float = 0.5       # kept fraction of each GT box area
    max_tries: int = 20


class TubeAugment:
    """Augment (frames [T,H,W,3] in [0,1], tubes [G,T,4], mask [G]).

    With `flow` ([T,H,W,2] in [-1,1], channels = (x, y) displacement), every
    **geometric** transform applies identically to the flow field so it stays
    spatially registered with the RGB stream and the GT tubes: expand pastes
    flow onto a zero-motion canvas, crop uses the same window, and horizontal
    flip both mirrors the field and negates its x component. Photometric
    distortion is RGB-only (flow is not an image).
    """

    def __init__(self, cfg: TubeAugmentConfig = TubeAugmentConfig()):
        self.cfg = cfg

    def __call__(self, frames, tubes, gt_mask, rng: np.random.RandomState,
                 flow=None):
        frames = frames.copy()
        tubes = tubes.copy()
        c = self.cfg
        # rng draw order is identical with and without flow → same transforms.
        if rng.rand() < c.photometric_prob:
            frames = self._photometric(frames, rng)
        if rng.rand() < c.expand_prob:
            frames, tubes, flow = self._expand(frames, tubes, rng, flow)
        if rng.rand() < c.crop_prob:
            frames, tubes, gt_mask, flow = self._crop(
                frames, tubes, gt_mask, rng, flow
            )
        if rng.rand() < c.hflip_prob:
            frames, tubes, flow = self._hflip(frames, tubes, flow)
        frames = np.clip(frames, 0.0, 1.0)
        if flow is None:
            return frames, tubes, gt_mask
        return frames, tubes, gt_mask, flow

    # ------------------------------------------------------------- pieces
    def _photometric(self, frames, rng):
        c = self.cfg
        frames = frames + rng.uniform(-c.brightness_delta, c.brightness_delta)
        mean = frames.mean(axis=(1, 2, 3), keepdims=True)
        frames = (frames - mean) * rng.uniform(*c.contrast_range) + mean
        gray = frames.mean(axis=-1, keepdims=True)
        frames = gray + (frames - gray) * rng.uniform(*c.saturation_range)
        return frames

    def _hflip(self, frames, tubes, flow=None):
        W = frames.shape[2]
        frames = frames[:, :, ::-1]
        x1 = W - tubes[..., 2]
        x2 = W - tubes[..., 0]
        tubes = np.stack([x1, tubes[..., 1], x2, tubes[..., 3]], -1)
        if flow is not None:
            flow = flow[:, :, ::-1].copy()
            flow[..., 0] = -flow[..., 0]  # mirrored motion points the other way
        return frames, tubes, flow

    def _expand(self, frames, tubes, rng, flow=None):
        """Zoom out: paste the clip into a larger mean-colored canvas."""
        T, H, W, C = frames.shape
        ratio = rng.uniform(1.0, self.cfg.expand_max_ratio)
        nH, nW = int(H * ratio), int(W * ratio)
        top = rng.randint(0, nH - H + 1)
        left = rng.randint(0, nW - W + 1)
        canvas = np.full((T, nH, nW, C), frames.mean(), frames.dtype)
        canvas[:, top : top + H, left : left + W] = frames
        tubes = tubes + np.asarray([left, top, left, top], tubes.dtype)
        if flow is not None:
            fcanvas = np.zeros((T, nH, nW, flow.shape[-1]), flow.dtype)
            fcanvas[:, top : top + H, left : left + W] = flow
            flow = fcanvas
        return canvas, tubes, flow

    def _crop(self, frames, tubes, gt_mask, rng, flow=None):
        """Random crop keeping >= crop_min_overlap of every valid GT box."""
        T, H, W, _ = frames.shape
        c = self.cfg
        for _ in range(c.max_tries):
            scale = rng.uniform(c.crop_min_scale, 1.0)
            ch, cw = int(H * scale), int(W * scale)
            top = rng.randint(0, H - ch + 1)
            left = rng.randint(0, W - cw + 1)
            ok = True
            for g in range(tubes.shape[0]):
                if gt_mask[g] <= 0:
                    continue
                boxes = tubes[g]
                ix1 = np.maximum(boxes[:, 0], left)
                iy1 = np.maximum(boxes[:, 1], top)
                ix2 = np.minimum(boxes[:, 2], left + cw)
                iy2 = np.minimum(boxes[:, 3], top + ch)
                inter = np.maximum(ix2 - ix1, 0) * np.maximum(iy2 - iy1, 0)
                area = np.maximum(
                    (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]), 1e-6
                )
                if (inter / area).min() < c.crop_min_overlap:
                    ok = False
                    break
            if ok:
                frames = frames[:, top : top + ch, left : left + cw]
                tubes = tubes - np.asarray([left, top, left, top], tubes.dtype)
                tubes[..., 0::2] = np.clip(tubes[..., 0::2], 0, cw)
                tubes[..., 1::2] = np.clip(tubes[..., 1::2], 0, ch)
                if flow is not None:
                    flow = flow[:, top : top + ch, left : left + cw]
                return frames, tubes, gt_mask, flow
        return frames, tubes, gt_mask, flow


def resize_clip(frames: np.ndarray, tubes: np.ndarray, size: int):
    """Resize clip to (size, size); scale tubes accordingly."""
    import cv2

    T, H, W, _ = frames.shape
    out = np.empty((T, size, size, frames.shape[-1]), frames.dtype)
    for t in range(T):
        out[t] = cv2.resize(frames[t], (size, size), interpolation=cv2.INTER_LINEAR).reshape(
            size, size, -1
        )
    sx, sy = size / W, size / H
    tubes = tubes * np.asarray([sx, sy, sx, sy], tubes.dtype)
    return out, tubes
