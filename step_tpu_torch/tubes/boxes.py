"""Per-frame box math: IoU, delta encoding and decoding, clipping.

Port of `step_tpu/tubes/boxes.py`. Boxes are `[x1, y1, x2, y2]` in pixels;
every function broadcasts over leading axes.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of `[..., 4]` boxes; inverted boxes get area 0."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between a `[..., N, 4]` and b `[..., M, 4]` → `[..., N, M]`."""
    a_exp = a[..., :, None, :]
    b_exp = b[..., None, :, :]
    lt = torch.maximum(a_exp[..., :2], b_exp[..., :2])
    rb = torch.minimum(a_exp[..., 2:], b_exp[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=EPS)


def elementwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU between matching boxes of two `[..., 4]` tensors → `[...]`."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    return inter / torch.clamp(union, min=EPS)


def _to_cxcywh(boxes: torch.Tensor):
    cx = (boxes[..., 0] + boxes[..., 2]) * 0.5
    cy = (boxes[..., 1] + boxes[..., 3]) * 0.5
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=EPS)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=EPS)
    return cx, cy, w, h


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                 variances=(0.1, 0.2)) -> torch.Tensor:
    """Encode target `boxes` relative to `anchors` → deltas `[..., 4]`.

    Anchor extents clamp to 1 px, so a force-matched proposal that
    degenerated to zero width or height gives a bounded target."""
    bcx, bcy, bw, bh = _to_cxcywh(boxes)
    acx, acy, aw, ah = _to_cxcywh(anchors)
    aw = torch.clamp(aw, min=1.0)
    ah = torch.clamp(ah, min=1.0)
    dx = (bcx - acx) / (aw * variances[0])
    dy = (bcy - acy) / (ah * variances[0])
    dw = torch.log(bw / aw) / variances[1]
    dh = torch.log(bh / ah) / variances[1]
    return torch.stack([dx, dy, dw, dh], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor,
                 variances=(0.1, 0.2),
                 max_scale_delta: float = 4.0) -> torch.Tensor:
    """Apply deltas `[..., 4]` to anchors `[..., 4]` → `[x1, y1, x2, y2]`.

    `max_scale_delta` clamps the log-space growth, so one wild regression
    cannot produce an enormous box inside the refinement loop.
    """
    acx, acy, aw, ah = _to_cxcywh(anchors)
    cx = deltas[..., 0] * variances[0] * aw + acx
    cy = deltas[..., 1] * variances[0] * ah + acy
    scale = torch.clamp(deltas[..., 2:4] * variances[1],
                        -max_scale_delta, max_scale_delta)
    w = torch.exp(scale[..., 0]) * aw
    h = torch.exp(scale[..., 1]) * ah
    return torch.stack(
        [cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)


def clip_boxes(boxes: torch.Tensor, height: float, width: float) -> torch.Tensor:
    """Clamp boxes to the image rectangle [0, width] x [0, height]."""
    x1 = torch.clamp(boxes[..., 0], 0.0, width)
    y1 = torch.clamp(boxes[..., 1], 0.0, height)
    x2 = torch.clamp(boxes[..., 2], 0.0, width)
    y2 = torch.clamp(boxes[..., 3], 0.0, height)
    return torch.stack([x1, y1, x2, y2], dim=-1)
