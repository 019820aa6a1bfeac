"""Clip detection: the progressive forward, class scores, per-frame NMS.

Port of `step_tpu/inference.py`: `class_scores_from_logits` (:26-31),
`nms_surface` (:40-94, the batched-NMS branch) and `detect_clip`
(:126-151). Survivors are gathered with `torch.gather`; the reference's
one-hot matmul select for large surfaces (:70-82) gives identical values
and is a TPU device, not ported.
"""

from __future__ import annotations

import torch

from step_tpu_torch.config import StepConfig
from step_tpu_torch.ops.nms import nms_many


def class_scores_from_logits(cls_logits: torch.Tensor, cfg: StepConfig) -> torch.Tensor:
    """`[..., ncls]` logits → `[..., C]` foreground probabilities: sigmoid
    for multilabel datasets, else softmax with the background column
    dropped."""
    if cfg.multilabel:
        return torch.sigmoid(cls_logits)
    return torch.softmax(cls_logits, dim=-1)[..., 1:]


def nms_surface(tubes: torch.Tensor, scores: torch.Tensor,
                prop_mask: torch.Tensor, cfg: StepConfig):
    """Per-frame, per-class greedy NMS over the final tubes.

    tubes `[B, P, T, 4]`, scores `[B, P, C]` (already masked to real
    proposals), prop_mask `[B, P]`. Runs B·T·C independent problems of P
    boxes; K = min(max_detections, P) keep slots each.
    """
    B, P, T = tubes.shape[:3]
    C = scores.shape[-1]
    K = min(cfg.max_detections, P)
    boxes_prob = tubes.transpose(1, 2)[:, :, None].expand(B, T, C, P, 4)
    scores_prob = scores.transpose(1, 2)[:, None].expand(B, T, C, P)
    valid_prob = prop_mask[:, None, None].expand(B, T, C, P)
    idx, mask = nms_many(boxes_prob.reshape(-1, P, 4), scores_prob.reshape(-1, P),
                         cfg.nms_thresh, K, cfg.score_thresh,
                         valid_prob.reshape(-1, P))
    keep_idx = idx.reshape(B, T, C, K).to(torch.int64)
    keep_mask = mask.reshape(B, T, C, K)
    frame_boxes = torch.gather(boxes_prob, 3,
                               keep_idx[..., None].expand(B, T, C, K, 4))
    frame_scores = torch.gather(scores_prob, 3, keep_idx) * keep_mask
    return {
        "tubes": tubes,
        "tube_scores": scores,
        "frame_boxes": frame_boxes,
        "frame_scores": frame_scores,
        "frame_mask": keep_mask,
    }


@torch.inference_mode()
def detect_clip(model, rgb: torch.Tensor, proposals: torch.Tensor,
                prop_mask: torch.Tensor):
    """Full detection for a batch of clips with `model`
    (`step_tpu_torch.models.detector.STEPDetector`, its config in
    `model.cfg`).

    rgb `[B, T, H, W, 3]` uint8 (or float in [0, 1]), proposals
    `[B, P, T, 4]`, prop_mask `[B, P]`. Returns:
      tubes        `[B, P, T, 4]` — final refined tubes
      tube_scores  `[B, P, C]`    — per-tube class probabilities, 0 on
                                    padding slots
      frame_boxes  `[B, T, C, K, 4]`, frame_scores `[B, T, C, K]`,
      frame_mask   `[B, T, C, K]`    — per-frame per-class NMS survivors
    """
    cfg = model.cfg
    outputs = model(rgb, proposals)
    tubes = outputs["tubes"][-1]
    scores = class_scores_from_logits(outputs["cls_logits"][-1], cfg)
    # Padding slots are never supervised, so their logits mean nothing:
    # zero them before anyone reads the scores.
    scores = scores * prop_mask[..., None].to(scores.dtype)
    return nms_surface(tubes, scores, prop_mask, cfg)
