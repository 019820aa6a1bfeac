"""Per-step matching and losses of the progressive training.

Port of `step_tpu/train/losses.py`. For every refinement step, proposals
are matched to the GT tubes by tube IoU with that step's threshold
(cascade-style, with SSD bipartite forcing: each valid GT claims its best
proposal); classification is softmax cross-entropy over background + C
classes with hard-negative mining (UCF) or a focal per-class sigmoid with
positive-count normalization (AVA); box regression is smooth-L1 on the
encoded deltas of the positive proposals over the step's active frames.
The total is the per-step weighted sum.

The JAX package `vmap`s one example and one step; here the batch axis is
a leading tensor axis and the steps a Python loop. GT tubes are padded to
G with a validity mask, proposals to P: nothing is indexed by a boolean.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from step_tpu_torch.config import StepConfig
from step_tpu_torch.tubes.boxes import encode_boxes
from step_tpu_torch.tubes.tube_ops import tube_iou

EPS = 1e-8
NEG_IOU_FOR_INVALID = -1.0


def smooth_l1(x: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    """Huber / smooth-L1, elementwise."""
    ax = x.abs()
    return torch.where(ax < beta, 0.5 * ax * ax / beta, ax - 0.5 * beta)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x `[..., G, *rest]` at idx `[..., P]` of its G axis → `[..., P, *rest]`."""
    lead = idx.dim() - 1
    rest = x.shape[lead + 1:]
    index = idx.reshape(*idx.shape, *(1,) * len(rest)).expand(*idx.shape, *rest)
    return torch.gather(x, lead, index)


def match_tubes(proposals: torch.Tensor, gt_tubes: torch.Tensor,
                gt_mask: torch.Tensor, frame_mask: torch.Tensor,
                iou_threshold, prop_mask: torch.Tensor | None = None,
                force_best_match: bool = True):
    """Match proposals `[..., P, T, 4]` to GT tubes `[..., G, T, 4]` by
    masked tube IoU over the frames of `frame_mask` `[T]`.

    Besides the IoU >= threshold rule, every valid GT claims its single
    best proposal (`force_best_match`). Padded GT slots never match;
    padded proposals (`prop_mask` 0) are never positive.

    Returns (best_gt `[..., P]` int64, best_iou `[..., P]`, positive
    `[..., P]` float32).
    """
    iou = tube_iou(proposals, gt_tubes, frame_mask)                 # [..., P, G]
    iou = torch.where(gt_mask[..., None, :] > 0, iou,
                      torch.full_like(iou, NEG_IOU_FOR_INVALID))
    if prop_mask is not None:
        iou = torch.where(prop_mask[..., :, None] > 0, iou,
                          torch.full_like(iou, NEG_IOU_FOR_INVALID))
    best_iou = iou.max(dim=-1).values

    matched = iou
    if force_best_match:
        best_p = torch.argmax(iou, dim=-2)                          # [..., G]
        boost = (2.0 * gt_mask).to(iou.dtype)
        matched = iou.scatter_add(-2, best_p[..., None, :], boost[..., None, :])

    best_gt = torch.argmax(matched, dim=-1)                         # first max
    match_val = matched.max(dim=-1).values
    positive = (match_val >= iou_threshold).to(torch.float32)
    if prop_mask is not None:
        positive = positive * (prop_mask > 0)
    return best_gt, best_iou, positive


def cls_loss_softmax(cls_logits, best_gt, positive, gt_labels, prop_mask,
                     neg_pos_ratio: float = 0.0):
    """Softmax CE over [background + C] classes, one value an example:
    cls_logits `[B, P, C+1]`, gt_labels `[B, G]` (foreground class in
    [0, C)), the rest `[B, P]`. With `neg_pos_ratio` > 0 only the hardest
    `neg_pos_ratio` negatives per positive count (SSD hard-negative
    mining)."""
    target_fg = torch.gather(gt_labels.to(torch.int64), -1, best_gt) + 1
    target = torch.where(positive > 0, target_fg, torch.zeros_like(target_fg))
    logp = F.log_softmax(cls_logits, dim=-1)
    ce = -torch.gather(logp, -1, target[..., None])[..., 0]          # [B, P]
    if neg_pos_ratio <= 0:
        return ((ce * prop_mask).sum(-1)
                / torch.clamp(prop_mask.sum(-1), min=EPS))

    pos = positive * prop_mask
    neg = (1.0 - positive) * prop_mask
    num_pos = pos.sum(-1)
    neg_ce = ce * neg
    # rank negatives by CE, hardest first, with pairwise comparisons
    harder = (neg_ce[..., None, :] > neg_ce[..., :, None]).to(torch.float32)
    rank = (harder * neg[..., None, :]).sum(-1)                      # [B, P]
    num_keep = neg_pos_ratio * torch.clamp(num_pos, min=1.0)
    keep_neg = neg * (rank < num_keep[..., None]).to(torch.float32)
    total = (ce * pos).sum(-1) + (ce * keep_neg).sum(-1)
    return total / torch.clamp(num_pos + keep_neg.sum(-1), min=EPS)


def cls_loss_sigmoid(cls_logits, best_gt, positive, gt_labels, prop_mask,
                     focal_gamma: float = 2.0, focal_alpha: float = 0.25):
    """Per-class sigmoid BCE, one value an example: positives take their
    GT's multi-hot vector (gt_labels `[B, G, C]`), negatives all zeros;
    focal modulation when `focal_gamma` > 0; the sum over proposals and
    classes divided by the positive count (at least 1)."""
    target = _gather(gt_labels, best_gt) * positive[..., None]       # [B, P, C]
    bce = (torch.clamp(cls_logits, min=0) - cls_logits * target
           + torch.log1p(torch.exp(-cls_logits.abs())))
    if focal_gamma > 0:
        p = torch.sigmoid(cls_logits)
        p_t = p * target + (1.0 - p) * (1.0 - target)
        alpha_t = focal_alpha * target + (1.0 - focal_alpha) * (1.0 - target)
        bce = alpha_t * torch.pow(1.0 - p_t, focal_gamma) * bce
    per_prop = bce.sum(-1)
    num_pos = torch.clamp((positive * prop_mask).sum(-1), min=1.0)
    return (per_prop * prop_mask).sum(-1) / num_pos


def reg_loss(deltas, proposals, best_gt, positive, gt_tubes, frame_mask,
             prop_mask, variances):
    """Smooth-L1 on the encoded per-frame deltas `[B, P, T, 4]` of the
    positive proposals over the frames of `frame_mask`, one value an
    example."""
    matched_gt = _gather(gt_tubes, best_gt)                          # [B, P, T, 4]
    target = encode_boxes(matched_gt, proposals, variances)
    l1 = smooth_l1(deltas - target).sum(-1)                          # [B, P, T]
    w = positive * prop_mask
    per_prop = ((l1 * frame_mask).sum(-1)
                / torch.clamp(frame_mask.sum(), min=EPS))
    return (per_prop * w).sum(-1) / torch.clamp(w.sum(-1), min=EPS)


def step_losses(outputs: dict, gt_tubes: torch.Tensor, gt_labels: torch.Tensor,
                gt_mask: torch.Tensor, prop_mask: torch.Tensor, cfg: StepConfig):
    """Total progressive loss and metrics over all refinement steps.

    `outputs` is `STEPDetector.forward`'s dict (a leading step axis S);
    gt_tubes `[B, G, T, 4]`, gt_labels `[B, G]` int (softmax) or `[B, G, C]`
    (multilabel), gt_mask `[B, G]`, prop_mask `[B, P]`. Returns (loss,
    metrics): `loss`, and per step `cls_loss_per_step`,
    `reg_loss_per_step` (means over the batch) and `num_positive_per_step`
    (a sum over the batch).
    """
    S = cfg.num_steps
    dev = gt_tubes.device
    thresholds = torch.tensor(cfg.iou_thresholds[:S], dtype=torch.float32, device=dev)
    weights = torch.tensor(cfg.step_loss_weights[:S], dtype=torch.float32, device=dev)
    has_gt = (gt_mask.sum(-1) > 0).to(torch.float32)                 # [B]
    cls_l, reg_l, npos = [], [], []
    for s in range(S):
        proposals = outputs["proposals"][s]
        fmask = outputs["frame_mask"][s]
        best_gt, _, positive = match_tubes(proposals, gt_tubes, gt_mask, fmask,
                                           thresholds[s], prop_mask=prop_mask)
        positive = positive * has_gt[:, None]       # no GT at all: no match
        if cfg.multilabel:
            cls = cls_loss_sigmoid(outputs["cls_logits"][s], best_gt, positive,
                                   gt_labels, prop_mask, cfg.focal_gamma,
                                   cfg.focal_alpha)
        else:
            cls = cls_loss_softmax(outputs["cls_logits"][s], best_gt, positive,
                                   gt_labels, prop_mask, cfg.neg_pos_ratio)
        reg = reg_loss(outputs["deltas"][s], proposals, best_gt, positive,
                       gt_tubes, fmask, prop_mask, cfg.box_variances) * has_gt
        cls_l.append(cls.mean())
        reg_l.append(reg.mean())
        npos.append(positive.sum())
    cls_l, reg_l, npos = torch.stack(cls_l), torch.stack(reg_l), torch.stack(npos)
    total = (weights * (cls_l + cfg.reg_loss_weight * reg_l)).sum()
    metrics = {"loss": total, "cls_loss_per_step": cls_l,
               "reg_loss_per_step": reg_l, "num_positive_per_step": npos}
    return total, metrics
