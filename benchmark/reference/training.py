"""The plain reference of one STEP training step, in float32 PyTorch.

The progressive loss (per step: tube matching by IoU with SSD's forced
best match, softmax cross-entropy with hard-negative mining or a focal
sigmoid, smooth-L1 on the encoded deltas of the positives), BatchNorm's
running update (flax's, momentum 0.9, from the batch's biased variance,
committed after the backward), and the optimizer: global-norm clipping to
10, AdamW (b1 0.9, b2 0.999, eps 1e-8, float32 moments, decoupled weight
decay) and the warmup-cosine or step schedule, whose step 0 applies the
schedule's value at 0. Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import detector as ref

CLIP_NORM = 10.0
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8
BN_MOMENTUM = 0.9
EPS = 1e-8


# ---------------------------------------------------------------- losses
def _area(b):
    return torch.clamp(b[..., 2] - b[..., 0], min=0.0) * torch.clamp(b[..., 3] - b[..., 1], min=0.0)


def tube_iou(a, b, fmask):
    """Mean per-frame IoU of tubes a `[..., P, T, 4]` and b `[..., G, T,
    4]` over the frames of `fmask` → `[..., P, G]`."""
    a, b = a[..., :, None, :, :], b[..., None, :, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    iou = inter / torch.clamp(_area(a) + _area(b) - inter, min=EPS)
    return (iou * fmask).sum(-1) / torch.clamp(fmask.sum(-1), min=EPS)


def _gather(x, idx):
    rest = x.shape[idx.dim():]
    index = idx.reshape(*idx.shape, *(1,) * len(rest)).expand(*idx.shape, *rest)
    return torch.gather(x, idx.dim() - 1, index)


def match(proposals, gt_tubes, gt_mask, fmask, threshold, prop_mask):
    iou = tube_iou(proposals, gt_tubes, fmask)
    iou = torch.where(gt_mask[..., None, :] > 0, iou, torch.full_like(iou, -1.0))
    iou = torch.where(prop_mask[..., :, None] > 0, iou, torch.full_like(iou, -1.0))
    best_p = torch.argmax(iou, dim=-2)
    matched = iou.scatter_add(-2, best_p[..., None, :], (2.0 * gt_mask)[..., None, :])
    best_gt = torch.argmax(matched, dim=-1)
    positive = (matched.max(dim=-1).values >= threshold).to(torch.float32) * (prop_mask > 0)
    return best_gt, positive


def cls_softmax(logits, best_gt, positive, labels, prop_mask, neg_pos_ratio):
    target = torch.gather(labels.to(torch.int64), -1, best_gt) + 1
    target = torch.where(positive > 0, target, torch.zeros_like(target))
    ce = -torch.gather(F.log_softmax(logits, dim=-1), -1, target[..., None])[..., 0]
    if neg_pos_ratio <= 0:
        return (ce * prop_mask).sum(-1) / torch.clamp(prop_mask.sum(-1), min=EPS)
    pos = positive * prop_mask
    neg = (1.0 - positive) * prop_mask
    num_pos = pos.sum(-1)
    neg_ce = ce * neg
    rank = ((neg_ce[..., None, :] > neg_ce[..., :, None]).to(torch.float32) * neg[..., None, :]).sum(-1)
    keep_neg = neg * (rank < (neg_pos_ratio * torch.clamp(num_pos, min=1.0))[..., None]).to(torch.float32)
    total = (ce * pos).sum(-1) + (ce * keep_neg).sum(-1)
    return total / torch.clamp(num_pos + keep_neg.sum(-1), min=EPS)


def cls_sigmoid(logits, best_gt, positive, labels, prop_mask, gamma, alpha):
    target = _gather(labels, best_gt) * positive[..., None]
    bce = (torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-logits.abs())))
    if gamma > 0:
        p = torch.sigmoid(logits)
        p_t = p * target + (1.0 - p) * (1.0 - target)
        alpha_t = alpha * target + (1.0 - alpha) * (1.0 - target)
        bce = alpha_t * torch.pow(1.0 - p_t, gamma) * bce
    return (bce.sum(-1) * prop_mask).sum(-1) / torch.clamp((positive * prop_mask).sum(-1), min=1.0)


def reg_loss(deltas, proposals, best_gt, positive, gt_tubes, fmask, prop_mask, variances):
    target = ref.encode_boxes(_gather(gt_tubes, best_gt), proposals, variances)
    x = deltas - target
    ax = x.abs()
    l1 = torch.where(ax < 1.0, 0.5 * ax * ax, ax - 0.5).sum(-1)
    w = positive * prop_mask
    per = (l1 * fmask).sum(-1) / torch.clamp(fmask.sum(), min=EPS)
    return (per * w).sum(-1) / torch.clamp(w.sum(-1), min=EPS)


def loss(out, batch, cfg):
    """The progressive loss of a forward's per-step outputs on a batch, and
    the positives each refinement step matched (a sum over the batch)."""
    dev = batch["gt_tubes"].device
    has_gt = (batch["gt_mask"].sum(-1) > 0).to(torch.float32)
    total = torch.zeros((), device=dev)
    positives = []
    for s in range(cfg.num_steps):
        props, fmask = out["proposals"][s], out["frame_mask"][s]
        best_gt, positive = match(props, batch["gt_tubes"], batch["gt_mask"], fmask,
                                  float(np.float32(cfg.iou_thresholds[s])), batch["prop_mask"])
        positive = positive * has_gt[:, None]
        positives.append(positive.sum())
        if cfg.multilabel:
            cls = cls_sigmoid(out["cls_logits"][s], best_gt, positive, batch["gt_labels"],
                              batch["prop_mask"], cfg.focal_gamma, cfg.focal_alpha)
        else:
            cls = cls_softmax(out["cls_logits"][s], best_gt, positive, batch["gt_labels"],
                              batch["prop_mask"], cfg.neg_pos_ratio)
        reg = reg_loss(out["deltas"][s], props, best_gt, positive, batch["gt_tubes"], fmask,
                       batch["prop_mask"], cfg.box_variances) * has_gt
        total = total + cfg.step_loss_weights[s] * (cls.mean() + cfg.reg_loss_weight * reg.mean())
    return total, torch.stack(positives)


# ---------------------------------------------------------------- the optimizer
def learning_rate(cfg, step: int) -> float:
    f32 = np.float32
    lr = f32(cfg.learning_rate)
    if cfg.lr_schedule == "step":
        warm = min(f32(step) / f32(cfg.warmup_steps), f32(1.0)) if cfg.warmup_steps else f32(1.0)
        drops = f32(sum(step >= int(m) for m in cfg.lr_decay_milestones))
        return float(lr * warm * f32(cfg.lr_decay_rate) ** drops)
    warmup = cfg.warmup_steps
    decay = max(cfg.total_steps, warmup + 1) - warmup
    if warmup > 0 and step < warmup:
        return float((f32(0.0) - lr) * (f32(1.0) - f32(step) / f32(warmup)) + lr)
    count = f32(min(step - warmup, decay))
    return float(lr * f32(0.5) * (f32(1.0) + np.cos(f32(math.pi) * count / f32(decay))))


def adamw(params, grads, state, cfg):
    """One AdamW step of the clipped gradients, in place; returns them."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < CLIP_NORM, torch.ones_like(norm), CLIP_NORM / norm)
    grads = [g * scale for g in grads]
    t = state["count"] + 1
    lr = learning_rate(cfg, state["count"])
    bc1 = float(np.float32(1.0) - np.float32(B1) ** np.float32(t))
    bc2 = float(np.float32(1.0) - np.float32(B2) ** np.float32(t))
    for i, (p, g) in enumerate(zip(params, grads)):
        state["mu"][i] = B1 * state["mu"][i] + (1 - B1) * g
        state["nu"][i] = B2 * state["nu"][i] + (1 - B2) * g * g
        u = (state["mu"][i] / bc1) / (torch.sqrt(state["nu"][i] / bc2) + ADAM_EPS)
        p.sub_(lr * (u + cfg.weight_decay * p))
    state["count"] = t
    return grads


def _half(n):
    return -(-n // 2)


class Trainer:
    """The reference's training state from `weights` (name → float32
    tensor, the statistics included): the parameters, AdamW's moments,
    and the BatchNorm statistics, updated by `step`."""

    def __init__(self, weights, cfg, generator, prec=ref.FLOAT32):
        self.cfg, self.generator, self.prec = cfg, generator, prec
        self.P = {n: t.detach().clone().requires_grad_(not ref.is_statistic(n))
                  for n, t in weights.items()}
        self.names = [n for n in self.P if not ref.is_statistic(n)]
        self.params = [self.P[n] for n in self.names]
        self.state = {"count": 0, "mu": [torch.zeros_like(p) for p in self.params],
                      "nu": [torch.zeros_like(p) for p in self.params]}

    def step(self, batch):
        """One step on `batch` (device tensors: rgb uint8, proposals,
        prop_mask, gt_tubes, gt_labels, gt_mask), its dropout masks drawn
        from the generator → (loss, positives of each refinement step, the
        clipped gradients by name)."""
        cfg = self.cfg
        run = ref.Run(self.prec, train=True)
        B = batch["rgb"].shape[0]
        masks = (ref.dropout_masks(cfg, B, self.generator, batch["rgb"].device,
                                   _half(_half(cfg.total_frames)))
                 if cfg.dropout_rate > 0 else None)
        out = ref.forward(self.P, cfg, batch["rgb"], batch["proposals"], run, masks)
        value, positives = loss(out, batch, cfg)
        grads = torch.autograd.grad(value, self.params)
        with torch.no_grad():
            clipped = adamw(self.params, list(grads), self.state, cfg)
            for name, (mean, var) in run.stats.items():
                self.P[f"{name}.running_mean"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
                self.P[f"{name}.running_var"].mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        return value.detach(), positives, dict(zip(self.names, clipped))


def train_steps(weights, cfg, batches, generator):
    """Train from `weights` on `batches` → (the loss of each step, the
    positives its first refinement step matched, the clipped gradients of
    the first step, the weights after the last)."""
    trainer = Trainer(weights, cfg, generator)
    losses, positives, first_grads = [], [], None
    for batch in batches:
        value, matched, grads = trainer.step(batch)
        losses.append(float(value))
        positives.append(float(matched[0]))
        first_grads = grads if first_grads is None else first_grads
    return losses, positives, first_grads, {n: t.detach() for n, t in trainer.P.items()}
