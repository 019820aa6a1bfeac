"""Batched greedy NMS: a plain PyTorch version and the kernel wrapper.

Port of `step_tpu/ops/nms.py` and `step_tpu/ops/nms_pallas.py:78-126`
(`nms_many`). N independent problems of P boxes each; `max_keep` greedy
iterations per problem:

  * pick the highest live score, ties to the lowest index;
  * suppress every box with `iou > iou_threshold` against it (the union
    floored at 1e-8), and knock the picked box out explicitly — a
    zero-area box has IoU 0 with itself and would be picked again;
  * a problem with nothing live left (no live score above NEG/2) freezes:
    keep_mask 0, keep_idx the lowest index of the maximum of the live
    scores as they stand (0 when all are NEG).

The box area is `(x2 - x1) * (y2 - y1)` with no clamp at 0, as the Pallas
kernel computes it (`nms_pallas.py:47`, `:60`); `ops/nms.py` goes through
`box_area`, which clamps. The two agree wherever x1 <= x2 and y1 <= y2,
which `decode_boxes` and `clip_boxes` guarantee on the detection path.
Minimum and maximum propagate NaN, as `jnp.minimum`/`jnp.maximum` do, so
a box with a NaN coordinate suppresses nothing and is suppressed by
nothing. This port follows the Pallas kernel, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from step_tpu_torch.ops.kernel_op import LAUNCHES

NEG = -1e9
EPS = 1e-8


def _f32(x: float) -> float:
    """`x` rounded to float32: comparisons against it then give the same
    answer in float32 and float64."""
    return float(np.float32(x))


def premask_scores(scores: torch.Tensor, score_threshold: float,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Scores `[N, P]` → float32 live scores: NEG where `valid <= 0` or the
    score is not above `score_threshold`."""
    live = scores.to(torch.float32)
    neg = torch.full_like(live, NEG)
    if valid is not None:
        live = torch.where(valid > 0, live, neg)
    return torch.where(live > _f32(score_threshold), live, neg)


def nms_many_plain(boxes: torch.Tensor, live: torch.Tensor,
                   iou_threshold: float, max_keep: int):
    """Greedy NMS on pre-masked live scores `[N, P]` f32 and boxes
    `[N, P, 4]` f32 → keep_idx `[N, max_keep]` int32, keep_mask f32."""
    N, P = live.shape
    x1, y1, x2, y2 = boxes.to(torch.float32).unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    iota = torch.arange(P, device=live.device).expand(N, P)
    thr = _f32(iou_threshold)
    idxs, oks = [], []
    for _ in range(max_keep):
        best = live.max(dim=1, keepdim=True).values
        idx = torch.where(live == best, iota, P).min(dim=1, keepdim=True).values
        ok = best > NEG / 2                                     # [N, 1]
        sel = lambda a: torch.gather(a, 1, idx)                 # noqa: E731
        cx1, cy1, cx2, cy2 = sel(x1), sel(y1), sel(x2), sel(y2)
        carea = (cx2 - cx1) * (cy2 - cy1)
        w = torch.clamp(torch.minimum(cx2, x2) - torch.maximum(cx1, x1), min=0.0)
        h = torch.clamp(torch.minimum(cy2, y2) - torch.maximum(cy1, y1), min=0.0)
        inter = w * h
        iou = inter / torch.clamp(carea + area - inter, min=EPS)
        drop = (iou > thr) | (iota == idx)
        live = torch.where(ok & drop, torch.full_like(live, NEG), live)
        idxs.append(idx[:, 0])
        oks.append(ok[:, 0])
    if not idxs:
        return (torch.empty((N, 0), dtype=torch.int32, device=live.device),
                torch.empty((N, 0), dtype=torch.float32, device=live.device))
    keep_idx = torch.stack(idxs, dim=1).to(torch.int32)
    keep_mask = torch.stack(oks, dim=1).to(torch.float32)
    return keep_idx, keep_mask


def kernel_valid(valid: torch.Tensor | None) -> torch.Tensor | None:
    """`valid` as the kernel reads it: float32 or bool as it is, any other
    dtype as the bool `valid > 0`."""
    if valid is None or valid.dtype in (torch.float32, torch.bool):
        return valid
    return valid > 0


def nms_many(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.5, max_keep: int = 32,
             score_threshold: float = 0.0, valid: torch.Tensor | None = None):
    """Greedy NMS over N independent P-box problems.

    boxes `[N, P, 4]`, scores `[N, P]`, valid `[N, P]` (optional)
    → keep_idx `[N, max_keep]` int32, keep_mask `[N, max_keep]` float32.

    A CPU tensor goes to `premask_scores` and `nms_many_plain`; a CUDA
    tensor to the hand-written kernel (`csrc/nms.cu`: N groups of one
    problem, P up to `kernels.NMS_MAX_BOXES`), which pre-masks the scores
    itself, counted in `kernel_op.LAUNCHES["nms_many"]`.
    """
    if scores.device.type == "cpu":
        return nms_many_plain(boxes, premask_scores(scores, score_threshold, valid),
                              iou_threshold, max_keep)
    if scores.device.type != "cuda":
        raise ValueError(f"nms_many: no kernel for device {scores.device}")
    from step_tpu_torch import kernels

    N, P = scores.shape
    if boxes.shape != (N, P, 4) or boxes.device != scores.device:
        raise ValueError(f"nms_many: boxes {tuple(boxes.shape)} on "
                         f"{boxes.device}, expected [{N}, {P}, 4] on {scores.device}")
    if scores.dtype not in (torch.float32, torch.bfloat16):
        scores = scores.to(torch.float32)    # exact: premask_scores does it first
    boxes = boxes.to(torch.float32)
    if boxes.stride(-1) != 1:
        boxes = boxes.contiguous()
    valid = kernel_valid(valid)
    keep_idx = torch.empty((N, max_keep), dtype=torch.int32, device=scores.device)
    keep_mask = torch.empty((N, max_keep), dtype=torch.float32, device=scores.device)
    if keep_mask.numel() == 0:
        return keep_idx, keep_mask
    kernels.nms_many_forward(
        boxes[:, None], scores[:, None, :, None],
        None if valid is None else valid[:, None], keep_mask.view(N, 1, 1, max_keep),
        _f32(iou_threshold), _f32(score_threshold),
        keep_idx=keep_idx.view(N, 1, 1, max_keep))
    LAUNCHES["nms_many"] += 1
    return keep_idx, keep_mask
