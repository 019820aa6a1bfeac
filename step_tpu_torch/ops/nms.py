"""Batched greedy NMS: a plain PyTorch version and the kernel wrapper.

Port of `step_tpu/ops/nms.py` and `step_tpu/ops/nms_pallas.py:78-126`
(`nms_many`). N independent problems of P boxes each; `max_keep` greedy
iterations per problem:

  * pick the highest live score, ties to the lowest index;
  * suppress every box with `iou > iou_threshold` against it (the union
    floored at 1e-8), and knock the picked box out explicitly — a
    zero-area box has IoU 0 with itself and would be picked again;
  * a problem with nothing live left freezes: keep_idx 0, keep_mask 0.

The box area is `(x2 - x1) * (y2 - y1)` with no clamp at 0, as the Pallas
kernel computes it (`nms_pallas.py:47`, `:60`); `ops/nms.py` goes through
`box_area`, which clamps. The two agree wherever x1 <= x2 and y1 <= y2,
which `decode_boxes` and `clip_boxes` guarantee on the detection path.
This port follows the Pallas kernel, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

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
    keep_idx = torch.stack(idxs, dim=1).to(torch.int32)
    keep_mask = torch.stack(oks, dim=1).to(torch.float32)
    return keep_idx, keep_mask


def nms_many(boxes: torch.Tensor, scores: torch.Tensor,
             iou_threshold: float = 0.5, max_keep: int = 32,
             score_threshold: float = 0.0, valid: torch.Tensor | None = None):
    """Greedy NMS over N independent P-box problems.

    boxes `[N, P, 4]`, scores `[N, P]`, valid `[N, P]` (optional)
    → keep_idx `[N, max_keep]` int32, keep_mask `[N, max_keep]` float32.

    Scores are pre-masked here (`premask_scores`); a CUDA tensor then goes
    to the hand-written kernel (`csrc/nms.cu`, P <= 32), a CPU tensor to
    `nms_many_plain`. `nms_many.launches` counts kernel launches.
    """
    live = premask_scores(scores, score_threshold, valid)
    if live.device.type == "cpu":
        return nms_many_plain(boxes, live, iou_threshold, max_keep)
    if live.device.type != "cuda":
        raise ValueError(f"nms_many: no kernel for device {live.device}")
    from step_tpu_torch import kernels

    N, P = live.shape
    if boxes.shape != (N, P, 4) or boxes.device != live.device:
        raise ValueError(f"nms_many: boxes {tuple(boxes.shape)} on "
                         f"{boxes.device}, expected [{N}, {P}, 4] on {live.device}")
    keep_idx = torch.empty((N, max_keep), dtype=torch.int32, device=live.device)
    keep_mask = torch.empty((N, max_keep), dtype=torch.float32, device=live.device)
    kernels.nms_many_forward(live.contiguous(),
                             boxes.to(torch.float32).contiguous(),
                             keep_idx, keep_mask, _f32(iou_threshold))
    nms_many.launches += 1
    return keep_idx, keep_mask


nms_many.launches = 0
