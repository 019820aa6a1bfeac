"""Detection metrics: VOC-style AP, frame-mAP, tube video-mAP.

A copy of `step_tpu/eval/detection_metrics.py` (numpy only), held equal to
it by `tests/test_torch_port_video.py`.

Reference parity: UCF101-24 frame-mAP@0.5 and video-mAP@{0.2,0.5,0.5:0.95}
(``test.py`` + ``utils`` eval code (recon)). Conventions follow the standard
UCF101-24 protocol:

  * frame-mAP: per-class all-point-interpolated AP over per-frame boxes at
    spatial IoU >= thresh; each GT box matches at most one detection
    (greedy, detections sorted by score).
  * video-mAP: AP over video-long tubes; spatio-temporal tube IoU =
    temporal IoU (frame-span overlap) x mean spatial IoU over the
    intersection frames.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Sequence, Tuple

import numpy as np

Box = np.ndarray  # [4] x1y1x2y2


def _iou_1vsN(box: Box, boxes: np.ndarray) -> np.ndarray:
    if len(boxes) == 0:
        return np.zeros((0,), np.float32)
    x1 = np.maximum(box[0], boxes[:, 0])
    y1 = np.maximum(box[1], boxes[:, 1])
    x2 = np.minimum(box[2], boxes[:, 2])
    y2 = np.minimum(box[3], boxes[:, 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    a = (box[2] - box[0]) * (box[3] - box[1])
    b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(a + b - inter, 1e-8)


def average_precision(scores: np.ndarray, tp: np.ndarray, num_gt: int) -> float:
    """All-point interpolated AP (VOC 2010+ / COCO style, no sampling)."""
    if num_gt == 0:
        return float("nan")
    if len(scores) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = tp[order].astype(np.float64)
    fp = 1.0 - tp
    ctp, cfp = np.cumsum(tp), np.cumsum(fp)
    recall = ctp / num_gt
    precision = ctp / np.maximum(ctp + cfp, 1e-8)
    # envelope
    for i in range(len(precision) - 1, 0, -1):
        precision[i - 1] = max(precision[i - 1], precision[i])
    # integrate over recall deltas
    r = np.concatenate([[0.0], recall])
    return float(np.sum((r[1:] - r[:-1]) * precision))


# ------------------------------------------------------------ greedy matcher

def _class_matches(dets, gt_map, ious_fn):
    """Per-detection GT IoU rows, threshold-independent: for each
    (score, key, payload) in `dets` (sorted by descending score), the IoU
    vector against `gt_map[key]`. Shared by the frame and video matchers
    (and reused across thresholds by `video_map_range`)."""
    return [(key, ious_fn(payload, gt_map.get(key, [])))
            for _score, key, payload in dets]


def _greedy_tp(matches, gt_map, iou_threshold):
    """Official VOC/AVA consumption rule: each detection (descending
    score) matches its SINGLE best-IoU GT; if that best GT is already
    claimed the detection is an FP — no reassignment to the second-best.
    (The lenient best-UNUSED-GT variant systematically inflates TP counts
    vs the official evaluators; fixed round 3.)"""
    used = {k: np.zeros(len(v), bool) for k, v in gt_map.items()}
    tp = np.zeros(len(matches), bool)
    for i, (key, ious) in enumerate(matches):
        if ious.size == 0:
            continue
        j = int(np.argmax(ious))
        if ious[j] >= iou_threshold and not used[key][j]:
            tp[i] = True
            used[key][j] = True
    return tp


def _frame_ious(box, gts):
    return _iou_1vsN(box, np.stack(gts)) if len(gts) else np.zeros(0, np.float32)


def _greedy_tp_frames_vec(det_fids, det_boxes, gt_fids, gt_boxes,
                          iou_threshold):
    """Vectorized frame matcher — EXACTLY `_greedy_tp` over
    `_class_matches(..., _frame_ious)`, restated without the per-detection
    Python loop (at reference scale — 3,207 videos — the loop walks
    millions of rows per class; measured dominant in the full-scale
    rehearsal, scripts/rehearse_fullscale.py).

    Arguments are one class's detections SORTED BY DESCENDING SCORE
    (`det_fids` int frame ids, `det_boxes` [N,4]) and its GT (`gt_fids`
    int frame ids, `gt_boxes` [M,4]). The official rule decomposes:

      * each detection's best GT = argmax IoU among ITS frame's GT
        (same argmax tie-break as np.argmax in the loop: first max wins,
        GT order preserved);
      * a detection is TP iff best IoU >= threshold AND it is the FIRST
        (highest-scored) eligible detection claiming that GT — a later
        claim of a taken GT is an FP with no reassignment, so TP =
        first occurrence of each claimed GT id among eligible rows
        (np.unique(return_index=True) returns exactly those).
    """
    N, M = len(det_fids), len(gt_fids)
    tp = np.zeros(N, bool)
    if N == 0 or M == 0:
        return tp
    # group GT by frame: pad each frame's GT list to the max count
    order = np.argsort(gt_fids, kind="stable")     # keep per-frame GT order
    gt_fids_s, gt_boxes_s = gt_fids[order], gt_boxes[order]
    uniq_f, starts, counts = np.unique(gt_fids_s, return_index=True,
                                       return_counts=True)
    G = int(counts.max())
    F = len(uniq_f)
    slot = np.arange(len(gt_fids_s)) - np.repeat(starts, counts)  # 0..cnt-1
    frame_row = np.repeat(np.arange(F), counts)
    padded = np.zeros((F + 1, G, 4), np.float32)   # row F = "no GT" sentinel
    valid = np.zeros((F + 1, G), bool)
    padded[frame_row, slot] = gt_boxes_s
    valid[frame_row, slot] = True
    # map detection frames into GT frame rows (missing frame -> sentinel)
    pos = np.searchsorted(uniq_f, det_fids)
    pos_c = np.minimum(pos, F - 1)
    det_rows = np.where(uniq_f[pos_c] == det_fids, pos_c, F)

    g = padded[det_rows]                            # [N, G, 4]
    b = det_boxes[:, None]                          # [N, 1, 4]
    x1 = np.maximum(b[..., 0], g[..., 0])
    y1 = np.maximum(b[..., 1], g[..., 1])
    x2 = np.minimum(b[..., 2], g[..., 2])
    y2 = np.minimum(b[..., 3], g[..., 3])
    inter = np.maximum(x2 - x1, 0) * np.maximum(y2 - y1, 0)
    area_d = ((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]))
    area_g = ((g[..., 2] - g[..., 0]) * (g[..., 3] - g[..., 1]))
    iou = inter / np.maximum(area_d + area_g - inter, 1e-8)
    iou = np.where(valid[det_rows], iou, -1.0)      # pad slots never win

    j = np.argmax(iou, axis=1)                      # loop's int(np.argmax)
    best = iou[np.arange(N), j]
    eligible = best >= iou_threshold
    idx = np.flatnonzero(eligible)
    if idx.size:
        gids = det_rows[idx].astype(np.int64) * G + j[idx]
        _, first = np.unique(gids, return_index=True)
        tp[idx[first]] = True
    return tp


def _tube_ious(tube, gts):
    return np.asarray([spatio_temporal_iou(tube, g) for g in gts], np.float32)


# ---------------------------------------------------------------- frame mAP

def match_detections(
    detections: Sequence[Tuple],   # (frame_key, class_id, score, box[4])
    groundtruth: Sequence[Tuple],  # (frame_key, class_id, box[4])
    num_classes: int,
    iou_threshold: float = 0.5,
) -> Dict:
    """Greedy per-class detection↔GT matching (the VOC protocol core).

    Returns {cls: (scores [N], tp [N] bool)} plus the per-class GT counts —
    shared by `frame_map` (AP) and the per-class score calibration fitter
    (eval/calibration.py), so both label TPs identically.
    """
    gt_count = np.zeros(num_classes, np.int64)
    if detections:
        # columnarize ONCE (one C-level pass); frame keys intern to ints so
        # the per-class matcher is pure vectorized numpy — the former
        # per-detection Python path walked millions of rows at reference
        # scale (3,207 videos; see scripts/rehearse_fullscale.py)
        d_fkey, d_cls, d_score, d_box = zip(*detections)
        fid_of: dict = {}
        d_fid = np.fromiter((fid_of.setdefault(k, len(fid_of))
                             for k in d_fkey), np.int64, len(d_fkey))
        d_cls = np.fromiter(d_cls, np.int64, len(detections))
        # f64 for the SORT (the former sorted() compared python floats);
        # the returned score arrays stay f32 like before
        d_score = np.fromiter(d_score, np.float64, len(detections))
        d_box = np.asarray(d_box, np.float32)
    else:
        fid_of = {}
        d_fid = d_cls = np.zeros(0, np.int64)
        d_score = np.zeros(0, np.float64)
        d_box = np.zeros((0, 4), np.float32)
    g_fid_l, g_cls_l, g_box_l = [], [], []
    for frame_key, cls, box in groundtruth:
        gt_count[cls] += 1
        g_fid_l.append(fid_of.setdefault(frame_key, len(fid_of)))
        g_cls_l.append(cls)
        g_box_l.append(box)
    g_fid = np.asarray(g_fid_l, np.int64)
    g_cls = np.asarray(g_cls_l, np.int64)
    g_box = (np.asarray(g_box_l, np.float32) if g_box_l
             else np.zeros((0, 4), np.float32))

    matched = {}
    for cls in range(num_classes):
        dm = d_cls == cls
        # descending score; stable so equal scores keep input order (the
        # former sorted(key=-score) behavior)
        order = np.argsort(-d_score[dm], kind="stable")
        scores = d_score[dm][order].astype(np.float32)
        gm = g_cls == cls
        tp = _greedy_tp_frames_vec(d_fid[dm][order], d_box[dm][order],
                                   g_fid[gm], g_box[gm], iou_threshold)
        matched[cls] = (scores, tp)
    return {"matched": matched, "num_gt": gt_count}


def frame_map(
    detections: Sequence[Tuple],   # (frame_key, class_id, score, box[4])
    groundtruth: Sequence[Tuple],  # (frame_key, class_id, box[4])
    num_classes: int,
    iou_threshold: float = 0.5,
) -> Dict:
    """Frame-level mean AP. Returns {'mAP', 'ap_per_class', 'num_gt'}."""
    m = match_detections(detections, groundtruth, num_classes, iou_threshold)
    gt_count = m["num_gt"]
    ap = np.full(num_classes, np.nan, np.float64)
    for cls in range(num_classes):
        scores, tp = m["matched"][cls]
        ap[cls] = average_precision(scores, tp, int(gt_count[cls]))

    valid = ~np.isnan(ap)
    return {
        "mAP": float(np.mean(ap[valid])) if valid.any() else 0.0,
        "ap_per_class": ap,
        "num_gt": gt_count,
    }


# ---------------------------------------------------------------- video mAP

def spatio_temporal_iou(
    tube_a: Dict[int, Box], tube_b: Dict[int, Box]
) -> float:
    """UCF101-24 tube IoU: temporal IoU x mean spatial IoU on shared frames."""
    frames_a, frames_b = set(tube_a), set(tube_b)
    inter_frames = frames_a & frames_b
    union_frames = frames_a | frames_b
    if not inter_frames:
        return 0.0
    t_iou = len(inter_frames) / len(union_frames)
    # one vectorized IoU over the intersection frames (the per-frame
    # _iou_1vsN loop cost ~0.3 ms/pair at 125-frame tubes — this runs per
    # (pred, GT) tube pair at dataset scale)
    fs = sorted(inter_frames)
    # np.stack of per-frame np.asarray, NOT np.asarray(list, float32): the
    # per-pair loop this replaces computed each frame's IoU in the boxes'
    # OWN dtype — forcing f32 here would silently downcast f64 tubes and
    # drift s_iou by ~1e-7, enough to flip a >=threshold video-mAP match
    # (bit-for-bit fuzz test: tests/test_eval.py)
    a = np.stack([np.asarray(tube_a[f]) for f in fs])
    bb = np.stack([np.asarray(tube_b[f]) for f in fs])
    lt = np.maximum(a[:, :2], bb[:, :2])
    rb = np.minimum(a[:, 2:], bb[:, 2:])
    inter = np.prod(np.maximum(rb - lt, 0), axis=1)
    area_a = np.prod(a[:, 2:] - a[:, :2], axis=1)
    area_b = np.prod(bb[:, 2:] - bb[:, :2], axis=1)
    # f64 mean: the former np.mean over a python-float list accumulated in
    # f64; np.mean on the f32 array would accumulate in f32
    s_iou = float(np.mean(inter / np.maximum(area_a + area_b - inter, 1e-8),
                          dtype=np.float64))
    return float(t_iou * s_iou)


def _video_prep(pred_tubes, gt_tubes, num_classes):
    """Per-class (scores, matches, gt_map) with tube IoUs computed ONCE —
    the IoU rows are threshold-independent, so the 0.5:0.95 sweep reuses
    them instead of recomputing every spatio_temporal_iou 10x."""
    gt_by_cv = defaultdict(list)
    gt_count = np.zeros(num_classes, np.int64)
    for vid, cls, tube in gt_tubes:
        gt_by_cv[(cls, vid)].append(tube)
        gt_count[cls] += 1

    det_by_class = defaultdict(list)
    for vid, cls, score, tube in pred_tubes:
        det_by_class[cls].append((float(score), vid, tube))

    per_class = []
    for cls in range(num_classes):
        dets = [(s, (cls, vid), tube)
                for s, vid, tube in sorted(det_by_class[cls],
                                           key=lambda d: -d[0])]
        gt_map = {k: v for k, v in gt_by_cv.items() if k[0] == cls}
        scores = np.asarray([d[0] for d in dets], np.float32)
        per_class.append(
            (scores, _class_matches(dets, gt_map, _tube_ious), gt_map))
    return per_class, gt_count


def _video_map_at(per_class, gt_count, num_classes, iou_threshold) -> Dict:
    ap = np.full(num_classes, np.nan, np.float64)
    for cls, (scores, matches, gt_map) in enumerate(per_class):
        tp = _greedy_tp(matches, gt_map, iou_threshold)
        ap[cls] = average_precision(scores, tp, int(gt_count[cls]))
    valid = ~np.isnan(ap)
    return {
        "mAP": float(np.mean(ap[valid])) if valid.any() else 0.0,
        "ap_per_class": ap,
        "num_gt": gt_count,
    }


def video_map(
    pred_tubes: Sequence[Tuple],  # (video_id, class_id, score, {frame: box})
    gt_tubes: Sequence[Tuple],    # (video_id, class_id, {frame: box})
    num_classes: int,
    iou_threshold: float = 0.5,
) -> Dict:
    """Video-level tube mAP at a spatio-temporal IoU threshold."""
    per_class, gt_count = _video_prep(pred_tubes, gt_tubes, num_classes)
    return _video_map_at(per_class, gt_count, num_classes, iou_threshold)


def video_map_range(
    pred_tubes, gt_tubes, num_classes,
    thresholds=tuple(np.arange(0.5, 1.0, 0.05)),
) -> float:
    """COCO-style averaged video-mAP (the 0.5:0.95 column)."""
    per_class, gt_count = _video_prep(pred_tubes, gt_tubes, num_classes)
    vals = [_video_map_at(per_class, gt_count, num_classes, float(t))["mAP"]
            for t in thresholds]
    return float(np.mean(vals))
