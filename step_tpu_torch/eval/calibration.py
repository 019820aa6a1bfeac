"""Per-class score calibration (Platt scaling).

A copy of `step_tpu/eval/calibration.py` (numpy only), held equal to it by
`tests/test_torch_port_video.py`.

Reference parity: none — the reference dumps raw softmax/sigmoid scores.
This is the production add-on the round-2 roadmap called for: per-class
monotone calibration fitted on a validation split, so confidences are
comparable ACROSS classes and across the RGB/flow streams.

Why it matters here: per-class AP is invariant to any monotone per-class
transform, but everything that compares scores across classes or streams
is not — the detection dump consumed downstream, late two-stream fusion
(a class whose RGB scores saturate near 1 otherwise drowns the flow
stream), tube linking (score + IoU edge weights), and any global
score_thresh. Platt scaling fits P(TP | score) = sigmoid(a*s + b) per
class by Newton-IRLS on the same greedy VOC matching the evaluator uses
(eval/detection_metrics.py::match_detections), so "0.7" means the same
thing for every class.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from step_tpu_torch.eval.detection_metrics import match_detections


def _fit_platt_1d(scores: np.ndarray, tp: np.ndarray,
                  iters: int = 50, l2: float = 1e-6) -> Tuple[float, float]:
    """Logistic fit of tp ~ sigmoid(a*s + b) by Newton-IRLS.

    Uses Platt's label smoothing (targets (n+ + 1)/(n+ + 2), 1/(n- + 2))
    so degenerate all-TP / all-FP classes stay finite.
    """
    n = len(scores)
    if n == 0:
        return 1.0, 0.0
    n_pos = float(tp.sum())
    n_neg = float(n - n_pos)
    t_pos = (n_pos + 1.0) / (n_pos + 2.0)
    t_neg = 1.0 / (n_neg + 2.0)
    t = np.where(tp, t_pos, t_neg)
    a, b = 1.0, 0.0
    s = scores.astype(np.float64)
    for _ in range(iters):
        z = np.clip(a * s + b, -30.0, 30.0)
        p = 1.0 / (1.0 + np.exp(-z))
        g = p - t                                   # dNLL/dz
        w = np.maximum(p * (1.0 - p), 1e-8)         # d2NLL/dz2
        ga = np.sum(g * s) + l2 * a
        gb = np.sum(g)
        haa = np.sum(w * s * s) + l2
        hab = np.sum(w * s)
        hbb = np.sum(w) + l2
        det = haa * hbb - hab * hab
        if abs(det) < 1e-12:
            break
        da = (hbb * ga - hab * gb) / det
        db = (haa * gb - hab * ga) / det
        a, b = a - da, b - db
        if abs(da) + abs(db) < 1e-10:
            break
    return float(a), float(b)


def fit_calibration(
    detections: Sequence[Tuple],   # (frame_key, cls, score, box)
    groundtruth: Sequence[Tuple],  # (frame_key, cls, box)
    num_classes: int,
    iou_threshold: float = 0.5,
) -> Dict[str, np.ndarray]:
    """Fit per-class Platt parameters on validation detections.

    Classes with no detections keep the identity-ish default (a=1, b=0).
    Returns {'a': [C], 'b': [C]} — save with np.savez / pass to
    `apply_calibration`.
    """
    m = match_detections(detections, groundtruth, num_classes, iou_threshold)
    a = np.ones(num_classes, np.float64)
    b = np.zeros(num_classes, np.float64)
    for cls in range(num_classes):
        scores, tp = m["matched"][cls]
        if len(scores):
            a[cls], b[cls] = _fit_platt_1d(scores, tp)
            if a[cls] <= 0.0:
                # A non-positive slope (scores anti-correlate with
                # correctness on a small validation sample) would INVERT the
                # class's ranking and change its AP — calibration must never
                # do that. Fall back to identity and flag it.
                import warnings

                warnings.warn(
                    f"calibration: class {cls} fitted a non-positive Platt "
                    f"slope ({a[cls]:.4f}); falling back to identity so the "
                    "per-class ranking is preserved"
                )
                a[cls], b[cls] = 1.0, 0.0
    return {"a": a, "b": b}


def calibrate_scores_array(scores: np.ndarray, a, b) -> np.ndarray:
    """Vectorized Platt transform — the ONE owner of the formula.

    `a`/`b` broadcast against the trailing class axis of `scores` (e.g.
    [L, P, C] tube-score surfaces in evaluate.collect_video_tubes, or the
    scalar per-class values of `calibrate_score`). The ±30 clip bound is
    part of the transform: both surfaces must saturate identically or the
    linking edge weights and the detection scores drift apart.
    """
    z = np.clip(scores * a + b, -30.0, 30.0)
    return 1.0 / (1.0 + np.exp(-z))


def calibrate_score(score, cls, calib) -> float:
    return float(calibrate_scores_array(score, calib["a"][cls],
                                        calib["b"][cls]))


def apply_calibration(detections: Sequence[Tuple], calib) -> list:
    """Map raw detection scores through the fitted per-class sigmoid.

    Platt's `a` is positive for any class where score correlates with
    correctness, so the per-class ranking (and per-class AP) is unchanged;
    only cross-class comparability improves.
    """
    return [
        (fkey, cls, calibrate_score(score, cls, calib), box)
        for fkey, cls, score, box in detections
    ]
