"""Visualization: draw detections on frames, write annotated videos.

A copy of `step_tpu/utils/vis.py` (the drawing half of the reference's
`demo.py`), held equal to it by `tests/test_torch_port_serve.py`; cv2 is
imported where a frame is drawn, written or read.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

_COLORS = [
    (230, 25, 75), (60, 180, 75), (0, 130, 200), (245, 130, 48),
    (145, 30, 180), (70, 240, 240), (240, 50, 230), (210, 245, 60),
    (250, 190, 190), (0, 128, 128), (170, 110, 40), (128, 0, 0),
]


def draw_detections(
    frame: np.ndarray,                 # [H, W, 3] uint8 or float [0,1]
    boxes: np.ndarray,                 # [K, 4]
    labels: Sequence[int],
    scores: Sequence[float],
    class_names: Optional[Sequence[str]] = None,
    score_thresh: float = 0.0,
) -> np.ndarray:
    """Draw boxes + 'class: score' tags; returns a uint8 copy."""
    import cv2

    img = frame
    if img.dtype != np.uint8:
        img = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    img = np.ascontiguousarray(img.copy())
    for box, label, score in zip(boxes, labels, scores):
        if score < score_thresh:
            continue
        color = _COLORS[int(label) % len(_COLORS)]
        x1, y1, x2, y2 = [int(round(float(v))) for v in box]
        cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
        name = class_names[int(label)] if class_names else str(int(label))
        tag = f"{name}: {score:.2f}"
        (tw, th), _ = cv2.getTextSize(tag, cv2.FONT_HERSHEY_SIMPLEX, 0.5, 1)
        cv2.rectangle(img, (x1, max(y1 - th - 6, 0)), (x1 + tw + 2, y1), color, -1)
        cv2.putText(img, tag, (x1 + 1, max(y1 - 4, th)), cv2.FONT_HERSHEY_SIMPLEX,
                    0.5, (255, 255, 255), 1, cv2.LINE_AA)
    return img


def write_video(path: str, frames: Sequence[np.ndarray], fps: int = 25):
    """Write frames ([H,W,3] uint8 RGB) to a video file (cv2 mp4v — the
    image's imageio install has no ffmpeg plugin)."""
    import cv2

    first = frames[0]
    H, W = first.shape[:2]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    if not writer.isOpened():
        raise IOError(f"could not open video writer for {path}")
    try:
        for f in frames:
            if f.dtype != np.uint8:
                f = (np.clip(f, 0, 1) * 255).astype(np.uint8)
            writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    finally:
        writer.release()


def extract_frames(video_path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """video file → [T, H, W, 3] float32 in [0,1] (demo.py's ffmpeg step)."""
    import cv2

    cap = cv2.VideoCapture(video_path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0)
        if max_frames and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {video_path}")
    return np.stack(frames)
