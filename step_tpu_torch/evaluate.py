"""Evaluation: per-video tube collection with on-device linking.

Port of `step_tpu/evaluate.py::collect_video_tubes` (:192-425). Detection
and linking run on the model's device; collection, calibration and tube
assembly run on the host in numpy, as in the JAX package. The rest of that
module (`collect_detections`, `evaluate_ucf`, the host linker) is not
ported yet.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from step_tpu_torch.data.pipeline import rgb_to_uint8_wire
from step_tpu_torch.eval.calibration import calibrate_scores_array
from step_tpu_torch.inference import detect_clip, link_video
from step_tpu_torch.models.detector import STEPDetector


def collect_video_tubes(model, dataset, max_videos: Optional[int] = None,
                        image_scale_to_gt: bool = True, clip_batch: int = 16,
                        min_length: int = 2, variables_flow=None, mesh=None,
                        calibration=None):
    """Per-video tubes linked on the device → `[(video, cls, score,
    {frame: box})]`.

    Per video of `dataset` (its `.samples` are `(video, window)` pairs, its
    items sliding windows one chunk apart): detect all clips with `model`
    in batches of `clip_batch` (the last padded by repeating its last
    clip), then link the per-clip tubes into K tubes per class
    (`inference.link_video`, `stride=frames_per_chunk`: the transition
    IoU compares the temporally aligned boxes of the window overlap). The
    clip axis is padded to the next power of two and the padding masked
    (`clip_mask`), so a few shapes cover a dataset.

    Each clip contributes the frames of its own central chunk to a tube;
    the first and last clips also contribute the video-boundary frames no
    clip owns. A tube needs `min_length` frames and a score of at least
    `cfg.score_thresh`. `calibration`: `{'a': [C], 'b': [C]}` (or an .npz
    path), per-class Platt scaling of the tube scores before linking.
    Boxes are scaled to the dataset's `resolution` when it has one and
    `image_scale_to_gt` is set.

    `variables_flow` (late fusion, ROADMAP M10) and `mesh` (data-parallel
    evaluation, M9) are not ported yet and raise.
    """
    cfg = model.cfg
    if cfg.temporal_stride != 1:
        # Ownership and transition alignment are computed in per-frame
        # units with one-chunk clip tiling.
        raise ValueError(
            "collect_video_tubes' clip-tiling protocol requires "
            f"temporal_stride == 1; got {cfg.temporal_stride}")
    if variables_flow is not None:
        raise NotImplementedError("late fusion (variables_flow) is not ported yet: "
                                  "ROADMAP M10")
    if mesh is not None:
        raise NotImplementedError("data-parallel evaluation (mesh) is not ported "
                                  "yet: ROADMAP M9")
    if calibration is not None:
        if isinstance(calibration, str):
            calibration = dict(np.load(calibration))
        calib_a = np.asarray(calibration["a"], np.float32)
        calib_b = np.asarray(calibration["b"], np.float32)
    device = next(model.parameters()).device

    by_video: dict = {}
    for i, (v, _center) in enumerate(dataset.samples):
        by_video.setdefault(v, []).append(i)

    props, pmask = STEPDetector.initial_proposals(cfg, clip_batch, device=device)

    def wire(batch: np.ndarray) -> torch.Tensor:
        if cfg.uint8_transfer and np.issubdtype(batch.dtype, np.floating):
            batch = rgb_to_uint8_wire(batch)
        return torch.from_numpy(batch).to(device)

    pool = ThreadPoolExecutor(2)   # decode the next items while the card runs
    T, fpc = cfg.total_frames, cfg.frames_per_chunk
    tc0 = (T - fpc) // 2                       # central-chunk start position
    out = []
    try:
        for vi, (video, idxs) in enumerate(by_video.items()):
            if max_videos is not None and vi >= max_videos:
                break
            L = len(idxs)
            clips, frame_ids = [], []
            for item in pool.map(dataset.__getitem__, idxs):
                clips.append(item["rgb"])
                frame_ids.append(np.asarray(item["frame_indices"]))
            tubes_np, scores_np = [], []
            for s in range(0, L, clip_batch):
                chunk = clips[s:s + clip_batch]
                batch = np.stack(chunk + [chunk[-1]] * (clip_batch - len(chunk)))
                det = detect_clip(model, wire(batch), props, pmask)
                tubes_np.append(det["tubes"][:len(chunk)].cpu().numpy())
                scores_np.append(det["tube_scores"][:len(chunk)].cpu().numpy())
            tubes = np.concatenate(tubes_np, axis=0)      # [L, P, T, 4]
            scores = np.concatenate(scores_np, axis=0)    # [L, P, C]
            if calibration is not None:
                scores = calibrate_scores_array(scores, calib_a, calib_b)

            Lb = 1 << (L - 1).bit_length()           # the next power of two
            if Lb > L:
                tubes = np.concatenate([tubes, np.repeat(tubes[-1:], Lb - L, axis=0)])
                scores = np.concatenate([scores, np.repeat(scores[-1:], Lb - L, axis=0)])
            clip_mask = np.zeros((Lb,), np.float32)
            clip_mask[:L] = 1.0
            link = link_video(
                torch.from_numpy(tubes).to(device), torch.from_numpy(scores).to(device),
                pmask[:1].expand(Lb, pmask.shape[1]), cfg,
                torch.from_numpy(clip_mask).to(device),
                # one chunk in tube slots, which are video frames because
                # temporal_stride is 1 (checked above)
                stride=fpc)
            paths = link["paths"].cpu().numpy()              # [C, K, Lb]
            trim = link["trim"].cpu().numpy()                # [C, K, Lb]
            tube_scores = link["tube_scores"].cpu().numpy()  # [C, K]

            sx = sy = 1.0
            if image_scale_to_gt and hasattr(dataset, "resolution"):
                H, W = dataset.resolution.get(video, (cfg.image_size, cfg.image_size))
                sx, sy = W / cfg.image_size, H / cfg.image_size
            scale = np.asarray([sx, sy, sx, sy], np.float32)

            C, K = tube_scores.shape
            for c in range(C):
                for k in range(K):
                    if tube_scores[c, k] < cfg.score_thresh:
                        continue
                    frames = {}
                    for l in range(L):
                        if trim[c, k, l] <= 0:
                            continue
                        p = paths[c, k, l]
                        t_lo = 0 if l == 0 else tc0
                        t_hi = T if l == L - 1 else tc0 + fpc
                        for t in range(t_lo, t_hi):
                            f = int(frame_ids[l][t]) + 1   # 1-based, as the GT
                            if f not in frames:
                                frames[f] = tubes[l, p, t] * scale
                    if len(frames) >= min_length:
                        out.append((video, c, float(tube_scores[c, k]), frames))
    finally:
        pool.shutdown(wait=False)
    return out
