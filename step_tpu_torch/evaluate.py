"""Evaluation: detections over a dataset, frame-mAP and video-mAP over
linked tubes, the detections dump.

Port of `step_tpu/evaluate.py`: `collect_detections` (:29-189),
`collect_video_tubes` (:192-425), `dedupe_frame_detections` (:428-462),
`link_frame_detections` (:465-527), `tube_nms` (:530-564), `evaluate_ucf`
(:567-704) and `evaluate_ava` (:707-782). Detection and device linking
run on the model's device; collection, dedupe, host linking and the mAPs
run on the host in numpy, as in the JAX package. Each function takes the
port's model where the JAX one takes variables; its config is
`model.cfg`. Late fusion takes a second, flow-stream model, `model_flow`,
where the JAX package takes `variables_flow`; a two-stream or flow-stream
model reads the dataset's flow itself. With a `mesh`
(`parallel.create_mesh`) every rank runs the same evaluation: each
detection batch, padded to a multiple of the mesh's size, is split over
the ranks (`inference.make_parallel_detect_fn`) and the detections
gathered to every rank, where the padded rows are dropped; linking and
scoring run on each rank, so every rank returns the unsharded result.
"""

from __future__ import annotations

import pickle
import resource
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from step_tpu_torch.data.loader import DataLoader
from step_tpu_torch.data.pipeline import flow_to_int8_wire, rgb_to_uint8_wire
from step_tpu_torch.eval.ava_eval import ava_frame_map
from step_tpu_torch.eval.calibration import (apply_calibration, calibrate_scores_array,
                                             fit_calibration)
from step_tpu_torch.eval.detection_metrics import (_iou_1vsN, frame_map,
                                                   spatio_temporal_iou, video_map,
                                                   video_map_range)
from step_tpu_torch.inference import (FLOW_DATASET_ERROR, detect_clip,
                                      detect_clip_late_fusion, eval_needs_flow,
                                      link_video, make_parallel_detect_fn,
                                      make_parallel_late_fusion_detect_fn, pad_batch_to)
from step_tpu_torch.models.detector import STEPDetector


def _scale_to_gt(dataset, video, cfg, image_scale_to_gt: bool) -> np.ndarray:
    """[sx, sy, sx, sy] from the model's pixels to the dataset's native
    resolution of `video` (ones without one, or when not asked)."""
    sx = sy = 1.0
    if image_scale_to_gt and hasattr(dataset, "resolution"):
        H, W = dataset.resolution.get(video, (cfg.image_size, cfg.image_size))
        sx, sy = W / cfg.image_size, H / cfg.image_size
    return np.asarray([sx, sy, sx, sy], np.float32)


def _detector(model, model_flow, mesh):
    """(detect, shards): `detect(rgb, proposals, prop_mask, flow)` runs one
    detection batch as the collectors run it, late fusion with
    `model_flow`, else `model` on its primary input (a flow-stream
    detector's is the flow) and, with two stems, the flow beside it; with
    a `mesh`, split over its ranks (the batch a multiple of `shards`)."""
    cfg = model.cfg
    single, fuse, shards = detect_clip, detect_clip_late_fusion, 1
    if mesh is not None:
        single, fuse = (make_parallel_detect_fn(cfg, mesh),
                        make_parallel_late_fusion_detect_fn(cfg, mesh))
        shards = mesh.size()

    def detect(rgb, proposals, prop_mask, flow):
        if model_flow is not None:
            return fuse(model, model_flow, rgb, flow, proposals, prop_mask)
        if cfg.input_stream == "flow":
            rgb, flow = flow, None
        return single(model, rgb, proposals, prop_mask, flow)

    return detect, shards


def collect_detections(model, dataset, batch_size: int = 8,
                       max_batches: Optional[int] = None,
                       image_scale_to_gt: bool = True, mesh=None, model_flow=None,
                       coverage: Optional[dict] = None):
    """Detect over `dataset` with `model` → `[(frame_key, cls, score, box)]`.

    The dataset's items are sliding windows (`frame_indices`, one chunk
    apart) or keyframe clips (`timestamp`); frame_key is `(video, frame)`
    with 1-based frames, or `(video, timestamp)`. Batches come from the
    port's `DataLoader` in dataset order (`train=False`, the last batch
    short), `max_batches` of them at most; boxes scale to the dataset's
    `resolution` where it has one and `image_scale_to_gt` is set.

    A frame belongs to the window whose central chunk covers it; only its
    owner's detections are kept, since the other windows' copies of an
    actor are sure false positives. Frames no central chunk covers (the
    clamped video edges) keep every window's detections. `coverage`, where
    given, is filled with what was evaluated: "fkeys" (the frame keys of
    every window seen) and "videos" (the videos with a window seen), so a
    truncated run can be scored against what it saw (`evaluate_ucf`).

    `model_flow`, a flow-stream detector, runs the late-fusion protocol
    (`detect_clip_late_fusion`, `model` the RGB stream). It, a two-stream
    and a flow-stream `model` need a dataset built with flow. `mesh`
    splits each batch over its ranks (`inference.make_parallel_detect_fn`):
    a short last batch is padded to a multiple of the mesh's size and the
    padded rows are dropped here.
    """
    cfg = model.cfg
    if cfg.temporal_stride != 1:
        # Ownership assumes windows that sample every frame and tile by one
        # chunk; with a temporal stride the central chunks overlap in video
        # time and misaligned duplicates would survive.
        raise ValueError(
            "collect_detections' sliding-window ownership protocol "
            f"requires temporal_stride == 1; got {cfg.temporal_stride}")
    device = next(model.parameters()).device
    loader = DataLoader(dataset, cfg, batch_size=batch_size, shuffle=False,
                        train=False, drop_last=False, num_workers=2)
    need_flow = eval_needs_flow(cfg, model_flow)
    detect, shards = _detector(model, model_flow, mesh)

    det_list, det_central, owned_fkeys = [], [], set()
    fpc = cfg.frames_per_chunk
    tc0 = (cfg.total_frames - fpc) // 2        # central-chunk start position
    for bi, batch in enumerate(loader.epoch(0)):
        if max_batches is not None and bi >= max_batches:
            break
        flow = batch.get("flow") if need_flow else None
        if need_flow and flow is None:
            raise ValueError(FLOW_DATASET_ERROR)
        out = detect(*(None if v is None else torch.from_numpy(pad_batch_to(v, shards))
                       .to(device)
                       for v in (batch["rgb"], batch["proposals"], batch["prop_mask"],
                                 flow)))
        boxes = out["frame_boxes"].float().cpu().numpy()     # [B, T, C, K, 4]
        scores = out["frame_scores"].float().cpu().numpy()   # [B, T, C, K]
        mask = out["frame_mask"].cpu().numpy()
        for b, meta in enumerate(batch["meta"]):
            video = meta.get("video")
            frame_idx = meta.get("frame_indices")
            if coverage is not None:
                coverage.setdefault("videos", set()).add(video)
                fk = coverage.setdefault("fkeys", set())
                if frame_idx is not None:
                    for f in frame_idx:
                        fk.add((video, int(f) + 1))
                else:
                    fk.add((video, meta.get("timestamp")))
            scale = _scale_to_gt(dataset, video, cfg, image_scale_to_gt)
            keep = np.argwhere((mask[b] > 0) & (scores[b] > cfg.score_thresh))
            if frame_idx is not None:
                # Geometric ownership: every frame of the central chunk is
                # owned, detections there or not. Keyed on emitted
                # detections, both neighbours' copies would survive exactly
                # where the owner is silent.
                for t in range(tc0, tc0 + fpc):
                    owned_fkeys.add((video, int(frame_idx[t]) + 1))
            if keep.size == 0:
                continue
            ts, cs, ks = keep[:, 0], keep[:, 1], keep[:, 2]
            sc = scores[b, ts, cs, ks].tolist()
            bx = boxes[b, ts, cs, ks] * scale          # [n, 4]
            if frame_idx is not None:
                fis = (np.asarray(frame_idx)[ts] + 1).tolist()  # 1-based
                fkeys = [(video, f) for f in fis]
                central = ((ts >= tc0) & (ts < tc0 + fpc)).tolist()
            else:
                stamp = meta.get("timestamp")
                fkeys = [(video, stamp if stamp is not None else t) for t in ts.tolist()]
                central = [True] * len(fkeys)
            det_list.extend(zip(fkeys, cs.tolist(), sc, bx))
            det_central.extend(central)
    return [d for d, central in zip(det_list, det_central)
            if central or d[0] not in owned_fkeys]


def collect_video_tubes(model, dataset, max_videos: Optional[int] = None,
                        image_scale_to_gt: bool = True, clip_batch: int = 16,
                        min_length: int = 2, model_flow=None, mesh=None,
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
    `image_scale_to_gt` is set. `model_flow`: late fusion on the tube
    surface, as in `collect_detections` (scores fused before linking,
    boxes from the RGB stream). `mesh` splits each clip batch over its
    ranks (`clip_batch` rounds up to a multiple of the mesh's size); the
    linking runs on each rank's device.
    """
    cfg = model.cfg
    if cfg.temporal_stride != 1:
        # Ownership and transition alignment are computed in per-frame
        # units with one-chunk clip tiling.
        raise ValueError(
            "collect_video_tubes' clip-tiling protocol requires "
            f"temporal_stride == 1; got {cfg.temporal_stride}")
    need_flow = eval_needs_flow(cfg, model_flow)
    detect, shards = _detector(model, model_flow, mesh)
    clip_batch = -(-clip_batch // shards) * shards
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
        """The loader's wire format: uint8 RGB, int8 flow."""
        if cfg.uint8_transfer and np.issubdtype(batch.dtype, np.floating):
            batch = (rgb_to_uint8_wire(batch) if batch.shape[-1] == 3
                     else flow_to_int8_wire(batch))
        return torch.from_numpy(batch).to(device)

    def padded(items: list, s: int) -> np.ndarray:
        chunk = items[s:s + clip_batch]
        return np.stack(chunk + [chunk[-1]] * (clip_batch - len(chunk)))

    pool = ThreadPoolExecutor(2)   # decode the next items while the card runs
    T, fpc = cfg.total_frames, cfg.frames_per_chunk
    tc0 = (T - fpc) // 2                       # central-chunk start position
    out = []
    try:
        for vi, (video, idxs) in enumerate(by_video.items()):
            if max_videos is not None and vi >= max_videos:
                break
            L = len(idxs)
            clips, flows, frame_ids = [], [], []
            for item in pool.map(dataset.__getitem__, idxs):
                clips.append(item["rgb"])
                frame_ids.append(np.asarray(item["frame_indices"]))
                if need_flow:
                    if item.get("flow") is None:
                        raise ValueError(FLOW_DATASET_ERROR)
                    flows.append(item["flow"])
            tubes_np, scores_np = [], []
            for s in range(0, L, clip_batch):
                n = min(clip_batch, L - s)
                det = detect(wire(padded(clips, s)), props, pmask,
                             wire(padded(flows, s)) if flows else None)
                tubes_np.append(det["tubes"][:n].cpu().numpy())
                scores_np.append(det["tube_scores"][:n].cpu().numpy())
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

            scale = _scale_to_gt(dataset, video, cfg, image_scale_to_gt)

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


def dedupe_frame_detections(detections):
    """Keep one detection per (frame key, class, box rounded to 0.1 px):
    the highest-scored, the earliest on ties, in first-occurrence order.

    The vectorized form of `step_tpu/evaluate.py:428-462`: a lexsort by
    group, then score descending (stable, so the earliest index wins a
    tie), the first row of each group, reordered by each group's first
    index."""
    n = len(detections)
    if n < 2:
        return list(detections)
    fkey_col, cls_col, score_col, box_col = zip(*detections)
    fid_of: dict = {}
    fid = np.fromiter((fid_of.setdefault(k, len(fid_of)) for k in fkey_col), np.int64, n)
    cls = np.fromiter(cls_col, np.int64, n)
    score = np.fromiter(score_col, np.float64, n)
    # coordinates rounded to 0.1 px, as integers: distinct np.round(., 1)
    # values map to distinct integers
    coords = np.rint(np.round(np.asarray(box_col, np.float32), 1) * 10.0).astype(np.int64)
    order = np.lexsort((-score, coords[:, 3], coords[:, 2], coords[:, 1],
                        coords[:, 0], cls, fid))
    cols = np.column_stack([fid, cls, coords])[order]
    new_group = np.empty(n, bool)
    new_group[0] = True
    new_group[1:] = (cols[1:] != cols[:-1]).any(axis=1)
    starts = np.flatnonzero(new_group)
    kept = order[starts]                          # the best row of each group
    first_idx = np.minimum.reduceat(order, starts)
    kept = kept[np.argsort(first_idx, kind="stable")]
    return [detections[i] for i in kept]


def link_frame_detections(detections, link_iou: float = 0.2, max_gap: int = 3,
                          min_length: int = 2):
    """Video tubes from per-frame detections by greedy temporal linking →
    `[(video, cls, score, {frame: box})]`.

    Per (video, class), frames in order: each active tube, in the order
    the tubes started, takes the unclaimed detection of highest IoU with
    its last box if that IoU is at least `link_iou`; unclaimed detections
    start new tubes; a tube idle for more than `max_gap` frames closes. A
    tube's score is the mean of its members'; tubes of fewer than
    `min_length` frames are dropped."""
    by_vcf = defaultdict(lambda: defaultdict(list))
    for (video, frame), c, s, box in detections:
        by_vcf[(video, c)][frame].append((s, np.asarray(box, np.float32)))

    out = []
    for (video, c), frames in by_vcf.items():
        active = []  # [{'frames': {f: box}, 'scores': [..], 'last_f': f}]
        done = []
        for f in sorted(frames):
            dets = frames[f]
            still = []
            for tube in active:
                (done if f - tube["last_f"] > max_gap else still).append(tube)
            active = still
            claimed = [False] * len(dets)
            for tube in active:
                if not dets:
                    break
                last_box = tube["frames"][tube["last_f"]]
                ious = np.asarray([0.0 if claimed[i] else
                                   float(_iou_1vsN(last_box, d[1][None])[0])
                                   for i, d in enumerate(dets)])
                j = int(np.argmax(ious)) if len(ious) else -1
                if j >= 0 and ious[j] >= link_iou:
                    claimed[j] = True
                    s, box = dets[j]
                    tube["frames"][f] = box
                    tube["scores"].append(s)
                    tube["last_f"] = f
            for i, (s, box) in enumerate(dets):
                if not claimed[i]:
                    active.append({"frames": {f: box}, "scores": [s], "last_f": f})
        done.extend(active)
        for tube in done:
            if len(tube["frames"]) >= min_length:
                out.append((video, c, float(np.mean(tube["scores"])), tube["frames"]))
    return out


def tube_nms(pred_tubes, iou_thresh: float):
    """Greedy tube NMS per (video, class): keep the highest-scored tube,
    drop every later one whose spatio-temporal IoU with a kept tube is at
    least `iou_thresh`. Two parallel chains over one actor survive
    linking; this collapses them. `iou_thresh <= 0` returns `pred_tubes`
    itself. The survivors come grouped by (video, class), by descending
    score within a group."""
    if iou_thresh <= 0:
        return pred_tubes
    groups = defaultdict(list)
    for video, c, s, frames in pred_tubes:
        groups[(video, c)].append((s, frames))
    out = []
    for (video, c), tubes in groups.items():
        tubes.sort(key=lambda t: -t[0])
        kept = []
        for s, frames in tubes:
            if all(spatio_temporal_iou(frames, kf) < iou_thresh for _, kf in kept):
                kept.append((s, frames))
        out.extend((video, c, s, frames) for s, frames in kept)
    return out


def evaluate_ucf(model, dataset, dump_path: Optional[str] = None,
                 max_batches: Optional[int] = None, calibration=None,
                 fit_calibration_path: Optional[str] = None, mesh=None,
                 model_flow=None, device_linking: bool = False,
                 max_videos: Optional[int] = None) -> dict:
    """UCF101-24 evaluation of `model` on `dataset`: frame-mAP@0.5 and
    video-mAP@0.2, @0.5 and @0.5:0.95 over linked tubes.

    Detections are collected (`collect_detections`), deduplicated, and
    scored per frame. Video tubes come from the host linker
    (`link_frame_detections`) or, with `device_linking`, from the linker on
    the device (`collect_video_tubes`, a second detection pass), then
    `tube_nms` at cfg.tube_nms_thresh.

    `max_batches` bounds the detection pass; the GT is then cut to the
    frames and videos it saw, and "eval_subset" says so. `max_videos`
    bounds the device-linking pass to the first videos in dataset order
    (`max_batches` stands in for it when it is not given), and its tube GT
    is cut to those videos. `fit_calibration_path`: fit per-class Platt
    scaling on this run's detections and save it (.npz); `calibration`
    (a dict `{'a': [C], 'b': [C]}` or an .npz path) applies one to the
    scores before scoring and linking. `dump_path` pickles
    `{"detections": [...]}` in the JAX package's layout.

    The result also holds "timings": the seconds of each phase
    (`collect_s`, `dedupe_s`, `frame_map_s`, `link_s`, `video_map_s`), the
    counts `n_detections` and `n_tubes`, and the process's `peak_rss_mb`.
    `model_flow`: late fusion in both passes (`collect_detections`).
    `mesh`: both passes split their batches over its ranks.
    """
    cfg = model.cfg
    timings: dict = {}
    t0 = time.perf_counter()
    coverage = {} if max_batches is not None else None
    raw_dets = collect_detections(model, dataset, max_batches=max_batches, mesh=mesh,
                                  model_flow=model_flow, coverage=coverage)
    timings["collect_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    detections = dedupe_frame_detections(raw_dets)
    timings["dedupe_s"] = time.perf_counter() - t0
    timings["n_detections"] = len(detections)
    frame_gt, tube_gt = dataset.video_groundtruth()
    tube_gt_all = tube_gt
    if coverage is not None:
        # A truncated pass is scored against the GT it could have seen:
        # unseen GT would count as misses and cap the mAP at about the share
        # of windows seen. Frames are cut exactly, tubes to the videos
        # touched (the last may be partly seen: "eval_subset" says so).
        fkeys = coverage.get("fkeys", set())
        vids = coverage.get("videos", set())
        frame_gt = [g for g in frame_gt if g[0] in fkeys]
        tube_gt = [t for t in tube_gt if t[0] in vids]
    if fit_calibration_path:
        np.savez(fit_calibration_path, **fit_calibration(detections, frame_gt,
                                                         cfg.num_classes))
        print(f"calibration fitted -> {fit_calibration_path}")
    if calibration is not None:
        if isinstance(calibration, str):
            calibration = dict(np.load(calibration))
        detections = apply_calibration(detections, calibration)
    if dump_path:
        with open(dump_path, "wb") as f:
            pickle.dump({"detections": detections}, f)

    t0 = time.perf_counter()
    results = {"frame_mAP@0.5": frame_map(detections, frame_gt, cfg.num_classes,
                                          0.5)["mAP"]}
    timings["frame_map_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if device_linking:
        if max_videos is None and max_batches is not None:
            max_videos = max_batches
        # calibrated before linking, as the host linker links calibrated
        # detections
        pred_tubes = tube_nms(collect_video_tubes(model, dataset, max_videos=max_videos,
                                                  model_flow=model_flow, mesh=mesh,
                                                  calibration=calibration),
                              cfg.tube_nms_thresh)
        if max_videos is not None:
            # this pass saw the first max_videos videos in dataset order:
            # score against the whole of their tube GT (not cut to the
            # detection pass's coverage, which may span other videos)
            dev_vids = list(dict.fromkeys(v for v, _ in dataset.samples))[:max_videos]
            tube_gt = [t for t in tube_gt_all if t[0] in set(dev_vids)]
            results["eval_subset"] = f"{len(dev_vids)} videos"
    else:
        pred_tubes = tube_nms(link_frame_detections(detections), cfg.tube_nms_thresh)
        if coverage is not None:
            results["eval_subset"] = f"{len(coverage.get('videos', ()))} videos touched"
    timings["link_s"] = time.perf_counter() - t0
    timings["n_tubes"] = len(pred_tubes)
    t0 = time.perf_counter()
    for thresh in (0.2, 0.5):
        results[f"video_mAP@{thresh}"] = video_map(pred_tubes, tube_gt, cfg.num_classes,
                                                   thresh)["mAP"]
    results["video_mAP@0.5:0.95"] = video_map_range(pred_tubes, tube_gt, cfg.num_classes)
    timings["video_map_s"] = time.perf_counter() - t0
    timings["peak_rss_mb"] = round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                                   / 1024.0, 1)
    results["timings"] = timings
    return results


def evaluate_ava(model, dataset, dump_path: Optional[str] = None,
                 max_batches: Optional[int] = None, mesh=None) -> dict:
    """AVA evaluation of `model` on `dataset` (`data/ava.py::AVADataset`):
    frame-mAP@0.5 over keyframe detections in normalized coordinates.

    The per-class NMS runs in `detect_clip`; only its survivors at the
    keyframe, frame `total_frames // 2`, are read, boxes divided by
    `image_size`. `max_batches` bounds the pass (batches of 4), and the GT
    is then cut to the keyframes seen. `dump_path` pickles `{"detections":
    [...]}` in the JAX package's layout. RGB only: the dataset has no flow,
    so a two-stream or flow-stream model raises. `mesh` splits each batch
    over its ranks, as `collect_detections` does.
    """
    cfg = model.cfg
    if cfg.two_stream or cfg.input_stream != "rgb":
        raise ValueError(
            "AVA evaluation is RGB-only (the dataset has no flow stream); "
            "got two_stream/input_stream overrides")
    device = next(model.parameters()).device
    loader = DataLoader(dataset, cfg, batch_size=4, shuffle=False, train=False,
                        drop_last=False, num_workers=2)
    detect, shards = _detector(model, None, mesh)
    kf = cfg.total_frames // 2
    detections = []
    seen_keys = set()          # the keyframes evaluated (max_batches)
    for bi, batch in enumerate(loader.epoch(0)):
        if max_batches is not None and bi >= max_batches:
            break
        out = detect(*(torch.from_numpy(pad_batch_to(batch[k], shards)).to(device)
                       for k in ("rgb", "proposals", "prop_mask")), None)
        boxes = out["frame_boxes"][:, kf].float().cpu().numpy()     # [B, C, K, 4]
        scores = out["frame_scores"][:, kf].float().cpu().numpy()   # [B, C, K]
        mask = out["frame_mask"][:, kf].cpu().numpy()
        for b, meta in enumerate(batch["meta"]):
            key = (meta["video"], meta["timestamp"])
            seen_keys.add(key)
            keep = np.argwhere((mask[b] > 0) & (scores[b] > cfg.score_thresh))
            for c, k in keep:
                detections.append((key, int(c), float(scores[b, c, k]),
                                   boxes[b, c, k] / cfg.image_size))
    if dump_path:
        with open(dump_path, "wb") as f:
            pickle.dump({"detections": detections}, f)
    gt = dataset.groundtruth()
    if max_batches is not None:
        # a truncated pass is scored against the keyframes it saw
        gt = [g for g in gt if g[0] in seen_keys]
    return {"frame_mAP@0.5": ava_frame_map(detections, gt, cfg.num_classes)["mAP"]}
