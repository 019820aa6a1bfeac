"""Clip and video detection: the progressive forward, class scores,
per-frame NMS, cross-clip linking and the streaming chunk cache.

Port of `step_tpu/inference.py`: `class_scores_from_logits` (:26-31),
`nms_surface` (:40-94, the batched-NMS branch), `detect_clip` (:126-151),
the late-fusion protocol `detect_clip_late_fusion` (:154-188) and
`eval_needs_flow` (:429-433), the data-parallel forms
`make_parallel_detect_fn`, `make_parallel_late_fusion_detect_fn` and
`pad_batch_to` (:481-582), the streaming forms `detect_video_stream`
and `detect_video_stream_batched` (:290-422) and `detect_video`
(:584-630); each takes a two-stream detector's second stream as `flow`.
The NMS surface is the custom operator `step::nms_surface`: on the card
one kernel (`csrc/nms.cu`) runs the NMS and writes the survivors; the
plain version gathers them with `torch.gather`. The functions take the port's model,
which holds its config (`model.cfg`) and weights, where the JAX package
takes a variables tree and a config; the JAX package's `stem_features`
and `refine_from_features` (:191-255) are `STEPDetector.stem(x, chunks=1)`
and `STEPDetector.refine` here.

Not carried over, each a JAX or TPU device that computes nothing: the
one-hot matmul select for large surfaces (:70-82, identical values); the
jit memoizers (`_stream_fns`, `make_detect_fn`, `make_detect_video_fn` and
the others); the relay-stall readbacks `float(jnp.sum(...))` of the
streaming forms (:347, :394, :416).
"""

from __future__ import annotations

import numpy as np
import torch

from step_tpu_torch.config import StepConfig
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.ops.kernel_op import kernel_op
from step_tpu_torch.ops.nms import _f32, kernel_valid, nms_many_plain, premask_scores
from step_tpu_torch.parallel.distributed import shard_rows
from step_tpu_torch.parallel.mesh import mesh_group
from step_tpu_torch.tubes.linking import link_tubes_multiclass_k
from step_tpu_torch.utils.spans import span


def class_scores_from_logits(cls_logits: torch.Tensor, cfg: StepConfig) -> torch.Tensor:
    """`[..., ncls]` logits → `[..., C]` foreground probabilities: sigmoid
    for multilabel datasets, else softmax with the background column
    dropped."""
    if cfg.multilabel:
        return torch.sigmoid(cls_logits)
    return torch.softmax(cls_logits, dim=-1)[..., 1:]


def _surface_plain(tubes: torch.Tensor, scores: torch.Tensor, prop_mask: torch.Tensor,
                   max_keep: int, iou_threshold: float, score_threshold: float):
    """(frame_boxes, frame_scores, frame_mask) of the surface: the B·T·C
    problems expanded, pre-masked (`premask_scores`), run through
    `nms_many_plain`, and the survivors gathered."""
    B, P, T = tubes.shape[:3]
    C = scores.shape[-1]
    K = max_keep
    boxes_prob = tubes.transpose(1, 2)[:, :, None].expand(B, T, C, P, 4)
    scores_prob = scores.transpose(1, 2)[:, None].expand(B, T, C, P)
    valid_prob = prop_mask[:, None, None].expand(B, T, C, P)
    live = premask_scores(scores_prob.reshape(-1, P), score_threshold,
                          valid_prob.reshape(-1, P))
    idx, mask = nms_many_plain(boxes_prob.reshape(-1, P, 4), live, iou_threshold, K)
    keep_idx = idx.reshape(B, T, C, K).to(torch.int64)
    keep_mask = mask.reshape(B, T, C, K)
    frame_boxes = torch.gather(boxes_prob, 3,
                               keep_idx[..., None].expand(B, T, C, K, 4))
    frame_scores = torch.gather(scores_prob, 3, keep_idx) * keep_mask
    return frame_boxes, frame_scores, keep_mask


def nms_surface_plain(tubes: torch.Tensor, scores: torch.Tensor,
                      prop_mask: torch.Tensor, cfg: StepConfig):
    """The plain version of `nms_surface`, on any device. The CPU path and
    the tests use it."""
    K = min(cfg.max_detections, tubes.shape[1])
    return _surface(tubes, scores, *_surface_plain(tubes, scores, prop_mask, K,
                                                   cfg.nms_thresh, cfg.score_thresh))


def _surface(tubes, scores, frame_boxes, frame_scores, frame_mask):
    return {
        "tubes": tubes,
        "tube_scores": scores,
        "frame_boxes": frame_boxes,
        "frame_scores": frame_scores,
        "frame_mask": frame_mask,
    }


def _nms_surface_cpu(tubes: torch.Tensor, scores: torch.Tensor, prop_mask: torch.Tensor,
                     max_keep: int, iou_threshold: float,
                     score_threshold: float) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`step::nms_surface`, the surface → (frame_boxes, frame_scores,
    frame_mask): on a CPU tensor the plain version, on a CUDA tensor one
    launch of `csrc/nms.cu`."""
    return _surface_plain(tubes, scores, prop_mask, max_keep, iou_threshold,
                          score_threshold)


def _nms_surface_fake(tubes, scores, prop_mask, max_keep, iou_threshold, score_threshold):
    B, _, T = tubes.shape[:3]
    shape = (B, T, scores.shape[-1], max_keep)
    return (tubes.new_empty(shape + (4,), dtype=torch.float32),
            tubes.new_empty(shape, dtype=torch.float32),
            tubes.new_empty(shape, dtype=torch.float32))


def _nms_surface_launch(tubes, scores, prop_mask, max_keep, iou_threshold, score_threshold):
    """The kernel reads the tubes, scores and mask through strides (B·T
    groups of P boxes shared by C problems) and writes the three outputs."""
    from step_tpu_torch import kernels

    B, P, T = tubes.shape[:3]
    C = scores.shape[-1]
    out = dict(device=tubes.device, dtype=torch.float32)
    frame_boxes = torch.empty((B, T, C, max_keep, 4), **out)
    frame_scores = torch.empty((B, T, C, max_keep), **out)
    frame_mask = torch.empty((B, T, C, max_keep), **out)
    if frame_mask.numel():
        kernels.nms_many_forward(
            tubes.transpose(1, 2), scores.unsqueeze(1).expand(B, T, P, C),
            kernel_valid(prop_mask).unsqueeze(1).expand(B, T, P), frame_mask,
            _f32(iou_threshold), _f32(score_threshold),
            out_boxes=frame_boxes, out_scores=frame_scores)
    return frame_boxes, frame_scores, frame_mask


nms_surface_op = kernel_op("nms_surface", _nms_surface_cpu, _nms_surface_launch,
                           _nms_surface_fake)


def nms_surface(tubes: torch.Tensor, scores: torch.Tensor,
                prop_mask: torch.Tensor, cfg: StepConfig):
    """Per-frame, per-class greedy NMS over the final tubes.

    tubes `[B, P, T, 4]` float32, scores `[B, P, C]` float32 or bfloat16
    (already masked to real proposals), prop_mask `[B, P]`. Runs B·T·C
    independent problems of P boxes; K = min(max_detections, P) keep slots
    each. Returns the surface: frame_boxes `[B, T, C, K, 4]`, frame_scores
    and frame_mask `[B, T, C, K]` float32, beside the tubes and scores.

    One call of `step::nms_surface` (`nms_surface_op`): a CPU tensor goes
    to the plain version, a CUDA tensor to one launch of `csrc/nms.cu`.
    """
    K = min(cfg.max_detections, tubes.shape[1])
    return _surface(tubes, scores, *nms_surface_op(
        tubes, scores, prop_mask, K, _f32(cfg.nms_thresh), _f32(cfg.score_thresh)))


def _detections(outputs, prop_mask: torch.Tensor, cfg: StepConfig):
    """The last step's tubes and class scores of the detector's outputs,
    through the NMS surface."""
    with span("detect.nms"):
        tubes = outputs["tubes"][-1]
        scores = class_scores_from_logits(outputs["cls_logits"][-1], cfg)
        # Padding slots are never supervised, so their logits mean nothing:
        # zero them before anyone reads the scores.
        scores = scores * prop_mask[..., None].to(scores.dtype)
        return nms_surface(tubes, scores, prop_mask, cfg)


@torch.inference_mode()
def detect_clip(model, rgb: torch.Tensor, proposals: torch.Tensor,
                prop_mask: torch.Tensor, flow: torch.Tensor | None = None):
    """Full detection for a batch of clips with `model`
    (`step_tpu_torch.models.detector.STEPDetector`, its config in
    `model.cfg`).

    rgb `[B, T, H, W, 3]` uint8 (or float in [0, 1]) — a flow-input
    detector's flow `[B, T, H, W, 2]` int8 (or float in [-1, 1]) in its
    place —, proposals `[B, P, T, 4]`, prop_mask `[B, P]`, and `flow`, a
    two-stream detector's second stream. Returns:
      tubes        `[B, P, T, 4]` — final refined tubes
      tube_scores  `[B, P, C]`    — per-tube class probabilities, 0 on
                                    padding slots
      frame_boxes  `[B, T, C, K, 4]`, frame_scores `[B, T, C, K]`,
      frame_mask   `[B, T, C, K]`    — per-frame per-class NMS survivors
    """
    with span("detect.clip"):
        return _detections(model(rgb, proposals, flow), prop_mask, model.cfg)


@torch.inference_mode()
def detect_clip_late_fusion(model_rgb, model_flow, rgb: torch.Tensor,
                            flow: torch.Tensor, proposals: torch.Tensor,
                            prop_mask: torch.Tensor):
    """The reference's two-stream protocol: two single-stream detectors,
    `model_rgb` on the RGB and `model_flow` (input_stream "flow") on the
    flow, both refining the same proposals; the class scores fuse before
    NMS as w * p_rgb + (1 - w) * p_flow, w = cfg.late_fusion_weight, and
    the boxes are the RGB stream's. `model_rgb.cfg` gives w, the
    class-score rule and the NMS settings. Returns `detect_clip`'s dict."""
    cfg = model_rgb.cfg
    if model_rgb.cfg.input_stream != "rgb" or model_flow.cfg.input_stream != "flow":
        raise ValueError("late fusion takes an RGB detector and a flow-stream "
                         "detector (input_stream 'rgb' and 'flow')")
    out_rgb = model_rgb(rgb, proposals)
    out_flow = model_flow(flow, proposals)
    w = cfg.late_fusion_weight
    with span("detect.nms"):
        scores = (w * class_scores_from_logits(out_rgb["cls_logits"][-1], cfg)
                  + (1.0 - w) * class_scores_from_logits(out_flow["cls_logits"][-1], cfg))
        scores = scores * prop_mask[..., None].to(scores.dtype)
        return nms_surface(out_rgb["tubes"][-1], scores, prop_mask, cfg)


FLOW_DATASET_ERROR = ("two-stream/late-fusion/flow-stream eval needs a "
                      "flow-enabled dataset (with_flow=True)")


def _gather_rows(out: dict, group, world: int) -> dict:
    """Every rank's rows of `out`'s tensors, concatenated in rank order, as
    host tensors on every rank: the host copies travel through the group's
    host backend (gloo has no all-gather of CUDA tensors)."""
    host = {k: v.cpu().contiguous() for k, v in out.items()}
    if world == 1:
        return host
    gathered = {}
    for k, v in host.items():
        parts = [torch.empty_like(v) for _ in range(world)]
        torch.distributed.all_gather(parts, v, group=group)
        gathered[k] = torch.cat(parts)
    return gathered


def _rows(x, rows: slice, device):
    return torch.as_tensor(x)[rows].to(device)


def make_parallel_detect_fn(cfg: StepConfig, mesh):
    """`detect_clip` over the "data" axis of `mesh` →
    `detect(model, rgb, proposals, prop_mask, flow=None)`, called as
    `detect_clip` is, alike on every rank with the same global batch (host
    or device tensors, its batch a multiple of the mesh's size:
    `pad_batch_to`), a two-stream `cfg`'s flow with it. Each rank detects
    its block of rows (`parallel.distributed.shard_rows`, as GSPMD places
    a batch-sharded array) with its `model`; the outputs, gathered to every
    rank in rank order, are `detect_clip`'s dict of the global batch, on
    the host.

    Port of `step_tpu/inference.py:481-533`. The JAX function takes its
    variables at the call; here the rank's model, which holds its weights,
    takes their place, so the factory has no `model` argument."""
    group, rank, world = mesh_group(mesh)

    def detect(model, rgb, proposals, prop_mask, flow=None):
        if (flow is not None) != cfg.two_stream:
            raise ValueError("a two-stream detector takes flow, and only it does")
        rows = shard_rows(len(rgb), world, rank)
        device = next(model.parameters()).device
        out = detect_clip(model, *(None if x is None else _rows(x, rows, device)
                                   for x in (rgb, proposals, prop_mask, flow)))
        return _gather_rows(out, group, world)

    return detect


def make_parallel_late_fusion_detect_fn(cfg: StepConfig, mesh):
    """`detect_clip_late_fusion` over the "data" axis of `mesh`, as
    `make_parallel_detect_fn` runs `detect_clip` →
    `detect_lf(model_rgb, model_flow, rgb, flow, proposals, prop_mask)`,
    called as `detect_clip_late_fusion` is (`step_tpu/inference.py:539-564`)."""
    group, rank, world = mesh_group(mesh)

    def detect_lf(model_rgb, model_flow, rgb, flow, proposals, prop_mask):
        rows = shard_rows(len(rgb), world, rank)
        device = next(model_rgb.parameters()).device
        rgb, proposals, prop_mask, flow = (_rows(x, rows, device)
                                           for x in (rgb, proposals, prop_mask, flow))
        out = detect_clip_late_fusion(model_rgb, model_flow, rgb, flow, proposals, prop_mask)
        return _gather_rows(out, group, world)

    return detect_lf


def pad_batch_to(arr: np.ndarray, multiple: int) -> np.ndarray:
    """Pad a [B, ...] array's batch dim up to the next multiple by repeating
    the last element (keeps shapes static for sharded eval; padded rows are
    dropped host-side by iterating only the real metadata)."""
    b = arr.shape[0]
    pad = -b % multiple
    if pad == 0:
        return arr
    return np.concatenate([arr, np.repeat(arr[-1:], pad, axis=0)], axis=0)


def eval_needs_flow(cfg: StepConfig, model_flow=None) -> bool:
    """True when an evaluation collector must read flow from the dataset:
    a two-stream or flow-stream detector, or late fusion."""
    return cfg.two_stream or model_flow is not None or cfg.input_stream == "flow"


def window_centers(n: int, cfg: StepConfig, device=None) -> torch.Tensor:
    """The chunks `[n, cfg.num_chunks]` of the n windows one chunk apart
    over a video of n chunks: window i is centred on chunk i, and at the
    video's edges the first or last chunk repeats."""
    half = cfg.num_chunks // 2
    return (torch.arange(n, device=device)[:, None]
            + torch.arange(-half, half + 1, device=device)).clamp(0, n - 1)


def link_video(tubes: torch.Tensor, scores: torch.Tensor, prop_mask: torch.Tensor,
               cfg: StepConfig, clip_mask: torch.Tensor | None = None,
               stride: int | None = None):
    """`link_tubes_multiclass_k` with the linking settings of `cfg`: K =
    cfg.link_tubes_per_class video tubes per class, and the second-actor
    suppression off where cfg.link_suppress_iou is 0."""
    return link_tubes_multiclass_k(
        tubes, scores, prop_mask, cfg.link_iou_weight, cfg.link_tubes_per_class,
        cfg.link_trim_thresh, clip_mask, stride=stride,
        suppress_iou=cfg.link_suppress_iou if cfg.link_suppress_iou > 0 else None)


def _chunked(frames: torch.Tensor, cfg: StepConfig, caller: str):
    """(chunk length c, chunk count n) of a video `[F, H, W, 3]`, or the
    errors of the JAX package's streaming forms."""
    if not cfg.chunk_stem:
        raise ValueError(f"{caller} requires cfg.chunk_stem=True")
    c = cfg.frames_per_chunk
    if frames.shape[0] % c:
        raise ValueError(f"video length {frames.shape[0]} not a multiple of "
                         f"chunk size {c}")
    return c, frames.shape[0] // c


@torch.inference_mode()
def detect_video_stream(model, frames: torch.Tensor, flow: torch.Tensor | None = None):
    """Sliding-window video detection with a per-chunk stem-feature cache,
    one clip at a time (the live form).

    Requires `cfg.chunk_stem`. frames `[F, H, W, 3]`, F a multiple of the
    chunk size c. Clip i is the window of K = cfg.num_chunks chunks centred
    on chunk i (stride one chunk); windows at the video's edges repeat the
    first or last chunk. Each chunk's stem runs once, cached for every
    window that holds it; each window's features are gathered from the
    cache and refined. `flow` `[F, H, W, 2]` is a two-stream detector's
    second stream. Runs on the device of `frames`. Returns a list of n
    detection dicts as `detect_clip` returns them, batch 1.
    """
    cfg = model.cfg
    c, n = _chunked(frames, cfg, "detect_video_stream")
    cache = {}

    def chunk_feat(i):
        if i not in cache:      # the chunk stemmed alone, as one chunk
            part = slice(i * c, (i + 1) * c)
            cache[i] = model.stem(frames[None, part], chunks=1,
                                  flow=None if flow is None else flow[None, part])
        return cache[i]

    proposals, prop_mask = STEPDetector.initial_proposals(cfg, 1, device=frames.device)
    results = []
    for ids in window_centers(n, cfg).tolist():
        feat = torch.cat([chunk_feat(i) for i in ids], dim=1)
        results.append(_detections(model.refine(feat, proposals), prop_mask, cfg))
    return results


@torch.inference_mode()
def detect_video_stream_batched(model, frames: torch.Tensor, clip_batch: int = 64,
                                flow: torch.Tensor | None = None):
    """`detect_video_stream` for a whole video at once (the offline form).

    The stems of all n chunks run in batches of `clip_batch` chunks; the
    windows are gathered from the cached features on the device; refinement
    and NMS run over `clip_batch` windows at a time, the last batch ragged.
    `flow` `[F, H, W, 2]` is a two-stream detector's second stream. Runs on
    the device of `frames`. Returns one detection dict as from
    `detect_clip`, with leading dimension n (one clip per chunk centre).
    """
    cfg = model.cfg
    c, n = _chunked(frames, cfg, "detect_video_stream_batched")
    dev = frames.device
    chunks = frames.reshape(n, c, *frames.shape[1:])
    fchunks = None if flow is None else flow.reshape(n, c, *flow.shape[1:])
    feats = torch.cat([model.stem(chunks[i:i + clip_batch], chunks=1,
                                  flow=None if fchunks is None else fchunks[i:i + clip_batch])
                       for i in range(0, n, clip_batch)])      # [n, t', H', W', C]
    centers = window_centers(n, cfg, device=dev)
    proposals, prop_mask = STEPDetector.initial_proposals(cfg, min(clip_batch, n),
                                                          device=dev)
    outs = []
    for i in range(0, n, clip_batch):
        ctr = centers[i:i + clip_batch]
        b = ctr.shape[0]
        # the windows' features, gathered from the cache on the device
        windows = feats[ctr].reshape(b, -1, *feats.shape[2:])
        outs.append(_detections(model.refine(windows, proposals[:b]), prop_mask[:b], cfg))
    return {key: torch.cat([o[key] for o in outs]) for key in outs[0]}


@torch.inference_mode()
def detect_video(model, clips: torch.Tensor, clip_mask: torch.Tensor | None = None,
                 tiling_stride: int | None = None, flow: torch.Tensor | None = None):
    """Video detection: detect all L clips of a video in one batch, then
    link the per-clip tubes into K video tubes per class on the device
    (iterative node-disjoint Viterbi and temporal trim,
    `tubes/linking.py`).

    clips `[L, T, H, W, 3]`, a video tiled into L clips; runs on their
    device. `clip_mask` `[L]`, 0 for padded clip slots (a repeat of the
    last real clip), which add nothing to the link values and are always
    trimmed out. `tiling_stride`: video frames between consecutive clips;
    None is the non-overlapping tiling (transition IoU of the last box
    against the first), a sliding window passes its stride. `flow` `[L, T,
    H, W, 2]` is a two-stream detector's second stream.

    Returns `detect_clip`'s dict plus, with K = cfg.link_tubes_per_class:
      link_paths       `[C, K, L]` int32 — tube index per clip
      link_scores      `[C, K]`          — path objective over the trimmed run
      link_trim        `[C, K, L]`       — 1 where the video tube is active
      link_tube_scores `[C, K]`          — mean per-clip score over the run
    """
    cfg = model.cfg
    proposals, prop_mask = STEPDetector.initial_proposals(cfg, clips.shape[0],
                                                          device=clips.device)
    det = detect_clip(model, clips, proposals, prop_mask, flow)
    link = link_video(det["tubes"], det["tube_scores"], prop_mask, cfg, clip_mask,
                      stride=tiling_stride)
    det["link_paths"] = link["paths"]
    det["link_scores"] = link["values"]
    det["link_trim"] = link["trim"]
    det["link_tube_scores"] = link["tube_scores"]
    return det
