"""Deterministic synthetic moving-box videos.

A copy of `step_tpu/data/synthetic.py` (numpy; `cv2` only inside
`write_ucf_layout`), held equal to it by `tests/test_torch_port_video.py`.

The reference has no test suite (SURVEY §4); this dataset is the rebuild's
correctness oracle: a rectangle of a class-specific color moves linearly
across a textured background, so GT tubes are exact, motion is linear (the
temporal-extrapolation model is exact), and a detector that learns anything
must localize it. Used by unit tests, the overfit sanity check, golden
regression tests, and `bench.py` input generation.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SyntheticConfig:
    image_size: int = 112
    num_frames: int = 18
    num_classes: int = 4
    max_boxes: int = 2          # moving boxes per clip (= GT tubes)
    min_box: float = 0.2        # box size as a fraction of image
    max_box: float = 0.4
    noise: float = 0.05
    # Always `max_boxes` actors, all sharing ONE class per clip — the
    # scenario where the official VOC/AVA no-reassignment matching rule
    # (eval/detection_metrics.py::_greedy_tp) actually bites: two
    # detections whose best IoU lands on the SAME GT make the second a
    # guaranteed FP. Single-actor clips can never trigger it. Actor starts
    # are re-sampled (best effort) to keep per-frame IoU between same-class
    # actors < 0.3, so both are visually recoverable.
    same_class_actors: bool = False
    # Pin every actor's class (implies one shared class like
    # same_class_actors, without the IoU re-sampling): `write_ucf_layout`
    # uses it so the on-disk label (pkl gttubes key) always matches the
    # pixel color — a trained model's eval on the layout would otherwise
    # see inconsistent color↔class mappings. None = per-clip random.
    force_label: "int | None" = None

    # class → RGB color of the moving box
    @property
    def palette(self):
        base = np.asarray(
            [
                [0.9, 0.1, 0.1],
                [0.1, 0.9, 0.1],
                [0.1, 0.1, 0.9],
                [0.9, 0.9, 0.1],
                [0.9, 0.1, 0.9],
                [0.1, 0.9, 0.9],
                [0.9, 0.5, 0.1],
                [0.5, 0.1, 0.9],
            ],
            np.float32,
        )
        if self.num_classes <= len(base):
            return base[: self.num_classes]
        # Beyond 8 classes the old palette REPEATED colors, making classes
        # indistinguishable (a silent mAP ceiling for the 60-class AVA-style
        # oracle runs). Generate distinct colors on an HSV wheel instead:
        # hues spread over [0, 1), alternating saturation/value rings.
        n = self.num_classes
        h = (np.arange(n, dtype=np.float32) * 0.6180339887) % 1.0  # golden
        s = np.where(np.arange(n) % 2 == 0, 0.95, 0.55).astype(np.float32)
        v = np.where(np.arange(n) % 4 < 2, 0.95, 0.6).astype(np.float32)
        i = np.floor(h * 6.0).astype(np.int32) % 6
        f = h * 6.0 - np.floor(h * 6.0)
        p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
        rgb = np.choose(
            i[:, None],
            [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
             np.stack([p, v, t], -1), np.stack([p, q, v], -1),
             np.stack([t, p, v], -1), np.stack([v, p, q], -1)],
        )
        return rgb.astype(np.float32)


def make_clip(seed: int, cfg: SyntheticConfig = SyntheticConfig()):
    """One clip: returns dict(rgb [T,H,W,3] f32 in [0,1],
    gt_tubes [G,T,4], gt_labels [G] int32, gt_mask [G])."""
    rng = np.random.RandomState(seed)
    S, T, G = cfg.image_size, cfg.num_frames, cfg.max_boxes
    t = np.arange(T, dtype=np.float32)

    # textured background (low-frequency noise), constant in time
    bg = rng.rand(S // 8 + 1, S // 8 + 1, 3).astype(np.float32)
    bg = np.kron(bg, np.ones((8, 8, 1), np.float32))[:S, :S] * 0.3 + 0.2
    rgb = np.tile(bg[None], (T, 1, 1, 1))

    n_boxes = G if cfg.same_class_actors else rng.randint(1, G + 1)
    shared_label = rng.randint(cfg.num_classes) if cfg.same_class_actors else None
    if cfg.force_label is not None:
        shared_label = int(cfg.force_label)
    gt_tubes = np.zeros((G, T, 4), np.float32)
    gt_labels = np.zeros((G,), np.int32)
    gt_mask = np.zeros((G,), np.float32)
    palette = cfg.palette

    def _tube_iou_np(a, b):
        # mean per-frame IoU of two [T, 4] tubes
        lt = np.maximum(a[:, :2], b[:, :2])
        rb = np.minimum(a[:, 2:], b[:, 2:])
        inter = np.prod(np.clip(rb - lt, 0, None), axis=1)
        area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), axis=1)
        return float(np.mean(inter / np.maximum(area(a) + area(b) - inter, 1e-6)))

    for g in range(n_boxes):
        for _attempt in range(20 if cfg.same_class_actors else 1):
            size = rng.uniform(cfg.min_box, cfg.max_box) * S
            # start position + a velocity that keeps the box inside the frame
            max_v = (S - size) / max(T - 1, 1)
            vx = rng.uniform(-max_v, max_v)
            vy = rng.uniform(-max_v, max_v)
            x0 = rng.uniform(0, S - size - abs(vx) * (T - 1)) + max(0.0, -vx * (T - 1))
            y0 = rng.uniform(0, S - size - abs(vy) * (T - 1)) + max(0.0, -vy * (T - 1))
            x1 = x0 + vx * t
            y1 = y0 + vy * t
            tube = np.stack([x1, y1, x1 + size, y1 + size], -1)
            if not cfg.same_class_actors or all(
                _tube_iou_np(tube, gt_tubes[h]) < 0.3 for h in range(g)
            ):
                break
        label = shared_label if shared_label is not None else rng.randint(cfg.num_classes)
        color = palette[label]
        gt_tubes[g] = tube
        gt_labels[g] = label
        gt_mask[g] = 1.0
        for fr in range(T):
            xa, ya, xb, yb = gt_tubes[g, fr]
            xa, ya = int(round(xa)), int(round(ya))
            xb, yb = int(round(xb)), int(round(yb))
            rgb[fr, max(ya, 0):yb, max(xa, 0):xb] = color

    rgb += rng.randn(*rgb.shape).astype(np.float32) * cfg.noise
    rgb = np.clip(rgb, 0.0, 1.0)
    return {
        "rgb": rgb,
        "gt_tubes": gt_tubes,
        "gt_labels": gt_labels,
        "gt_mask": gt_mask,
    }


def make_flow(rgb: np.ndarray, scale: float = 8.0) -> np.ndarray:
    """Derive a flow-like field from a clip: temporal brightness difference
    projected on x/y image gradients (a cheap optical-flow stand-in; the
    synthetic boxes move linearly, so real motion IS in the differences).
    Returns [T, H, W, 2] in [-1, 1] — the flow-stream input format."""
    gray = rgb.mean(-1)                                   # [T, H, W]
    dt = np.diff(gray, axis=0, append=gray[-1:])          # forward difference
    gx = np.gradient(gray, axis=2)
    gy = np.gradient(gray, axis=1)
    flow = np.stack([dt * np.sign(gx), dt * np.sign(gy)], -1) * scale
    return np.clip(flow, -1.0, 1.0).astype(np.float32)


def make_batch(seed: int, batch_size: int, cfg: SyntheticConfig = SyntheticConfig()):
    """Stack `batch_size` clips (seeds seed..seed+B-1) into one batch dict."""
    clips = [make_clip(seed + i, cfg) for i in range(batch_size)]
    return {k: np.stack([c[k] for c in clips]) for k in clips[0]}


class SyntheticVideoDataset:
    """Sliding-window dataset over synthetic LONG videos — the oracle analog
    of the UCF video protocol (``data/customize.py`` video sampling (recon)).

    Each of `num_videos` videos is one long `make_clip` of
    `(num_windows-1) * stride + window_frames` frames (linear motion holds
    over the whole video, so cross-clip linking has exact GT). Samples are
    sliding windows of `window_frames` at `stride` (= frames_per_chunk for
    the streaming protocol, so consecutive windows' central chunks tile the
    video — what `evaluate.collect_video_tubes` assumes). Satisfies the
    DataLoader protocol (`__len__`, `__getitem__` → rgb/gt_*/meta keys) and
    the video-eval protocol (`.samples`; no `.resolution` → boxes stay in
    model coordinates).
    """

    def __init__(self, syn: SyntheticConfig, num_videos: int,
                 num_windows: int, window_frames: int, stride: int,
                 seed: int = 0, with_flow: bool = False):
        if syn.num_frames != (num_windows - 1) * stride + window_frames:
            raise ValueError(
                "syn.num_frames must equal (num_windows-1)*stride + "
                f"window_frames; got {syn.num_frames} vs "
                f"{(num_windows - 1) * stride + window_frames}")
        self.syn = syn
        self.num_videos = num_videos
        self.num_windows = num_windows
        self.window_frames = window_frames
        self.stride = stride
        self.seed = seed
        self.with_flow = with_flow
        self.samples = [(f"synth_{v:04d}", w)
                        for v in range(num_videos) for w in range(num_windows)]
        self._cache: dict = {}

    def __len__(self):
        return len(self.samples)

    def _video(self, v: int) -> dict:
        if v not in self._cache:
            clip = make_clip(self.seed + v, self.syn)
            if self.with_flow:
                clip["flow"] = make_flow(clip["rgb"])
            self._cache[v] = clip
        return self._cache[v]

    def video_gt(self):
        """Full-video GT tubes: [(video, class, {frame(1-based): box})]."""
        out = []
        for v in range(self.num_videos):
            clip = self._video(v)
            for g in range(clip["gt_mask"].shape[0]):
                if clip["gt_mask"][g] <= 0:
                    continue
                frames = {f + 1: clip["gt_tubes"][g, f]
                          for f in range(self.syn.num_frames)}
                out.append((f"synth_{v:04d}", int(clip["gt_labels"][g]), frames))
        return out

    def __getitem__(self, i: int):
        video, w = self.samples[i]
        v = int(video.split("_")[1])
        clip = self._video(v)
        s, T = w * self.stride, self.window_frames
        item = {
            "rgb": clip["rgb"][s : s + T],
            "gt_tubes": clip["gt_tubes"][:, s : s + T],
            "gt_labels": clip["gt_labels"],
            "gt_mask": clip["gt_mask"],
            "video": video,
            "frame_indices": np.arange(s, s + T),
        }
        if self.with_flow:
            item["flow"] = clip["flow"][s : s + T]
        return item


def write_ucf_layout(
    root: str,
    num_videos: int,
    num_classes: int = 24,
    image_size: int = 32,
    frames_lo: int = 100,
    frames_hi: int = 150,
    max_boxes: int = 2,
    seed: int = 0,
    quality: int = 90,
):
    """Materialize a synthetic-oracle dataset ON DISK in the UCF101-24
    layout (``rgb-images/<label>/<video>/%05d.jpg`` + ``UCF101v2-GT.pkl``)
    at chosen scale statistics.

    The reference evaluates 3,207 real videos of ~100-150 frames over 24
    classes (SURVEY §2.1); its container has no real data, so this writer
    is the full-scale-STATISTICS stand-in: every host-side eval stage
    (JPEG decode, sliding-window collection, matching, linking, AP) sees
    realistic row counts even though the pixels are oracle clips
    (`make_clip` — linear motion, so linking/mAP have exact GT).

    Videos are assigned round-robin over classes; each is one long
    `make_clip` (same-class actors, exact tube GT). Returns the sorted
    video list. Idempotent per (root contents): existing files are
    overwritten.
    """
    import os
    import pickle

    import cv2

    rng = np.random.RandomState(seed)
    labels = [f"c{c:02d}" for c in range(num_classes)]
    nframes, gttubes, resolution, videos = {}, {}, {}, []
    for i in range(num_videos):
        cls = i % num_classes
        F = int(rng.randint(frames_lo, frames_hi + 1))
        # force_label pins the pixel color class to the on-disk label so a
        # model TRAINED on this layout sees a consistent color↔class map
        syn = SyntheticConfig(image_size=image_size, num_frames=F,
                              num_classes=num_classes, max_boxes=max_boxes,
                              force_label=cls)
        clip = make_clip(int(rng.randint(2**31 - 1)), syn)
        video = f"{labels[cls]}/v_{i:05d}"
        vdir = os.path.join(root, "rgb-images", video)
        os.makedirs(vdir, exist_ok=True)
        u8 = (np.clip(clip["rgb"], 0, 1) * 255).astype(np.uint8)
        for f in range(F):
            cv2.imwrite(os.path.join(vdir, f"{f + 1:05d}.jpg"),
                        cv2.cvtColor(u8[f], cv2.COLOR_RGB2BGR),
                        [cv2.IMWRITE_JPEG_QUALITY, quality])
        tubes = []
        frames_col = np.arange(1, F + 1, dtype=np.float32)[:, None]
        for g in range(max_boxes):
            if clip["gt_mask"][g] <= 0:
                continue
            tubes.append(np.concatenate(
                [frames_col, clip["gt_tubes"][g]], axis=1))
        nframes[video] = F
        gttubes[video] = {cls: tubes}
        resolution[video] = (image_size, image_size)
        videos.append(video)

    with open(os.path.join(root, "UCF101v2-GT.pkl"), "wb") as f:
        pickle.dump({
            "labels": labels,
            "train_videos": [[]],
            "test_videos": [sorted(videos)],
            "nframes": nframes,
            "gttubes": gttubes,
            "resolution": resolution,
        }, f)
    return sorted(videos)
