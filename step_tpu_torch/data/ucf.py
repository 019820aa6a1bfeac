"""UCF101-24 reader: frame JPEGs and the corrected-annotation pickle.

Port of `step_tpu/data/ucf.py`, on the port's own `config.py`,
`augmentations.py` and `native_loader.py`; host-side numpy, held
bit-equal to the original by `tests/test_torch_port_ucf.py`. The on-disk
layout is the one the action-detection literature shares:

  <root>/rgb-images/<ClassName>/<video>/{%05d}.jpg      (1-indexed frames)
  <root>/brox-images/...                                 (optical flow, opt.)
  <root>/UCF101v2-GT.pkl  — a pickle with the keys
      'labels'        list[str], the 24 class names
      'train_videos'  [list[video]] per split
      'test_videos'   [list[video]] per split
      'nframes'       {video: int}
      'gttubes'       {video: {class_idx: [ndarray [n, 5] (frame,x1,y1,x2,y2)]}}
      'resolution'    {video: (H, W)}

Items are fixed-shape clip dicts: rgb `[T, S, S, 3]` float in [0, 1] at
the model resolution S, gt_tubes `[G, T, 4]` in model pixels, gt_labels
`[G]`, gt_mask `[G]`, with T = frames_per_chunk * num_chunks frames
around a window's centre, edge-clamped at the video's ends. JPEGs decode
with the native loader where it builds and the item needs no augmentation
or flow, else with cv2 (imported when a frame is read); `decoder` says
which ran last.
"""

from __future__ import annotations

import os
import pickle
import zlib
from typing import Optional

import numpy as np

from step_tpu_torch.config import StepConfig
from step_tpu_torch.data.augmentations import TubeAugment, resize_clip


def _load_image(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_COLOR)
    if img is None:
        raise FileNotFoundError(path)
    return cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0


class UCFDataset:
    """Sliding windows over the videos of one split of UCF101-24 (or of any
    dataset in its layout): a window every `clip_stride` frames (default one
    chunk), so the windows' central chunks tile each video."""

    def __init__(
        self,
        root: str,
        cfg: StepConfig,
        split: str = "train",
        annotation_file: str = "UCF101v2-GT.pkl",
        clip_stride: Optional[int] = None,
        augment: bool = False,
        with_flow: bool = False,
        use_native: bool = True,
    ):
        self.root = root
        self.cfg = cfg
        self.split = split
        self.augment = TubeAugment() if augment else None
        self.with_flow = with_flow
        # The native loader decodes straight to the model resolution, so it
        # serves only the un-augmented path (augmentation crops and expands
        # at the native resolution first).
        self.use_native = use_native and not augment

        with open(os.path.join(root, annotation_file), "rb") as f:
            gt = pickle.load(f, encoding="latin1")
        self.labels = gt["labels"]
        self.nframes = gt["nframes"]
        self.gttubes = gt["gttubes"]
        self.resolution = gt.get("resolution", {})
        videos = gt["train_videos"][0] if split == "train" else gt["test_videos"][0]
        self.videos = list(videos)

        # one window every `stride` frames, keyed by its centre frame
        stride = clip_stride or cfg.frames_per_chunk
        T_c = cfg.frames_per_chunk
        self.samples = []
        self._centers_by_video: dict = {}
        for v in self.videos:
            n = self.nframes[v]
            centers = []
            for start in range(0, max(n - T_c + 1, 1), stride):
                centers.append(start + T_c // 2)            # centre frame (0-based)
                self.samples.append((v, centers[-1]))
            self._centers_by_video[v] = np.asarray(centers)
        self._orphan_owner_cache: dict = {}
        self.decoder = "native" if self._native_ready() else "cv2"

    def __len__(self):
        return len(self.samples)

    def _native_ready(self) -> bool:
        if not self.use_native or self.with_flow:
            return False
        from step_tpu_torch.data import native_loader

        return native_loader.native_available()

    # ------------------------------------------------------------- frames
    def _frame_path(self, video: str, idx0: int) -> str:
        return os.path.join(self.root, "rgb-images", video, f"{idx0 + 1:05d}.jpg")

    def _flow_path(self, video: str, idx0: int) -> str:
        return os.path.join(self.root, "brox-images", video, f"{idx0 + 1:05d}.jpg")

    def clip_frame_indices(self, video: str, center: int) -> np.ndarray:
        """T edge-clamped 0-based frame indices spanning all chunks,
        sampled every `temporal_stride` frames around the centre."""
        cfg = self.cfg
        T = cfg.total_frames
        offsets = (np.arange(T) - T // 2) * cfg.temporal_stride
        return np.clip(center + offsets, 0, self.nframes[video] - 1)

    def _orphan_owners(self, video: str) -> dict:
        """{(cls, tube_idx): designated centre} for the GT tubes that cover
        no window centre of their video.

        `_gt_for_frames` supervises a window only with the tubes that cover
        its centre, so a short tube between centres (or after the last)
        would supervise no window while `video_groundtruth` still scores
        it. Such a tube is given to the window whose centre is nearest its
        median annotated frame."""
        if video not in self._orphan_owner_cache:
            centers = self._centers_by_video.get(video)
            owners = {}
            if centers is not None and len(centers):
                # the effective centres: `_gt_for_frames` compares against
                # frame_idx[T//2], which is edge-clamped, so in a video
                # shorter than frames_per_chunk//2 + 1 frames the nominal
                # centre lies past the last frame
                centers = np.minimum(centers, self.nframes[video] - 1)
                for cls, tubes in self.gttubes.get(video, {}).items():
                    for ti, tube in enumerate(tubes):
                        frames0 = tube[:, 0].astype(np.int64) - 1
                        covered = set(int(f) for f in frames0)
                        if not covered.intersection(int(c) for c in centers):
                            med = float(np.median(frames0))
                            owners[(cls, ti)] = int(
                                centers[np.argmin(np.abs(centers - med))])
            self._orphan_owner_cache[video] = owners
        return self._orphan_owner_cache[video]

    def _gt_for_frames(self, video: str, frame_idx: np.ndarray):
        """The GT tubes that cover the window's centre (or that it owns as
        orphans), at the window's frames; a frame outside a tube takes the
        tube's nearest annotated box."""
        cfg = self.cfg
        G, T = cfg.max_gt_tubes, len(frame_idx)
        gt_tubes = np.zeros((G, T, 4), np.float32)
        gt_labels = np.zeros((G,), np.int32)
        gt_mask = np.zeros((G,), np.float32)
        g = 0
        orphan_owners = self._orphan_owners(video)
        center = int(frame_idx[T // 2])
        for cls, tubes in self.gttubes.get(video, {}).items():
            for ti, tube in enumerate(tubes):
                frames = tube[:, 0].astype(np.int64) - 1  # annotations 1-based
                lookup = {int(f): tube[i, 1:5] for i, f in enumerate(frames)}
                # A tube that only grazes the window's edge would supervise
                # the whole window with stale copies of a box the actor has
                # left, so it must cover the centre (or be an orphan owned
                # here).
                if (center not in lookup
                        and orphan_owners.get((cls, ti)) != center):
                    continue
                boxes = np.zeros((T, 4), np.float32)
                for t, f in enumerate(frame_idx):
                    if int(f) in lookup:
                        boxes[t] = lookup[int(f)]
                    else:
                        nearest = int(frames[np.argmin(np.abs(frames - f))])
                        boxes[t] = lookup[nearest]
                if g < G:
                    gt_tubes[g] = boxes
                    gt_labels[g] = cls
                    gt_mask[g] = 1.0
                    g += 1
        return gt_tubes, gt_labels, gt_mask

    # ------------------------------------------------------------- access
    def _load_clip_native(self, video: str, frame_idx: np.ndarray):
        """Decode and resize through the native loader; None if it is
        unavailable."""
        from step_tpu_torch.data import native_loader

        if not native_loader.native_available():
            return None
        paths = [self._frame_path(video, int(f)) for f in frame_idx]
        zero = np.zeros(3, np.float32)
        one = np.ones(3, np.float32)
        # mean 0, std 1: plain [0, 1] pixels, normalized later on the card
        return native_loader.decode_clip(paths, self.cfg.image_size, zero, one)

    def __getitem__(self, i: int) -> dict:
        video, center = self.samples[i]
        cfg = self.cfg
        frame_idx = self.clip_frame_indices(video, center)
        gt_tubes, gt_labels, gt_mask = self._gt_for_frames(video, frame_idx)

        # The native loader's frames come out at the model resolution, so
        # the GT scales by the pickle's resolution entry; without one, the
        # cv2 path measures the decoded frames.
        if self.use_native and not self.with_flow and video in self.resolution:
            frames = self._load_clip_native(video, frame_idx)
            if frames is not None:
                self.decoder = "native"
                H, W = self.resolution[video]
                s = np.asarray([cfg.image_size / W, cfg.image_size / H] * 2, np.float32)
                gt_scaled = np.clip(gt_tubes * s, 0, cfg.image_size)
                return {
                    "rgb": frames,
                    "gt_tubes": gt_scaled.astype(np.float32),
                    "gt_labels": gt_labels,
                    "gt_mask": gt_mask,
                    "video": video,
                    "center_frame": center,
                    "frame_indices": frame_idx,
                }

        self.decoder = "cv2"
        frames = np.stack([_load_image(self._frame_path(video, int(f))) for f in frame_idx])

        flow = None
        if self.with_flow:
            flow_imgs = np.stack(
                [_load_image(self._flow_path(video, int(f))) for f in frame_idx])
            flow = flow_imgs[..., :2] * 2.0 - 1.0  # [0,1] → [-1,1], (x, y)

        if self.augment is not None:
            # salted by the epoch (`DataLoader.epoch` sets `_epoch`), so each
            # epoch draws fresh augmentations
            ep = getattr(self, "_epoch", 0)
            rng = np.random.RandomState(zlib.crc32(f"{video}:{center}:{ep}".encode()))
            if flow is not None:
                frames, gt_tubes, gt_mask, flow = self.augment(
                    frames, gt_tubes, gt_mask, rng, flow=flow)
            else:
                frames, gt_tubes, gt_mask = self.augment(frames, gt_tubes, gt_mask, rng)

        frames, gt_tubes = resize_clip(frames, gt_tubes, cfg.image_size)
        gt_tubes = np.clip(gt_tubes, 0, cfg.image_size)
        out = {
            "rgb": frames.astype(np.float32),
            "gt_tubes": gt_tubes.astype(np.float32),
            "gt_labels": gt_labels,
            "gt_mask": gt_mask,
            "video": video,
            "center_frame": center,
            "frame_indices": frame_idx,
        }
        if flow is not None:
            flow_r, _ = resize_clip(flow, np.zeros((0, len(frame_idx), 4), np.float32),
                                    cfg.image_size)
            out["flow"] = flow_r.astype(np.float32)
        return out

    # --------------------------------------------------------- video eval
    def video_groundtruth(self):
        """The split's GT in the evaluators' format: frame-level
        `[((video, frame), cls, box)]` and tube-level `[(video, cls,
        {frame: box})]`, frames 1-based, boxes in native pixels."""
        frame_gt, tube_gt = [], []
        for v in self.videos:
            for cls, tubes in self.gttubes.get(v, {}).items():
                for tube in tubes:
                    tube_dict = {}
                    for row in tube:
                        f = int(row[0])
                        box = row[1:5].astype(np.float32)
                        frame_gt.append(((v, f), int(cls), box))
                        tube_dict[f] = box
                    tube_gt.append((v, int(cls), tube_dict))
        return frame_gt, tube_gt
