"""AVA v2.1 dataset (keyframe CSV annotations + extracted frames).

A copy of `step_tpu/data/ava.py` on the port's `config.py`,
`augmentations.py`, `eval/ava_eval.py`, `data/ucf.py::_load_image` (cv2,
imported when a frame is read) and `native_loader.py`, held equal to it by
`tests/test_torch_port_ava.py`.

Reference parity: ``data/ava.py::AVADataset`` (recon). Consumes the official
AVA CSV format:

  <csv>: video_id, timestamp(sec), x1, y1, x2, y2, action_id(1-based), person_id
         (box coords normalized to [0, 1])
  frames: <root>/frames/<video_id>/<video_id>_<%06d>.jpg  at `fps` frames/sec,
          frame number = timestamp * fps (AVA's standard extraction layout).

Each sample is one keyframe: the clip spans num_chunks * frames_per_chunk
frames centered on the keyframe (the reference serves fore/mid/back chunks
the same way); GT boxes are the keyframe's person boxes replicated across T
(AVA annotates keyframes only), labels are per-person **multi-hot** vectors
(rows sharing a person_id merge into one box with several actions).
"""

from __future__ import annotations

import csv
import os
import zlib
from collections import defaultdict
from typing import Optional

import numpy as np

from step_tpu_torch.config import StepConfig
from step_tpu_torch.data.augmentations import TubeAugment, resize_clip
from step_tpu_torch.data.ucf import _load_image


def read_ava_csv(path: str, label_map=None):
    """→ {(video, timestamp): [(box[4] normalized, dense_class, person_id)]}

    With `label_map` (an `eval.ava_eval.AVALabelMap`), sparse 1-based AVA
    action ids map to dense class indices and rows whose action is not an
    evaluated class are dropped — matching the official evaluator's
    whitelist (60 evaluated classes out of sparse ids 1..80). Without, ids
    are assumed dense-contiguous (stored as id-1, unfiltered).
    """
    ann = defaultdict(list)
    with open(path, newline="") as f:
        for row in csv.reader(f):
            if not row or row[0].startswith("#"):
                continue
            video, ts = row[0], float(row[1])
            box = np.asarray([float(x) for x in row[2:6]], np.float32)
            aid = int(row[6])
            action = label_map.dense(aid) if label_map is not None else aid - 1
            if label_map is not None and action < 0:
                continue
            pid = int(row[7]) if len(row) > 7 else -1
            ann[(video, ts)].append((box, action, pid))
    return dict(ann)


class AVADataset:
    """Keyframe sampler over AVA-format data."""

    def __init__(
        self,
        root: str,
        cfg: StepConfig,
        annotation_file: str,
        fps: int = 30,
        augment: bool = False,
        excluded_keyframes: Optional[set] = None,
        label_map=None,
        exclusions_file: Optional[str] = None,
        use_native: bool = True,
    ):
        self.root = root
        self.cfg = cfg
        self.fps = fps
        self.augment = TubeAugment() if augment else None
        # The C++ loader decodes straight to model resolution; augmentation
        # needs native-resolution frames, so it keeps the python path
        # (same policy as UCFDataset).
        self.use_native = use_native and not augment
        self.label_map = label_map
        self.annotations = read_ava_csv(
            os.path.join(root, annotation_file), label_map
        )
        excluded = set(excluded_keyframes or ())
        if exclusions_file:
            from step_tpu_torch.eval.ava_eval import read_exclusions

            excluded |= read_exclusions(os.path.join(root, exclusions_file))
        self.excluded = excluded
        self.keyframes = [k for k in sorted(self.annotations) if k not in excluded]

    def __len__(self):
        return len(self.keyframes)

    #: frame file layout; override for non-standard extractions
    #: (receives root, video, frame_num).
    frame_template = "{root}/frames/{video}/{video}_{frame:06d}.jpg"

    def _frame_path(self, video: str, frame_num: int) -> str:
        return self.frame_template.format(
            root=self.root, video=video, frame=frame_num
        )

    def clip_frame_numbers(self, timestamp: float) -> np.ndarray:
        """Frame numbers for the clip around a keyframe.

        The lower end clamps to frame 1 (AVA numbering is 1-based). There is
        no upper clamp — video length is unknown here; frames past the video
        tail have no file on disk and `__getitem__` forward-fills them with
        the last decoded frame (boundary-repeat padding, matching the
        reference's behavior of repeating edge frames at video boundaries).
        """
        cfg = self.cfg
        T = cfg.total_frames
        center = int(round(timestamp * self.fps))
        start = center - (T // 2) * cfg.temporal_stride
        idx = start + np.arange(T) * cfg.temporal_stride
        return np.maximum(idx, 1)

    def _gt_for_keyframe(self, key, img_hw):
        """Merge per-person action rows into multi-hot GT."""
        cfg = self.cfg
        H, W = img_hw
        G, T, C = cfg.max_gt_tubes, cfg.total_frames, cfg.num_classes
        gt_tubes = np.zeros((G, T, 4), np.float32)
        gt_labels = np.zeros((G, C), np.float32)
        gt_mask = np.zeros((G,), np.float32)

        by_person = defaultdict(lambda: {"box": None, "actions": []})
        for i, (box, action, pid) in enumerate(self.annotations[key]):
            slot = by_person[pid if pid >= 0 else ("anon", i)]
            slot["box"] = box
            if 0 <= action < C:
                slot["actions"].append(action)

        g = 0
        for slot in by_person.values():
            if g >= G:
                break
            if not slot["actions"]:
                # A person whose actions all fall outside the evaluated class
                # set carries no usable supervision — an all-zero multi-hot
                # target would train a forced-matched proposal as pure
                # background. Skip the slot entirely.
                continue
            box = slot["box"] * np.asarray([W, H, W, H], np.float32)
            gt_tubes[g] = np.tile(box[None], (T, 1))
            for a in slot["actions"]:
                gt_labels[g, a] = 1.0
            gt_mask[g] = 1.0
            g += 1
        return gt_tubes, gt_labels, gt_mask

    def _frame_paths(self, video: str, frame_nums) -> list:
        """Existing frame path per clip position (boundary-repeat fill)."""
        paths, last_ok = [], None
        for fn in frame_nums:
            path = self._frame_path(video, int(fn))
            if os.path.exists(path):
                last_ok = path
            elif last_ok is None:
                raise FileNotFoundError(path)
            paths.append(last_ok)
        return paths

    def __getitem__(self, i: int) -> dict:
        video, ts = self.keyframes[i]
        cfg = self.cfg
        frame_nums = self.clip_frame_numbers(ts)
        paths = self._frame_paths(video, frame_nums)

        if self.use_native:
            from step_tpu_torch.data import native_loader

            if native_loader.native_available():
                frames = native_loader.decode_clip(
                    paths, cfg.image_size,
                    np.zeros(3, np.float32), np.ones(3, np.float32))
                # AVA GT is normalized — it scales to the decoded (model)
                # resolution directly, no second resize needed
                gt_tubes, gt_labels, gt_mask = self._gt_for_keyframe(
                    (video, ts), frames.shape[1:3]
                )
                return {
                    "rgb": frames.astype(np.float32),
                    "gt_tubes": np.clip(gt_tubes, 0, cfg.image_size).astype(
                        np.float32),
                    "gt_labels": gt_labels,
                    "gt_mask": gt_mask,
                    "video": video,
                    "timestamp": ts,
                }

        frames = np.stack([_load_image(p) for p in paths])

        gt_tubes, gt_labels, gt_mask = self._gt_for_keyframe(
            (video, ts), frames.shape[1:3]
        )
        if self.augment is not None:
            ep = getattr(self, "_epoch", 0)  # epoch-salted (see ucf.py)
            rng = np.random.RandomState(
                zlib.crc32(f"{video}:{ts}:{ep}".encode()))
            frames, gt_tubes, gt_mask = self.augment(frames, gt_tubes, gt_mask, rng)
        frames, gt_tubes = resize_clip(frames, gt_tubes, cfg.image_size)
        gt_tubes = np.clip(gt_tubes, 0, cfg.image_size)
        return {
            "rgb": frames.astype(np.float32),
            "gt_tubes": gt_tubes.astype(np.float32),
            "gt_labels": gt_labels,
            "gt_mask": gt_mask,
            "video": video,
            "timestamp": ts,
        }

    def groundtruth(self):
        """GT in `ava_frame_map` format (normalized coords), restricted to
        in-range classes and non-excluded keyframes — the same filtering
        `_gt_for_keyframe` applies, so train and eval see one GT set."""
        C = self.cfg.num_classes
        gt = []
        for key in self.keyframes:
            for box, action, pid in self.annotations[key]:
                if 0 <= action < C:
                    gt.append((key, action, box))
        return gt
