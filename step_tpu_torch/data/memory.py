"""An in-memory dataset with the UCF101-24 reader's protocol, made of
synthetic oracle videos: the sliding windows `evaluate_ucf`,
`collect_detections` and `collect_video_tubes` read, without frames on
disk. `chip_smoke.py` and the tests evaluate on it.
"""

from __future__ import annotations

import numpy as np

from step_tpu_torch.data.synthetic import SyntheticConfig, make_clip, make_flow


class MemoryUCF:
    """A dataset with the UCF101-24 reader's protocol, held in memory:
    `videos` synthetic oracle videos (`data/synthetic.py::make_clip`) of
    `frames` frames at the model's size, whose native resolution is said to
    be `resolution` (H, W), so that `evaluate_ucf` scales its boxes back to
    it. `samples` are (video, centre) windows one chunk apart, items carry
    the `UCFDataset` keys (frames edge-clamped as it clamps them), and
    `video_groundtruth()` gives the GT in native pixels, frames 1-based.
    `with_flow` gives each item the video's flow (`make_flow`), as
    `UCFDataset(with_flow=True)` reads `brox-images`."""

    def __init__(self, cfg, videos: int, frames: int, resolution, seed: int,
                 with_flow: bool = False):
        syn = SyntheticConfig(image_size=cfg.image_size, num_frames=frames,
                              num_classes=cfg.num_classes, max_boxes=2)
        self.cfg, self.frames = cfg, frames
        self.clips = {f"c{i % cfg.num_classes:02d}/v_{i:05d}": make_clip(seed + i, syn)
                      for i in range(videos)}
        for clip in self.clips.values() if with_flow else ():
            clip["flow"] = make_flow(clip["rgb"])
        self.resolution = {v: tuple(resolution) for v in self.clips}
        H, W = resolution
        s = cfg.image_size
        self.to_native = np.asarray([W / s, H / s, W / s, H / s], np.float32)
        c = cfg.frames_per_chunk
        self.samples = [(v, start + c // 2) for v in self.clips
                        for start in range(0, frames - c + 1, c)]

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i: int) -> dict:
        video, center = self.samples[i]
        T = self.cfg.total_frames
        idx = np.clip(center + np.arange(T) - T // 2, 0, self.frames - 1)
        clip = self.clips[video]
        item = {"rgb": clip["rgb"][idx], "gt_tubes": clip["gt_tubes"][:, idx],
                "gt_labels": clip["gt_labels"], "gt_mask": clip["gt_mask"],
                "video": video, "center_frame": center, "frame_indices": idx}
        if "flow" in clip:
            item["flow"] = clip["flow"][idx]
        return item

    def video_groundtruth(self):
        frame_gt, tube_gt = [], []
        for video, clip in self.clips.items():
            for g in np.flatnonzero(clip["gt_mask"] > 0):
                cls = int(clip["gt_labels"][g])
                tube = {f + 1: clip["gt_tubes"][g, f] * self.to_native
                        for f in range(self.frames)}
                frame_gt += [((video, f), cls, box) for f, box in tube.items()]
                tube_gt.append((video, cls, tube))
        return frame_gt, tube_gt
