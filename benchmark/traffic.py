"""The one traffic generator: every cell's inputs from its workload file's
`traffic` parameters and the run's seed.

Serving (`entry` "serve"): a pool of `pool_batches` x `batch` distinct
uint8 clips `[T, H, W, 3]` in host memory, and the order in which one
closed-loop client sends them, batch by batch: a seeded permutation of the
pool, cycled, so that no request repeats the one before it.

Training (`entry` "train"): `pool_clips` clips, each with `gt_tubes`
moving boxes in its `gt_slots` slots (linear motion, sizes and speeds
drawn from the seed) and a class each, served as a dataset whose items
carry the rgb as [0, 1] float32, as a decoder hands it to the loader.

Every seed gives the same sizes and counts; only the pixels, boxes,
classes and the order change.
"""

from __future__ import annotations

import numpy as np


def clip_pool(n: int, cfg, seed: int) -> np.ndarray:
    """`n` uint8 clips `[n, T, S, S, 3]` drawn from `seed`."""
    S, T = cfg.image_size, cfg.total_frames
    return np.random.default_rng(seed).integers(0, 256, (n, T, S, S, 3), dtype=np.uint8)


def request_order(pool_batches: int, seed: int) -> np.ndarray:
    """The pool's batches in the order the client sends them, cycled."""
    return np.random.default_rng(seed).permutation(pool_batches)


def moving_boxes(n: int, slots: int, counts, cfg, seed: int):
    """(gt_tubes `[n, slots, T, 4]`, gt_mask `[n, slots]`, gt_labels `[n,
    slots]` int): each clip holds between counts[0] and counts[1] boxes,
    each of a side between 0.2 and 0.5 of the image, moving linearly by up
    to 0.3 of the image over the clip, clipped to the image."""
    rng = np.random.default_rng(seed)
    S, T = float(cfg.image_size), cfg.total_frames
    size = rng.uniform(0.2, 0.5, (n, slots, 2)) * S
    start = rng.uniform(0.0, 1.0, (n, slots, 2)) * (S - size)
    move = rng.uniform(-0.3, 0.3, (n, slots, 2)) * S
    t = np.linspace(0.0, 1.0, T)[None, None, :, None]
    lo = start[:, :, None] + move[:, :, None] * t
    tubes = np.clip(np.concatenate([lo, lo + size[:, :, None]], -1), 0.0, S)
    live = rng.integers(counts[0], counts[1] + 1, n)
    mask = (np.arange(slots)[None] < live[:, None]).astype(np.float32)
    labels = rng.integers(0, cfg.num_classes, (n, slots)).astype(np.int32)
    return tubes.astype(np.float32) * mask[:, :, None, None], mask, labels * (mask > 0)


class TrainClips:
    """The training dataset: item i is clip i with its boxes, its rgb as
    [0, 1] float32, and its index."""

    def __init__(self, traffic: dict, cfg, seed: int):
        n = traffic["pool_clips"]
        self.clips = clip_pool(n, cfg, seed)
        self.tubes, self.mask, self.labels = moving_boxes(
            n, traffic["gt_slots"], traffic["gt_tubes"], cfg, seed + 1)

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i: int) -> dict:
        return {"rgb": self.clips[i].astype(np.float32) / np.float32(255.0),
                "gt_tubes": self.tubes[i], "gt_labels": self.labels[i],
                "gt_mask": self.mask[i], "index": i}


class Reservoir:
    """A uniform sample of `size` items of a stream of unknown length,
    drawn from `seed` (Algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size, self.rng, self.seen, self.items = size, np.random.default_rng(seed), 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1
