"""The initial proposal cuboids.

Port of `step_tpu/tubes/proposals.py:24-75` (`initial_cuboids_np`), in
numpy: 11 hand-placed boxes, constant over time —

  1 full-frame box, 4 corner boxes and 4 edge-centred boxes at 0.5 scale,
  2 centred boxes at 0.75 and 0.5 scale —

padded to `max_proposals` slots with a tiny centred box and mask 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def initial_cuboids_np(image_size: float, num_frames: int,
                       max_proposals: int | None = None,
                       layout: str = "default"):
    """(tubes `[P, T, 4]`, mask `[P]`) as read-only float32 numpy arrays."""
    s = float(image_size)
    boxes = [(0.0, 0.0, 1.0, 1.0)]
    if layout == "grid3":
        for cx in (0.25, 0.5, 0.75):
            for cy in (0.25, 0.5, 0.75):
                boxes.append((cx - 0.25, cy - 0.25, cx + 0.25, cy + 0.25))
        boxes.append((0.125, 0.125, 0.875, 0.875))
    elif layout == "default":
        for cx in (0.25, 0.75):
            for cy in (0.25, 0.75):
                boxes.append((cx - 0.25, cy - 0.25, cx + 0.25, cy + 0.25))
        for cx, cy in ((0.5, 0.25), (0.5, 0.75), (0.25, 0.5), (0.75, 0.5)):
            boxes.append((cx - 0.25, cy - 0.25, cx + 0.25, cy + 0.25))
        for half in (0.375, 0.25):
            boxes.append((0.5 - half, 0.5 - half, 0.5 + half, 0.5 + half))
    else:
        raise ValueError(f"unknown cuboid layout {layout!r}")

    arr = np.asarray(boxes, np.float32) * s
    P = arr.shape[0]
    cap = max_proposals or P
    if cap < P:
        raise ValueError(f"max_proposals={cap} < {P} initial cuboids")
    padded = np.zeros((cap, 4), np.float32)
    padded[:P] = arr
    padded[P:] = np.asarray([s * 0.49, s * 0.49, s * 0.51, s * 0.51], np.float32)
    mask = np.zeros((cap,), np.float32)
    mask[:P] = 1.0
    tubes = np.broadcast_to(padded[:, None, :], (cap, num_frames, 4)).copy()
    tubes.flags.writeable = False   # memoized: guard against aliasing
    mask.flags.writeable = False
    return tubes, mask


def initial_cuboids(image_size: float, num_frames: int,
                    max_proposals: int | None = None,
                    layout: str = "default", device=None):
    """`initial_cuboids_np` as tensors on `device`."""
    tubes, mask = initial_cuboids_np(image_size, num_frames, max_proposals,
                                     layout)
    return (torch.tensor(tubes, device=device),
            torch.tensor(mask, device=device))
