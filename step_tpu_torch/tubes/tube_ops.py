"""Tube-level operations: tube IoU, temporal extension masks,
extrapolation, validity.

Port of `step_tpu/tubes/tube_ops.py`. Tubes are `[..., P, T, 4]`; frame
masks are `[T]` floats marking the frames whose boxes are real.
"""

from __future__ import annotations

import torch

from step_tpu_torch.tubes.boxes import clip_boxes, elementwise_iou

EPS = 1e-8


def tube_iou(tubes_a: torch.Tensor, tubes_b: torch.Tensor,
             frame_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean per-frame IoU between tube sets `[..., P, T, 4]` and
    `[..., G, T, 4]` → `[..., P, G]`, over the frames `frame_mask` (`[T]` or
    `[..., T]`) marks, or over all frames."""
    per_frame = elementwise_iou(tubes_a[..., :, None, :, :],
                                tubes_b[..., None, :, :, :])     # [..., P, G, T]
    if frame_mask is None:
        return per_frame.mean(dim=-1)
    w = frame_mask.to(per_frame.dtype)
    if w.dim() > 1:
        w = w[..., None, None, :]
    num = (per_frame * w).sum(dim=-1)
    den = torch.clamp(w.sum(dim=-1), min=EPS)
    return num / den


def valid_tube_mask(tubes: torch.Tensor, min_size: float = 1.0) -> torch.Tensor:
    """`[..., P, T, 4]` → `[..., P]`: True where every frame box has width
    and height of at least `min_size`."""
    w = tubes[..., 2] - tubes[..., 0]
    h = tubes[..., 3] - tubes[..., 1]
    return torch.all((w >= min_size) & (h >= min_size), dim=-1)


def chunk_frame_mask(step: int, num_chunks: int, frames_per_chunk: int,
                     extend: bool = True, device=None) -> torch.Tensor:
    """Frame-validity mask `[num_chunks * frames_per_chunk]` for refinement
    step `step` (0-indexed): step 0 activates the central chunk, and each
    later step one more chunk on each side (6 → 18 frames with 3 chunks)."""
    center = num_chunks // 2
    reach = min(step, center) if extend else 0
    chunk_ids = torch.arange(num_chunks, device=device)
    active = ((chunk_ids - center).abs() <= reach).to(torch.float32)
    return torch.repeat_interleave(active, frames_per_chunk)


def extrapolate_tubes(tubes: torch.Tensor, known_mask: torch.Tensor,
                      image_size: float | None = None) -> torch.Tensor:
    """Fill the unknown frames of each tube by linear-motion extrapolation.

    A masked least-squares line c(t) ≈ a + b·t is fitted per coordinate
    over the known frames; unknown frames take the fitted value (clamped
    to the image when `image_size` is given), known frames stay.

    tubes `[..., T, 4]`, known_mask `[T]` (or broadcastable to `[..., T]`).
    """
    T = tubes.shape[-2]
    t = torch.arange(T, dtype=tubes.dtype, device=tubes.device)
    w = torch.broadcast_to(known_mask.to(tubes.dtype), tubes.shape[:-1])

    sw = torch.clamp(w.sum(dim=-1, keepdim=True), min=EPS)          # [..., 1]
    mean_t = (w * t).sum(dim=-1, keepdim=True) / sw                 # [..., 1]
    mean_c = (w[..., None] * tubes).sum(dim=-2) / sw                # [..., 4]
    dt = t - mean_t                                                 # [..., T]
    var_t = (w * dt * dt).sum(dim=-1)[..., None]                    # [..., 1]
    cov = ((w * dt)[..., None] * (tubes - mean_c[..., None, :])).sum(dim=-2)
    slope = cov / torch.clamp(var_t, min=EPS)                       # [..., 4]
    fitted = mean_c[..., None, :] + slope[..., None, :] * dt[..., None]

    known = w[..., None] > 0
    filled = torch.where(known, tubes, fitted)
    if image_size is not None:
        filled = torch.where(known, tubes,
                             clip_boxes(filled, image_size, image_size))
    return filled
