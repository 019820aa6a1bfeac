"""Tube-of-interest ROI-align: a plain PyTorch version and the kernel wrapper.

Port of `step_tpu/ops/roi_align.py` (sample geometry, interpolation
matrices, the batched contraction of `batched_tube_roi_align_kron`) and of
the forward of `step_tpu/ops/roi_align_pallas.py::tube_roi_align_pallas`.

Semantics are Detectron's legacy ROIAlign (maskrcnn-benchmark,
aligned=False): boxes are scaled by `spatial_scale` with no half-pixel
offset; an ROI is at least one feature cell wide and high; each pooled bin
averages `sampling_ratio**2` bilinear samples at the centres of a regular
sub-grid; a sample outside [-1, limit] on either axis contributes 0, one
inside is clamped to [0, limit - 1].

Layout is channels-last: features `[B, T', H, W, C]`, tubes `[B, N, T, 4]`,
output `[B, N, T', pooled, pooled, C]`.

The forward is the custom operator `step::tube_roi_align`
(`tube_roi_align_op`, `ops/kernel_op.py`): the plain version on the CPU,
the kernel on the card, a shape function under `torch.export`, which so
keeps each call as one node of a served program. Under autograd
`tube_roi_align` is a `torch.autograd.Function` over it, the port of
`_tube_roi_align_vjp` (`step_tpu/ops/roi_align_pallas.py:130-159`): the
backward is autograd through `tube_roi_align_plain`, as the JAX package's
backward is autodiff of its jnp reference.
"""

from __future__ import annotations

import torch

from step_tpu_torch.ops.kernel_op import kernel_op

# A sample coordinate parked far outside [-1, limit]: every mask drops it.
# The adaptive branch uses it to disable padded samples with static shapes.
_INVALID_COORD = -10.0


def feature_time_indices(T: int, Tp: int, device=None) -> torch.Tensor:
    """The input frame at the centre of each strided feature slice t' — the
    frame whose box pools slice t'. T=18, T'=5 → [1, 5, 9, 12, 16]."""
    if T == Tp:
        return torch.arange(Tp, device=device)
    pos = (torch.arange(Tp, dtype=torch.float32, device=device) + 0.5) * (T / Tp)
    return pos.to(torch.int64)


def adaptive_max_ratio(H: int, W: int, pooled: int) -> int:
    """Static cap on the per-ROI sample count of the adaptive branch:
    ceil(roi / bin) <= ceil(max(H, W) / pooled) for boxes inside the image."""
    return max(1, -(-max(H, W) // pooled))


def roi_sample_coords(boxes: torch.Tensor, pooled: int, scale: float,
                      ratio: int, adaptive_max: int | None = None):
    """Per-axis sample coordinates for boxes `[..., 4]`, in feature cells.

    `ratio > 0`: coordinates `[..., pooled, ratio]`, and `count` is the
    float `ratio**2`. `ratio <= 0` is maskrcnn-benchmark's adaptive branch
    (`ceil(roi_extent / pooled)` samples per ROI and axis): coordinates
    `[..., pooled, adaptive_max]` with each ROI's unused tail parked at
    `_INVALID_COORD`, and `count` the per-ROI tensor `g_y * g_x`.

    Returns (ys, xs, count).
    """
    b = boxes.to(torch.float32) * scale
    x1, y1 = b[..., 0], b[..., 1]
    roi_w = torch.clamp(b[..., 2] - x1, min=1.0)
    roi_h = torch.clamp(b[..., 3] - y1, min=1.0)
    grid = torch.arange(pooled, dtype=torch.float32, device=boxes.device)
    if ratio > 0:
        sub = torch.arange(ratio, dtype=torch.float32, device=boxes.device)
        off = grid[:, None] + (sub[None, :] + 0.5) / ratio     # [pooled, ratio]
        ys = y1[..., None, None] + off * (roi_h / pooled)[..., None, None]
        xs = x1[..., None, None] + off * (roi_w / pooled)[..., None, None]
        return ys, xs, float(ratio * ratio)
    if adaptive_max is None:
        raise ValueError("ratio <= 0 (adaptive sampling) requires "
                         "adaptive_max (use adaptive_max_ratio(H, W, P))")
    S = adaptive_max
    sub = torch.arange(S, dtype=torch.float32, device=boxes.device)
    gy = torch.clamp(torch.ceil(roi_h / pooled), 1.0, float(S))
    gx = torch.clamp(torch.ceil(roi_w / pooled), 1.0, float(S))

    def axis(start, extent, g):
        off = grid[:, None] + (sub[None, :] + 0.5) / g[..., None, None]
        coords = start[..., None, None] + off * (extent / pooled)[..., None, None]
        valid = sub[None, :] < g[..., None, None]
        return torch.where(valid, coords, torch.full_like(coords, _INVALID_COORD))

    return axis(y1, roi_h, gy), axis(x1, roi_w, gx), gy * gx


def interp_matrix(coords: torch.Tensor, limit: int) -> torch.Tensor:
    """Bilinear interpolation along one axis as a matrix `[..., P, limit]`.

    The Detectron sample at clamped coordinate c is the hat function
    (1 - |c - h|)+ over grid points h; summing the hats of a bin's samples
    gives the row A with pooled = A @ feature along that axis.
    """
    ok = (coords >= -1.0) & (coords <= limit)
    c = torch.clamp(coords, 0.0, limit - 1.0)
    grid = torch.arange(limit, dtype=coords.dtype, device=coords.device)
    hat = torch.clamp(1.0 - (c[..., None] - grid).abs(), min=0.0)
    hat = hat * ok[..., None].to(coords.dtype)
    return hat.sum(dim=-2)


def tube_roi_align_plain(features: torch.Tensor, tubes: torch.Tensor,
                         pooled_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                         sampling_ratio: int = 2) -> torch.Tensor:
    """Batched tube ROI-align as two interpolation contractions (H, then W),
    in float32; the output is cast to the feature dtype.

    features `[B, T', H, W, C]`, tubes `[B, N, T, 4]`
    → `[B, N, T', pooled, pooled, C]`. Slice t' pools the boxes of frame
    `feature_time_indices(T, T')[t']`.
    """
    B, Tp, H, W, C = features.shape
    T = tubes.shape[2]
    t_idx = feature_time_indices(T, Tp, device=tubes.device)
    boxes = tubes[:, :, t_idx]                                  # [B, N, T', 4]
    ys, xs, count = roi_sample_coords(
        boxes, pooled_size, spatial_scale, sampling_ratio,
        adaptive_max=adaptive_max_ratio(H, W, pooled_size))
    Ay = interp_matrix(ys, H)                                   # [B, N, T', P, H]
    Ax = interp_matrix(xs, W)                                   # [B, N, T', P, W]
    if not isinstance(count, float):
        count = count[..., None, None, None]                    # per-ROI counts
    f32 = features.to(torch.float32)
    tmp = torch.einsum("bntph,bthwc->bntpwc", Ay, f32)
    out = torch.einsum("bntqw,bntpwc->bntpqc", Ax, tmp)
    return (out / count).to(features.dtype)


def _tube_roi_align_cpu(features: torch.Tensor, tubes: torch.Tensor, pooled_size: int,
                        spatial_scale: float, sampling_ratio: int) -> torch.Tensor:
    """`step::tube_roi_align`, the forward: on a CPU tensor the plain
    version, on a CUDA tensor `csrc/roi_align.cu`. Each returns a
    contiguous tensor."""
    return tube_roi_align_plain(features, tubes, pooled_size, spatial_scale,
                                sampling_ratio).contiguous()


def _tube_roi_align_fake(features, tubes, pooled_size, spatial_scale, sampling_ratio):
    B, Tp, _, _, C = features.shape
    return features.new_empty((B, tubes.shape[1], Tp, pooled_size, pooled_size, C))


def _tube_roi_align_launch(features, tubes, pooled_size, spatial_scale, sampling_ratio):
    from step_tpu_torch import kernels

    B, Tp, H, W, C = features.shape
    if tubes.device != features.device:
        raise ValueError("tube_roi_align: features and tubes on different devices")
    if tubes.dim() != 4 or tubes.shape[0] != B or tubes.shape[3] != 4:
        raise ValueError(f"tube_roi_align: tubes {tuple(tubes.shape)} is not "
                         f"[{B}, N, T, 4]")
    out = torch.empty((B, tubes.shape[1], Tp, pooled_size, pooled_size, C),
                      dtype=features.dtype, device=features.device)
    kernels.tube_roi_align_forward(features, tubes.to(torch.float32).contiguous(),
                                   out, spatial_scale, sampling_ratio)
    return out


tube_roi_align_op = kernel_op("tube_roi_align", _tube_roi_align_cpu, _tube_roi_align_launch,
                              _tube_roi_align_fake)


class _TubeRoiAlign(torch.autograd.Function):
    @staticmethod
    def forward(ctx, features, tubes, pooled_size, spatial_scale, sampling_ratio):
        ctx.args = (pooled_size, spatial_scale, sampling_ratio)
        ctx.save_for_backward(features, tubes)
        return tube_roi_align_op(features, tubes, *ctx.args)

    @staticmethod
    def backward(ctx, g):
        features, tubes = ctx.saved_tensors
        return (*tube_roi_align_backward(features, tubes, g, *ctx.args,
                                         need=ctx.needs_input_grad[:2]),
                None, None, None)


def tube_roi_align_backward(features: torch.Tensor, tubes: torch.Tensor,
                            g: torch.Tensor, pooled_size: int, spatial_scale: float,
                            sampling_ratio: int, need=(True, False)):
    """(dfeatures, dtubes) for the cotangent g of the output, by autograd
    through `tube_roi_align_plain`; each is None where `need` says so."""
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_(n) for t, n in zip((features, tubes), need)]
        out = tube_roi_align_plain(*inputs, pooled_size, spatial_scale, sampling_ratio)
        grads = iter(torch.autograd.grad(out, [t for t, n in zip(inputs, need) if n], g))
    return tuple(next(grads) if n else None for n in need)


def tube_roi_align(features: torch.Tensor, tubes: torch.Tensor,
                   pooled_size: int = 7, spatial_scale: float = 1.0 / 16.0,
                   sampling_ratio: int = 2) -> torch.Tensor:
    """Tube ROI-align (`tube_roi_align_plain`'s contract).

    A CUDA tensor goes to the hand-written kernel (`csrc/roi_align.cu`,
    which takes the fixed and the adaptive sampling grid, and picks each
    slice's frame of the tubes itself) and a CPU tensor to the plain
    version. When an input requires a gradient, the call goes through
    `_TubeRoiAlign`: the same forward, and autograd through the plain
    version backward (`dfeatures`, and `dtubes` when the tubes require it).
    """
    args = (int(pooled_size), float(spatial_scale), int(sampling_ratio))
    if torch.is_grad_enabled() and (features.requires_grad or tubes.requires_grad):
        return _TubeRoiAlign.apply(features, tubes, *args)
    return tube_roi_align_op(features, tubes, *args)
