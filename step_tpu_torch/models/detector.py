"""STEPDetector — backbone, scene context and the progressive refinement.

Port of `step_tpu/models/detector.py`. The JAX package scans one step body
(`_StepBody`, :41-153) over per-step parameters stacked on axis 0; here
the S per-step heads are an `nn.ModuleList` and the steps a Python loop:

    for step s:
      frame_mask_s = chunk activity for step s (temporal extension 6 → 18)
      pooled       = tube ROI-align of the tubes on the shared feature map
      cls, deltas  = head_s(pooled, context, active feature slices)
      decoded      = clip(decode(deltas, tubes)) on the active frames
      tubes        = linear-motion extrapolation into the inactive frames

The inference variants `fused_bn_relu`, `fused_inception` and
`fused_inception3` are carried over (`models/i3d.py`): the stem takes
`fused_inception3 == "all"`, the heads `"tail"` or `"all"`, as in the JAX
package (`step_tpu/models/detector.py:115-119, 232-236`). The TPU-only
variants of the reference (`stem_s2d`, `conv3d_impl`, `roi_impl`,
`scan_unroll`, `scan_broadcast_inputs`, `head_compact`, `nms_impl`)
compute the same function by other means and are ignored. Two-stream
input, `chunk_stem`, the flow-input detector and the "frame_fc" regression
head are not ported yet.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from step_tpu_torch.config import StepConfig
from step_tpu_torch.models.nets import (CONTEXT_DIM, ContextNet, FeatureNet,
                                        TwoBranchHead)
from step_tpu_torch.ops.roi_align import feature_time_indices, tube_roi_align
from step_tpu_torch.preprocess import device_preprocess
from step_tpu_torch.tubes.boxes import clip_boxes, decode_boxes
from step_tpu_torch.tubes.proposals import initial_cuboids
from step_tpu_torch.tubes.tube_ops import chunk_frame_mask, extrapolate_tubes


def _check_supported(cfg: StepConfig) -> None:
    unported = {
        "two_stream": cfg.two_stream,
        "chunk_stem": cfg.chunk_stem,
        "input_stream='flow'": cfg.input_stream != "rgb",
        "reg_head='frame_fc'": cfg.reg_head != "grid",
    }
    missing = [name for name, on in unported.items() if on]
    if missing:
        raise NotImplementedError(f"not ported yet: {', '.join(missing)}")


class STEPDetector(nn.Module):
    """Full detector: backbone + context + S-step progressive refinement."""

    def __init__(self, cfg: StepConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        variants = (cfg.bn_folded, cfg.fused_bn_relu, cfg.fused_inception)
        self.features = FeatureNet(cfg.backbone_depth, *variants,
                                   cfg.fused_inception3 == "all")
        c = self.features.out_channels
        self.context = ContextNet(c) if cfg.use_context else None
        ctx_dim = CONTEXT_DIM if cfg.use_context else 0
        self.steps = nn.ModuleList(
            TwoBranchHead(c, cfg.num_cls_outputs, cfg.total_frames,
                          cfg.pooled_size, cfg.backbone_depth, cfg.bn_folded,
                          ctx_dim, *variants[1:],
                          cfg.fused_inception3 in ("tail", "all"))
            for _ in range(cfg.num_steps))

    def forward(self, rgb: torch.Tensor, proposals: torch.Tensor):
        """rgb `[B, T, H, W, 3]` uint8 (or float in [0, 1]); proposals
        `[B, P, T, 4]`. Returns a dict of per-step outputs stacked on a
        leading S axis: cls_logits `[S, B, P, ncls]`, deltas, proposals
        (the anchors of each step) and tubes `[S, B, P, T, 4]`, frame_mask
        `[S, T]`."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        # Normalize in float32, compute in cfg.compute_dtype. The permuted
        # view is NCDHW in channels_last_3d memory order.
        x = device_preprocess(rgb).to(dtype).permute(0, 4, 1, 2, 3)
        feat = self.features(x)                                 # [B, C, T', H', W']
        ctx = self.context(feat) if self.context is not None else None
        feat = feat.permute(0, 2, 3, 4, 1).contiguous()         # [B, T', H', W', C]

        tubes = proposals.to(torch.float32)
        B, P, T = tubes.shape[:3]
        if T != cfg.total_frames:
            raise ValueError(f"proposals cover {T} frames, config {cfg.total_frames}")
        t_idx = feature_time_indices(T, feat.shape[1], device=tubes.device)
        ctx_flat = (None if ctx is None
                    else ctx[:, None].expand(B, P, ctx.shape[-1]).reshape(B * P, -1))
        outputs = {k: [] for k in ("cls_logits", "deltas", "proposals",
                                   "tubes", "frame_mask")}
        for step, head in enumerate(self.steps):
            fmask = chunk_frame_mask(step, cfg.num_chunks, cfg.frames_per_chunk,
                                     cfg.temporal_extension, device=tubes.device)
            pooled = tube_roi_align(feat, tubes, cfg.pooled_size,
                                    1.0 / cfg.feature_stride, cfg.sampling_ratio)
            pooled = pooled.reshape(B * P, *pooled.shape[2:])  # [B*P, T', 7, 7, C]
            cls_logits, deltas = head(pooled, ctx_flat, fmask[t_idx])
            cls_logits = cls_logits.reshape(B, P, -1)
            deltas = deltas.reshape(B, P, T, 4)

            decoded = decode_boxes(deltas, tubes, cfg.box_variances)
            decoded = clip_boxes(decoded, cfg.image_size, cfg.image_size)
            filled = extrapolate_tubes(decoded * fmask[:, None], fmask,
                                       float(cfg.image_size))
            for key, value in (("cls_logits", cls_logits), ("deltas", deltas),
                               ("proposals", tubes), ("tubes", filled),
                               ("frame_mask", fmask)):
                outputs[key].append(value)
            tubes = filled.detach()
        return {k: torch.stack(v) for k, v in outputs.items()}

    @staticmethod
    def initial_proposals(cfg: StepConfig, batch_size: int, device="cuda"):
        """`[B, P, T, 4]` initial cuboids and the `[B, P]` validity mask, on
        the card unless the caller asks for another device."""
        tubes, mask = initial_cuboids(cfg.image_size, cfg.total_frames,
                                      cfg.max_proposals, cfg.cuboid_layout,
                                      device=device)
        return (tubes[None].expand(batch_size, *tubes.shape),
                mask[None].expand(batch_size, mask.shape[0]))
