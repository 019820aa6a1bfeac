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
package (`step_tpu/models/detector.py:115-119, 232-236`); so is
`chunk_stem`, the stem run on each chunk alone (`nets.FeatureNet`). The
TPU-only variants of the reference (`stem_s2d`, `conv3d_impl`, `roi_impl`,
`scan_unroll`, `scan_broadcast_inputs`, `head_compact`, `nms_impl`)
compute the same function by other means and are ignored. `cfg.reg_head`
picks the heads' box regression: "grid" or the reference's "frame_fc"
(`nets.TwoBranchHead`), whose Dense is sized by `feature_frames(cfg)`.

The inputs (:207-248): `cfg.input_stream` "rgb" reads uint8 or [0, 1]
RGB (`device_preprocess`), "flow" makes 2-channel int8 or [-1, 1] flow the
primary input (`device_preprocess_flow`; the late-fusion protocol's flow
detector). `cfg.two_stream` takes flow as a second input beside the RGB,
through a second stem and the fusion unit (`nets.FeatureNet`). Each input
is normalized in float32 and then cast to `cfg.compute_dtype`.

`cfg.backbone` picks the backbone (`BACKBONES`): "i3d", `nets.FeatureNet`
with every variant above, "videomae_vit_b16", the ViT-B/16 of
`models/vit.py`, "mvitv2_b", MViTv2-B to its stride-16 stage
(`models/mvit.py`), or "swin3d_b", Video Swin-B to its stride-16 stage
(`models/swin.py`); the three transformers attend over the whole clip, so
they take no chunk stems, no second stream and no flow input. An unknown
name is refused. The heads'
I3D tails take the backbone's channels on its T' slices (`feature_frames`).

`forward` is `stem` (normalize, backbone) then `refine` (context, the S
steps); the streaming entry points of `inference.py` call the two apart.

Training (`train=True`): BatchNorm on the batch statistics and the heads'
dropouts, except in the subtrees `cfg.freeze_submodules` names, which run
in eval mode as the JAX package's do (`step_tpu/models/detector.py:
150-152, :269-270`). The tubes stay detached between steps (`:142`). With
`cfg.remat_steps` each step body runs under `torch.utils.checkpoint`
(`:173-176`): `remat_policy="full"` recomputes it whole in the backward,
`"dots"` keeps the outputs of the convolutions and matrix products and
recomputes the rest (`checkpoint_dots`). Dropout masks are drawn before
the checkpointed body, so its recomputation applies the same masks.
"""

from __future__ import annotations

import functools

import torch
import torch.nn as nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from step_tpu_torch.config import StepConfig
from step_tpu_torch.models import mvit, swin, vit
from step_tpu_torch.models.nets import (CONTEXT_DIM, ContextNet, FeatureNet,
                                        TwoBranchHead, draw_dropout_masks)
from step_tpu_torch.ops.roi_align import feature_time_indices, tube_roi_align
from step_tpu_torch.preprocess import device_preprocess, device_preprocess_flow
from step_tpu_torch.tubes.boxes import clip_boxes, decode_boxes
from step_tpu_torch.tubes.proposals import initial_cuboids
from step_tpu_torch.tubes.tube_ops import chunk_frame_mask, extrapolate_tubes
from step_tpu_torch.utils.spans import span


# The operations whose outputs `remat_policy="dots"` keeps: convolutions and
# matrix products, as jax.checkpoint_policies.checkpoint_dots keeps dots.
_DOTS = frozenset(op for op in (
    torch.ops.aten.convolution.default, torch.ops.aten.mm.default,
    torch.ops.aten.addmm.default, torch.ops.aten.bmm.default))


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _i3d_frames(cfg: StepConfig) -> int:
    chunks = cfg.num_chunks if cfg.chunk_stem else 1
    half = lambda n: -(-n // 2)  # noqa: E731
    return chunks * half(half(cfg.total_frames // chunks))


def _i3d(cfg: StepConfig) -> nn.Module:
    return FeatureNet(cfg.backbone_depth, cfg.bn_folded, cfg.fused_bn_relu,
                      cfg.fused_inception, cfg.fused_inception3 == "all",
                      cfg.chunk_stem, cfg.num_chunks, cfg.two_stream,
                      3 if cfg.input_stream == "rgb" else 2)


def _whole_clip(net):
    """The constructor of a transformer `net` (`vit.VideoMAEViT`,
    `mvit.MViTv2`, `swin.SwinTransformer3D`): attention over one whole RGB
    clip has no per-chunk form and no second stream."""
    def build(cfg: StepConfig) -> nn.Module:
        for refused, why in ((cfg.chunk_stem, "chunk_stem"), (cfg.two_stream, "two_stream"),
                             (cfg.input_stream != "rgb", f"input_stream={cfg.input_stream!r}")):
            if refused:
                raise ValueError(f"{cfg.backbone} attends jointly over one whole RGB clip: "
                                 f"{why} is refused")
        return net(cfg.backbone_depth, cfg.feature_stride, cfg.total_frames, cfg.image_size)
    return build


# `cfg.backbone` → (the builder of the shared feature map's backbone, its T')
BACKBONES = {"i3d": (_i3d, _i3d_frames),
             vit.NAME: (_whole_clip(vit.VideoMAEViT),
                        lambda cfg: vit.feature_frames(cfg.total_frames)),
             mvit.NAME: (_whole_clip(mvit.MViTv2),
                         lambda cfg: mvit.feature_frames(cfg.total_frames)),
             swin.NAME: (_whole_clip(swin.SwinTransformer3D),
                         lambda cfg: swin.feature_frames(cfg.total_frames))}


def feature_frames(cfg: StepConfig) -> int:
    """T', the time axis of the shared feature map, by the backbone's
    temporal stride. I3D halves time twice (Conv3d_1a and MaxPool_4a,
    TF-SAME), on the whole clip or on each chunk under `chunk_stem` (5 on
    `ucf_3step`, 6 with chunk stems); the ViT takes one slice a tubelet of
    2 frames (9 of 18); MViTv2's patch embedding strides 2 over the clip
    padded by a frame at each end, (T + 2 − 3) // 2 + 1 (9 of 18); Video
    Swin's pads the clip to a multiple of 2 frames, ⌈T/2⌉ (9 of 18)."""
    return BACKBONES[cfg.backbone][1](cfg)


class STEPDetector(nn.Module):
    """Full detector: backbone + context + S-step progressive refinement."""

    def __init__(self, cfg: StepConfig):
        super().__init__()
        if cfg.input_stream not in ("rgb", "flow"):
            raise ValueError(f"unknown input_stream {cfg.input_stream!r}")
        if cfg.backbone not in BACKBONES:
            raise ValueError(f"unknown backbone {cfg.backbone!r}; "
                             f"known: {', '.join(BACKBONES)}")
        self.cfg = cfg
        variants = (cfg.bn_folded, cfg.fused_bn_relu, cfg.fused_inception)
        self.features = BACKBONES[cfg.backbone][0](cfg)
        c = self.features.out_channels
        self.context = ContextNet(c) if cfg.use_context else None
        ctx_dim = CONTEXT_DIM if cfg.use_context else 0
        self.steps = nn.ModuleList(
            TwoBranchHead(c, cfg.num_cls_outputs, cfg.total_frames,
                          cfg.pooled_size, cfg.backbone_depth, cfg.bn_folded,
                          ctx_dim, *variants[1:],
                          cfg.fused_inception3 in ("tail", "all"),
                          cfg.dropout_rate, cfg.reg_head, feature_frames(cfg))
            for _ in range(cfg.num_steps))
        self.data_shard = None      # (rank, world) in a data-parallel train step

    def forward(self, rgb: torch.Tensor, proposals: torch.Tensor,
                flow: torch.Tensor | None = None, train: bool = False,
                generator: torch.Generator | None = None):
        """rgb `[B, T, H, W, 3]` uint8 (or float in [0, 1]), or, for a
        flow-input detector, flow `[B, T, H, W, 2]` int8 (or float in [-1,
        1]); proposals `[B, P, T, 4]`; `flow`, the second stream of a
        two-stream detector. Returns a dict of per-step outputs stacked on
        a leading S axis: cls_logits `[S, B, P, ncls]`, deltas, proposals
        (the anchors of each step) and tubes `[S, B, P, T, 4]`, frame_mask
        `[S, T]`. `train` and `generator` as `refine` takes them."""
        feat = self.stem(rgb, train=train, flow=flow)
        return self.refine(feat, proposals, train, generator)

    def stem(self, rgb: torch.Tensor, chunks: int | None = None,
             train: bool = False, flow: torch.Tensor | None = None) -> torch.Tensor:
        """The primary input `[B, T, H, W, 3 or 2]` (and `flow` with two
        stems) → the shared feature map `[B, T', H', W', C]`,
        channels-last. Normalizes in float32 and computes in
        cfg.compute_dtype; `chunks` as `FeatureNet.forward` takes it;
        `train` runs the backbone in train mode unless it is frozen."""
        cfg = self.cfg
        dtype = getattr(torch, cfg.compute_dtype)
        train = train and "features" not in cfg.freeze_submodules
        with span("model.preprocess"):
            x = (device_preprocess(rgb) if cfg.input_stream == "rgb"
                 else device_preprocess_flow(rgb)).to(dtype)
            if flow is not None:
                flow = device_preprocess_flow(flow).to(dtype)
        with span("model.backbone"):
            return self.features(x, chunks, train, flow)

    def refine(self, feat: torch.Tensor, proposals: torch.Tensor,
               train: bool = False, generator: torch.Generator | None = None):
        """The scene context and the S refinement steps on a feature map
        `[B, T', H', W', C]` from `stem`; returns what `forward` returns.

        `train` runs the heads in train mode (unless `steps` is frozen):
        train-mode BatchNorm, and with `cfg.dropout_rate` > 0 dropout masks
        drawn from `generator`, which is then required."""
        with span("model.refine"):
            cfg = self.cfg
            train = train and "steps" not in cfg.freeze_submodules
            drop = train and cfg.dropout_rate > 0
            if drop and generator is None:
                raise ValueError("training with dropout needs a torch.Generator "
                                 "for its masks (generator=...)")
            remat = None
            if train and cfg.remat_steps:
                context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                                _save_dots)
                              if cfg.remat_policy == "dots" else None)
                kw = {"context_fn": context_fn} if context_fn else {}
                remat = functools.partial(checkpoint, use_reentrant=False, **kw)
            ctx = None
            if self.context is not None:
                with span("model.context"):
                    ctx = self.context(feat)
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
                masks = (self._dropout_masks(head, B, P, feat.shape[1], generator, feat.device)
                         if drop else None)
                args = (head, feat, tubes, ctx_flat, fmask, t_idx, train, masks)
                cls_logits, deltas, filled = (remat(self._step, *args) if remat
                                              else self._step(*args))
                for key, value in (("cls_logits", cls_logits), ("deltas", deltas),
                                   ("proposals", tubes), ("tubes", filled),
                                   ("frame_mask", fmask)):
                    outputs[key].append(value)
                tubes = filled.detach()
            return {k: torch.stack(v) for k, v in outputs.items()}

    def _dropout_masks(self, head, B, P, Tp, generator, device):
        """A step's dropout keep-masks for B clips of P tubes. In a
        data-parallel step (`data_shard` = (rank, world)) the masks of the
        global batch are drawn and the rank keeps its rows, `rank::world`,
        so every rank draws what one process would on the global batch."""
        rank, world = self.data_shard or (0, 1)
        masks = draw_dropout_masks(head.dropout_shapes(B * world * P, Tp),
                                   self.cfg.dropout_rate, generator, device)
        if world == 1:
            return masks
        return tuple(m.reshape(B * world, P, *m.shape[1:])[rank::world]
                     .reshape(B * P, *m.shape[1:]) for m in masks)

    def _step(self, head, feat, tubes, ctx_flat, fmask, t_idx, train, masks):
        """One refinement step: pool the tubes, run the head, decode, clip
        and extend in time → (cls_logits `[B, P, ncls]`, deltas `[B, P, T,
        4]`, the refined tubes `[B, P, T, 4]`)."""
        cfg = self.cfg
        B, P, T = tubes.shape[:3]
        pooled = tube_roi_align(feat, tubes, cfg.pooled_size,
                                1.0 / cfg.feature_stride, cfg.sampling_ratio)
        pooled = pooled.reshape(B * P, *pooled.shape[2:])  # [B*P, T', 7, 7, C]
        with span("model.head"):
            cls_logits, deltas = head(pooled, ctx_flat, fmask[t_idx], train, masks)
        cls_logits = cls_logits.reshape(B, P, -1)
        deltas = deltas.reshape(B, P, T, 4)
        with span("model.boxes"):
            decoded = decode_boxes(deltas, tubes, cfg.box_variances)
            decoded = clip_boxes(decoded, cfg.image_size, cfg.image_size)
            filled = extrapolate_tubes(decoded * fmask[:, None], fmask,
                                       float(cfg.image_size))
        return cls_logits, deltas, filled

    @staticmethod
    def initial_proposals(cfg: StepConfig, batch_size: int, device="cuda"):
        """`[B, P, T, 4]` initial cuboids and the `[B, P]` validity mask, on
        the card unless the caller asks for another device."""
        tubes, mask = initial_cuboids(cfg.image_size, cfg.total_frames,
                                      cfg.max_proposals, cfg.cuboid_layout,
                                      device=device)
        return (tubes[None].expand(batch_size, *tubes.shape),
                mask[None].expand(batch_size, mask.shape[0]))
