"""Detection networks: feature extractor, scene context, two-branch head.

Port of `step_tpu/models/nets.py`: `FeatureNet` (the I3D stem over the
whole clip or, with `chunk_stem`, over each chunk alone; two-stream with
a flow stem and a 1x1x1 fusion unit, :32-81),
`ContextNet` (:84-97) and `TwoBranchHead` with the "grid" and "frame_fc"
regression heads (:100-206).

Training passes `train=True` down the backbone and the heads (train-mode
BatchNorm, `models/i3d.py`). The head's dropouts (`step_tpu/models/nets.py:154, :196`)
take keep-masks drawn beforehand by `draw_dropout_masks` from a
`torch.Generator` the caller owns, so that a step body that
`torch.utils.checkpoint` runs again applies the same masks: checkpoint
restores only the default generators. The masks are Bernoulli draws with
flax's rule (`keep = uniform < 1 - rate`, kept values divided by
`1 - rate`), from torch's generator, so they are not JAX's masks.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from step_tpu_torch.models.i3d import I3DStem, I3DTail, Unit3D
from step_tpu_torch.ops.inception import conv1x1x1_bias_relu

EPS = 1e-6
CONTEXT_DIM = 256
REG_CHANNELS = 64     # 1x1x1 reduction before the regression Dense
FUSION_CHANNELS = 832  # the two-stream fusion unit's output (`nets.py:79`)


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


def draw_dropout_masks(shapes, rate: float, generator: torch.Generator,
                       device=None):
    """Boolean keep-masks of the given shapes, each element kept with
    probability 1 - `rate`, drawn from `generator` in order."""
    return tuple(torch.rand(shape, generator=generator, device=device) < 1.0 - rate
                 for shape in shapes)


def _dropout(x: torch.Tensor, keep: torch.Tensor | None, rate: float) -> torch.Tensor:
    """flax's dropout with a given keep-mask: x / (1 - rate) where kept,
    else 0; no mask, no dropout."""
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class FeatureNet(nn.Module):
    """Shared backbone features: the I3D stem of the primary input,
    channels-last `[B, T, H, W, in_channels]` → `[B, T', H', W', C]`.

    `two_stream` adds a second stem, `stem_flow`, on 2-channel flow; the
    two stems' features concatenate on the channels, RGB first, and the
    `fusion` unit (a 1x1x1 `Unit3D` to 832 channels, with BN and ReLU)
    mixes them (:64-81), so C is 832 at either depth.

    With `chunk_stem` the stems run on each of the clip's `num_chunks`
    chunks alone (the reference's BaseNet: no receptive field across a
    chunk border), the chunks folded into the batch, and the per-chunk
    features concatenate on T'. The streaming cache relies on it: a
    chunk's features are the same in every clip that holds the chunk.
    The fusion unit is pointwise in space and time, so it runs on the
    folded features.
    """

    def __init__(self, depth: str = "full", bn_folded: bool = False,
                 fused_bn_relu: bool = False, fused_inception: bool = False,
                 fused_inception3: bool = False, chunk_stem: bool = False,
                 num_chunks: int = 1, two_stream: bool = False, in_channels: int = 3):
        super().__init__()
        variants = (depth, bn_folded, fused_bn_relu, fused_inception, fused_inception3)
        self.stem_rgb = I3DStem(*variants, in_channels=in_channels)
        self.out_channels = self.stem_rgb.out_channels
        self.stem_flow = self.fusion = None
        if two_stream:
            self.stem_flow = I3DStem(*variants, in_channels=2)
            self.fusion = Unit3D(2 * self.out_channels, FUSION_CHANNELS, (1, 1, 1),
                                 bn_folded=bn_folded, fused_bn_relu=fused_bn_relu)
            self.out_channels = FUSION_CHANNELS
        self.chunks = num_chunks if chunk_stem else 1

    def forward(self, x: torch.Tensor, chunks: int | None = None,
                train: bool = False, flow: torch.Tensor | None = None) -> torch.Tensor:
        """x `[B, T, H, W, in_channels]`, normalized; `chunks` overrides the
        number of independent chunks the clip folds into (1: the clip is
        one chunk, as the streaming cache stems a single chunk); `train`
        runs the BatchNorms on the batch statistics; `flow` `[B, T, H, W,
        2]`, normalized, is the second stream, required with two stems."""
        B, T = x.shape[:2]
        k = self.chunks if chunks is None else chunks
        if T % k:
            raise ValueError(f"{T} frames do not split into {k} chunks")

        # The fold and the unfold are views of NDHWC memory, and so is the
        # NCDHW permute: the backbone runs in channels_last_3d order.
        def fold(v):
            return v.reshape(B * k, T // k, *v.shape[2:]).permute(0, 4, 1, 2, 3)

        feat = self.stem_rgb(fold(x), train)
        if self.stem_flow is not None:
            if flow is None:
                raise ValueError("two_stream=True requires a flow input")
            feat = torch.cat([feat, self.stem_flow(fold(flow), train)], dim=1)
            feat = self.fusion(feat, train)
        feat = feat.permute(0, 2, 3, 4, 1).contiguous()
        return feat.reshape(B, k * feat.shape[1], *feat.shape[2:])


class ContextNet(nn.Module):
    """Global scene context: the mean of the channels-last feature map over
    time and space, projected and rectified, `[B, T', H', W', C]` →
    `[B, CONTEXT_DIM]`."""

    def __init__(self, cin: int):
        super().__init__()
        self.proj = nn.Linear(cin, CONTEXT_DIM)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return F.relu(_linear(self.proj, feat.mean(dim=(1, 2, 3))))


class TwoBranchHead(nn.Module):
    """One refinement step's head.

    Classification: I3D tail → spatial mean → mean over the active feature
    slices → (concat context) → dropout → logits. Regression, `reg_head`
    "grid": I3D tail → 1x1x1 reduction to `REG_CHANNELS` → ReLU → dropout →
    Dense(4) over the flattened 7x7 grid of each slice → linear temporal
    resize from T' to T frames. "frame_fc", the reference's 4·T FC
    (:161-177): the same reduction and ReLU, each tube flattened in (T', h,
    w, c) order, dropout, one Dense to all 4·T deltas; no resize. Its input
    width T'·7·7·64 is fixed at construction, so it takes `num_tprime`, the
    feature map's T' (flax infers it at init).

    Where the tail runs its blocks as `step::inception_block`
    (`I3DTail.block_kernel`), the reduction and its ReLU run as one
    `step::conv1x1x1_bias_relu` on the same GEMM (`ops/inception.py`).
    """

    def __init__(self, cin: int, num_cls_outputs: int, num_frames: int,
                 pooled_size: int = 7, depth: str = "full",
                 bn_folded: bool = False, ctx_dim: int = 0,
                 fused_bn_relu: bool = False, fused_inception: bool = False,
                 fused_inception3: bool = False, dropout_rate: float = 0.3,
                 reg_head: str = "grid", num_tprime: int | None = None):
        super().__init__()
        if reg_head not in ("grid", "frame_fc"):
            raise ValueError(f"unknown reg_head {reg_head!r}")
        if reg_head == "frame_fc" and num_tprime is None:
            raise ValueError("reg_head='frame_fc' needs num_tprime, the feature map's T'")
        self.num_frames = num_frames
        self.pooled_size = pooled_size
        self.dropout_rate = dropout_rate
        self.reg_head = reg_head
        self.num_tprime = num_tprime
        self.tail = I3DTail(cin, depth, bn_folded, fused_bn_relu,
                            fused_inception, fused_inception3)
        c = self.tail.out_channels
        self.cls = nn.Linear(c + ctx_dim, num_cls_outputs)
        self.reg_reduce = nn.Conv3d(c, REG_CHANNELS, (1, 1, 1))
        self._reduce_weight = {}    # the GEMM's weight layout, reused
        grid = pooled_size * pooled_size * REG_CHANNELS
        self.reg = (nn.Linear(grid, 4) if reg_head == "grid"
                    else nn.Linear(num_tprime * grid, 4 * num_frames))

    def dropout_shapes(self, N: int, Tp: int):
        """The shapes of the classification and regression dropout masks
        for N pooled tubes of T' slices."""
        grid = self.pooled_size * self.pooled_size * REG_CHANNELS
        return ((N, self.cls.in_features),
                (N, Tp, grid) if self.reg_head == "grid" else (N, Tp * grid))

    def forward(self, pooled: torch.Tensor, ctx: torch.Tensor | None = None,
                tprime_mask: torch.Tensor | None = None, train: bool = False,
                keep_masks=None):
        """pooled `[N, T', P, P, C]` channels-last; ctx `[N, D]`;
        tprime_mask `[T']` → (cls_logits `[N, ncls]`, deltas `[N, T, 4]`),
        both float32. `train` runs the tail's BatchNorms on the batch
        statistics; `keep_masks`, the two masks of `dropout_shapes` (from
        `draw_dropout_masks`), apply the dropouts."""
        N, Tp = pooled.shape[0], pooled.shape[1]
        keep_cls, keep_reg = keep_masks if keep_masks is not None else (None, None)
        x = pooled.permute(0, 4, 1, 2, 3)
        kernel = self.tail.block_kernel(x, train)
        x = self.tail(x, train)                                 # [N, C, T', P, P]

        spatial = x.mean(dim=(3, 4))                            # [N, C, T']
        if tprime_mask is None:
            cls_feat = spatial.mean(dim=2)
        else:
            w = tprime_mask.to(spatial.dtype)
            w = w / torch.clamp(w.sum(), min=EPS)
            cls_feat = torch.einsum("nct,t->nc", spatial, w)
        if ctx is not None:
            cls_feat = torch.cat([cls_feat, ctx.to(cls_feat.dtype)], dim=-1)
        cls_logits = _linear(self.cls, _dropout(cls_feat, keep_cls, self.dropout_rate))

        if kernel:
            r = conv1x1x1_bias_relu(x, self.reg_reduce.weight, self.reg_reduce.bias,
                                    self._reduce_weight)
        else:
            r = F.relu(F.conv3d(x, self.reg_reduce.weight.to(x.dtype),
                                self.reg_reduce.bias.to(x.dtype)))
        # The JAX head flattens each slice's grid in (h, w, c) order, so the
        # channels move last before the reshape.
        r = r.permute(0, 2, 3, 4, 1)
        if self.reg_head == "frame_fc":
            if Tp != self.num_tprime:
                raise ValueError(f"frame_fc head built for T'={self.num_tprime}, "
                                 f"pooled features have T'={Tp}")
            r = _dropout(r.reshape(N, -1), keep_reg, self.dropout_rate)
            deltas = _linear(self.reg, r).to(torch.float32)
            return cls_logits.to(torch.float32), deltas.reshape(N, self.num_frames, 4)
        r = r.reshape(N, Tp, -1)
        r = _dropout(r, keep_reg, self.dropout_rate)
        deltas = _linear(self.reg, r).to(torch.float32)        # [N, T', 4]
        # jax.image.resize "linear" == F.interpolate(align_corners=False).
        deltas = F.interpolate(deltas.transpose(1, 2), size=self.num_frames,
                               mode="linear", align_corners=False)
        return cls_logits.to(torch.float32), deltas.transpose(1, 2)
