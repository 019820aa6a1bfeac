"""MViTv2-B as STEP's backbone: pooling attention with decomposed relative
positions, cut at the end of its stride-16 stage.

The multiscale video transformer of Li et al., 2022 (arXiv:2112.01526;
facebookresearch/SlowFast `configs/Kinetics/MVITv2_B_32x3.yaml`, the
model `MViT` in `slowfast/models`, `attention.py::MultiScaleBlock`,
`MultiScaleAttention`, `attention_pool`, `cal_rel_pos_spatial`,
`cal_rel_pos_temporal`), without its cls token and classifier:

  tokens = Conv3d(x)     3→96, kernel (3, 7, 7), stride (2, 4, 4), padding
                         (1, 3, 3), with bias; no absolute position table
  each block, input width dim, output width dim_out, heads of d:
    xn = LN1(x); q, k, v = qkv(xn)            dim → 3·dim_out, with bias
    q, k, v = LN_*(pool_*(q, k, v))           depthwise Conv3d(d, d, 3x3x3,
                                              padding 1, no bias), one weight
                                              shared by the heads; LN over d
    o = proj(softmax(q·kᵀ/√d + Rel(q))·v + q) residual pooling
    skip = maxpool_(1,3,3)/(1,2,2), pad (0,1,1) of proj_skip(xn) at a
           transition, else x
    x = skip + o;  x += fc2(GELU(fc1(LN2(x))))    MLP width 4·dim_out
  map = out_norm(x) → [B, T', H', W', C]           channels-last

  Rel(q)[(t,i,j), (t',i',j')] = q·R_t[dist(t,t')] + q·R_h[dist(i,i')] +
                                q·R_w[dist(j,j')],
  dist(i, i') = i·max(k/q, 1) − i'·max(q/k, 1) + (k − 1)·max(q/k, 1)
  on the pooled, normed, unscaled query's and the keys' sides q and k.

Stages double the width and the heads at their first block (the
transition, whose query and skip pool at stride (1, 2, 2)); the keys and
values pool at an adaptive stride that starts at the first stage's and is
divided by each query stride. LayerNorm eps 1e-6, exact GELU.

Widths by `backbone_depth`: "full" is MViTv2-B to the end of its third
stage (blocks 0–20: widths 96/192/384, heads 1/2/4, d 96, K/V strides 8,
4, 2; it requires `feature_stride` 16); stage 4 (768 wide, stride 32) is
left out, as STEP's I3D map is Mixed_4f, at the end of its stride-16
stage. "tiny" keeps every kind of block: widths 16/32/64 at d 16, stages of
1, 2 and 2 blocks, K/V stride 4 at the first stage (so the second
transition pools the keys at stride 1 and its query is smaller than its
keys), spatial stride `feature_stride`.

The relative-position tables and their index maps are made for the
configured clip (`num_frames`, `image_size`): a table of a side holds
2·max(q, k) − 1 rows for the pooled query's and keys' sides q and k (SlowFast
sizes them from the input's side over each stride, which is the same where
the strides divide it, as at full depth), the temporal table 2·T' − 1. The
parameter names are SlowFast's under `features.` (`patch_embed.proj`,
`blocks.{i}.norm1`, `attn.qkv`, `attn.proj`, `attn.pool_q|k|v`,
`attn.norm_q|k|v`, `attn.rel_pos_h|w|t`, `norm2`, `mlp.fc1`, `mlp.fc2`,
`blocks.{i}.proj` at a transition), and `out_norm`, the map's LayerNorm.

Attention: Rel(q) is the sum of three broadcast products of q with the
gathered tables, in the compute dtype, passed as `attn_mask` to
`F.scaled_dot_product_attention` at its default scale, whichever backend
PyTorch picks; then `+ q`. The pools run as `F.conv3d(groups=d)` on the
heads' contiguous `[B·h, d, T, H, W]`, each of q, k and v made in that
order by its own GEMM of the qkv weight's rows, and `F.layer_norm`; the skip
pool is `F.max_pool3d` (symmetric padding, not TF-SAME). Spans: `model.stem`
(the patch embedding), and a block's `model.attn_pool` (the three pools and
their norms), `model.attention` (Rel, the attention call, `+ q`) and
`model.mlp` (`vit.Mlp`). Weights follow the activations' dtype (cast per
use), so a float32 tree computes in bfloat16 when its input is.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from step_tpu_torch.models.nets import _linear
from step_tpu_torch.models.vit import LN_EPS, Mlp, layer_norm
from step_tpu_torch.utils.spans import span

NAME = "mvitv2_b"
FEATURE_STRIDE = 16
PATCH_KERNEL, PATCH_PADDING, PATCH_STRIDE_T = (3, 7, 7), (1, 3, 3), 2
POOL_KERNEL = 3
MLP_RATIO = 4
# depth → (first stage's width = head dim, blocks a stage, first stage's K/V stride)
WIDTHS = {"full": (96, (2, 3, 16), 8), "tiny": (16, (1, 2, 2), 4)}


def feature_frames(num_frames: int) -> int:
    """T' of the map: the patch embedding's temporal stride 2 over the
    clip padded by 1 at each end, (T + 2 − 3) // 2 + 1 (9 of 18)."""
    return (num_frames + 2 * PATCH_PADDING[0] - PATCH_KERNEL[0]) // PATCH_STRIDE_T + 1


def pooled(size, stride) -> tuple:
    """The side of a 3x3x3 pool at padding 1 and `stride` on `size`
    (`(n − 1) // s + 1` each axis)."""
    return tuple((n - 1) // s + 1 for n, s in zip(size, stride))


def block_plan(depth: str) -> list:
    """(dim, dim_out, heads, q stride, K/V stride) of every block."""
    width, stages, kv0 = WIDTHS[depth]
    plan, dim = [], width
    for s, blocks in enumerate(stages):
        kv = max(kv0 >> s, 1)
        for b in range(blocks):
            dim_out = width << s
            q = 2 if s > 0 and b == 0 else 1
            plan.append((dim, dim_out, 1 << s, (1, q, q), (1, kv, kv)))
            dim = dim_out
    return plan


def rel_index(q: int, k: int) -> torch.Tensor:
    """`[q, k]` rows of a relative-position table: SlowFast's dist, the
    two sides scaled to the finer one's spacing."""
    q_ratio, k_ratio = max(k / q, 1.0), max(q / k, 1.0)
    dist = (torch.arange(q)[:, None] * q_ratio - torch.arange(k)[None, :] * k_ratio
            + (k - 1) * k_ratio)
    return dist.long()


def rel_pos_bias(q: torch.Tensor, q_size, k_size, tables, index) -> torch.Tensor:
    """Rel(q) `[B, h, Nq, Nkv]` of q `[B, h, Nq, d]` on the query grid
    `q_size` and the key grid `k_size`, (t, h, w) each; `tables` and
    `index` the (t, h, w) tables and their row maps."""
    B, heads, _, d = q.shape
    r = q.reshape(B, heads, *q_size, d)
    rt, rh, rw = (torch.einsum(eq, r, table.to(q.dtype)[i]) for eq, table, i in zip(
        ("bythwc,tkc->bythwk", "bythwc,hkc->bythwk", "bythwc,wkc->bythwk"), tables, index))
    bias = (rt[..., :, None, None] + rh[..., None, :, None]) + rw[..., None, None, :]
    return bias.reshape(B, heads, q.shape[2], math.prod(k_size))


def skip_pool(x: torch.Tensor, size, stride) -> torch.Tensor:
    """SlowFast's `pool_skip` on tokens `[B, N, C]` of the grid `size`: a
    max pool of kernel s + 1 (s where s is 1) at stride s, padded
    symmetrically by half the kernel."""
    B, _, C = x.shape
    kernel = tuple(s + 1 if s > 1 else s for s in stride)
    y = F.max_pool3d(x.reshape(B, *size, C).permute(0, 4, 1, 2, 3), kernel, stride,
                     tuple(k // 2 for k in kernel))
    return y.permute(0, 2, 3, 4, 1).reshape(B, -1, C)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, stride: int):
        super().__init__()
        self.proj = nn.Conv3d(3, dim, PATCH_KERNEL, (PATCH_STRIDE_T, stride, stride),
                              PATCH_PADDING)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x `[B, T, H, W, C]` → the token grid `[B, T', H', W', D]`."""
        p = self.proj
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), p.weight.to(x.dtype), p.bias.to(x.dtype),
                     p.stride, p.padding)
        return y.permute(0, 2, 3, 4, 1)


class MultiScaleAttention(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, q_stride, kv_stride, size):
        super().__init__()
        d = dim_out // heads
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)
        for name, stride in (("q", q_stride), ("k", kv_stride), ("v", kv_stride)):
            setattr(self, f"pool_{name}", nn.Conv3d(d, d, POOL_KERNEL, stride, POOL_KERNEL // 2,
                                                    groups=d, bias=False))
            setattr(self, f"norm_{name}", nn.LayerNorm(d, eps=LN_EPS))
        self.size, self.q_size, self.kv_size = size, pooled(size, q_stride), pooled(size, kv_stride)
        side = 2 * max(self.q_size[1], self.kv_size[1]) - 1
        self.rel_pos_h = nn.Parameter(torch.zeros(side, d))
        self.rel_pos_w = nn.Parameter(torch.zeros(side, d))
        self.rel_pos_t = nn.Parameter(torch.zeros(2 * size[0] - 1, d))
        for axis, name in enumerate("thw"):
            self.register_buffer(f"index_{name}", rel_index(self.q_size[axis],
                                                            self.kv_size[axis]),
                                 persistent=False)

    def _parts(self, x: torch.Tensor) -> list:
        """qkv of LN1's output `[B, N, dim]` as three channel-major parts,
        `[B·h, d, T, H, W]` each, one GEMM of the weight's rows a part: the
        depthwise convs then read contiguous NCDHW, which on the card takes
        PyTorch's depthwise 3-D kernel, where a channels-last input takes
        cuDNN's grouped path, one launch a channel."""
        B, N, dim = x.shape
        w = self.qkv.weight.to(x.dtype).view(3, -1, dim)
        b = self.qkv.bias.to(x.dtype).view(3, -1, 1)
        xt = x.transpose(1, 2)
        return [torch.baddbmm(b[i], w[i].expand(B, -1, -1), xt).view(
                    B * self.heads, -1, *self.size) for i in range(3)]

    def _pool(self, part: torch.Tensor, name: str) -> torch.Tensor:
        """`[B·h, d, T, H, W]` → pooled and normed `[B, h, N', d]`."""
        conv, norm = getattr(self, f"pool_{name}"), getattr(self, f"norm_{name}")
        d = part.shape[1]
        y = F.conv3d(part, conv.weight.to(part.dtype), None, conv.stride, conv.padding, 1, d)
        return layer_norm(norm, y.reshape(-1, self.heads, d, y[0, 0].numel()).transpose(2, 3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """LN1's output `[B, N, dim]` on the grid `size` → `[B, Nq, dim_out]`
        on the grid `q_size`."""
        B = x.shape[0]
        parts = self._parts(x)
        with span("model.attn_pool"):
            q, k, v = (self._pool(part, name) for part, name in zip(parts, "qkv"))
        with span("model.attention"):
            bias = rel_pos_bias(q, self.q_size, self.kv_size,
                                (self.rel_pos_t, self.rel_pos_h, self.rel_pos_w),
                                (self.index_t, self.index_h, self.index_w))
            out = F.scaled_dot_product_attention(q, k, v, attn_mask=bias) + q
        return _linear(self.proj, out.transpose(1, 2).reshape(B, q.shape[2], -1))


class MultiScaleBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, heads: int, q_stride, kv_stride, size):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = MultiScaleAttention(dim, dim_out, heads, q_stride, kv_stride, size)
        self.norm2 = nn.LayerNorm(dim_out, eps=LN_EPS)
        self.mlp = Mlp(dim_out, MLP_RATIO * dim_out)
        self.proj = nn.Linear(dim, dim_out) if dim != dim_out else None
        self.q_stride = q_stride if math.prod(q_stride) > 1 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xn = layer_norm(self.norm1, x)
        out = self.attn(xn)
        if self.proj is not None:
            x = _linear(self.proj, xn)
        if self.q_stride is not None:
            x = skip_pool(x, self.attn.size, self.q_stride)
        x = x + out
        return x + self.mlp(layer_norm(self.norm2, x))


class MViTv2(nn.Module):
    """MViTv2-B to its stride-16 map as the detector's backbone: the
    normalized clip `[B, T, H, W, 3]` → `[B, T', H/16, W/16, 384]`
    (`out_channels`). `num_frames` and `image_size` fix the relative
    positions' tables."""

    def __init__(self, depth: str, feature_stride: int, num_frames: int, image_size: int):
        super().__init__()
        if depth not in WIDTHS:
            raise ValueError(f"unknown backbone depth {depth!r}")
        if depth == "full" and feature_stride != FEATURE_STRIDE:
            raise ValueError(f"{NAME} at full depth has spatial stride {FEATURE_STRIDE}, "
                             f"the config asks for feature_stride={feature_stride}")
        plan = block_plan(depth)
        transitions = sum(q[1] > 1 for *_, q, _ in plan)
        stride = feature_stride >> transitions
        self.patch_embed = PatchEmbed(plan[0][0], stride)
        side = (image_size - 1) // stride + 1
        size = (feature_frames(num_frames), side, side)
        self.blocks = nn.ModuleList()
        for dim, dim_out, heads, q_stride, kv_stride in plan:
            self.blocks.append(MultiScaleBlock(dim, dim_out, heads, q_stride, kv_stride, size))
            size = pooled(size, q_stride)
        self.out_channels = plan[-1][1]
        self.out_norm = nn.LayerNorm(self.out_channels, eps=LN_EPS)

    def forward(self, x: torch.Tensor, chunks: int | None = None, train: bool = False,
                flow: torch.Tensor | None = None) -> torch.Tensor:
        """`FeatureNet`'s signature. `chunks`, `train` and `flow` change
        nothing: the detector refuses chunk stems and flow with this
        backbone, and it has no BatchNorm and no dropout."""
        with span("model.stem"):
            grid = self.patch_embed(x)
        B, *size, C = grid.shape
        if tuple(size) != self.blocks[0].attn.size:
            raise ValueError(f"a clip of {'x'.join(map(str, x.shape[1:4]))} makes a "
                             f"{'x'.join(map(str, size))} grid; the relative positions "
                             f"were made for {'x'.join(map(str, self.blocks[0].attn.size))}")
        x = grid.reshape(B, -1, C)
        for block in self.blocks:
            x = block(x)
        size = self.blocks[-1].attn.q_size
        return layer_norm(self.out_norm, x).reshape(B, *size, self.out_channels)
