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

Attention: Rel(q) rides in the channels, with no `[B, h, Nq, Nkv]` bias.
Each term depends on one query and one coordinate of the key, so q′ = [q,
√d·(q·R_t rows, q·R_h rows), √d·(q·R_w rows), 0] and k′ = [k, one-hot(t′),
one-hot(i′), one-hot(j′), 0] give q′·k′ᵀ/√d = q·kᵀ/√d + Rel(q) exactly:
one `F.scaled_dot_product_attention` call with no mask at the scale 1/√d of
q's width, v as it is (cuDNN's attention on the card takes a narrower v),
then `+ q`. The t and h terms of a query are one batched GEMM of q in place
against its (t, i)'s gathered table rows, the w terms one of q read as the
`[W, B·h·T·H, d]` batch its strides are; their channels are rounded up to 8
and the whole width to d + a multiple of 32 (128, and 160 at the two
transitions), on an H100 faster than the narrowest widths (120, 136). The
keys' one-hots are a buffer made once; `LAUNCHES["packed_attention"]`
(`ops/kernel_op.py`) counts the calls.

The pools: one GEMM makes q, k and v as the token-major `[B, N, 3·dim_out]`
(`_linear(qkv)`), and each part is pooled and normed by one call of
`ops/attn_pool.py::attn_pool` (`step::attn_pool`, counted in
`LAUNCHES["attn_pool"]`, 63 a full-depth request): on the card the
hand-written `csrc/attn_pool.cu`, which reads the part in place and applies
the LayerNorm to the conv's float32 sums; on the CPU its plain version,
`F.conv3d(groups=d)` and `F.layer_norm` in float32. The skip pool is
`F.max_pool3d` (symmetric padding, not TF-SAME). Spans: `model.stem`
(the patch embedding), and a block's `model.attn_pool` (the three pools and
their norms), `model.attention` (the packing, the attention call, `+ q`) and
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
from step_tpu_torch.ops.attn_pool import attn_pool
from step_tpu_torch.ops.kernel_op import LAUNCHES
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


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _th_channels(k_size) -> int:
    """The channels of the t and h terms side by side: kt + kh rounded up
    to 8, where the w terms start."""
    return _round_up(k_size[0] + k_size[1], 8)


def term_rows(index, lengths, k_size, channels: int) -> tuple:
    """Rows of the joined table `[R_t; R_h; R_w; 0]` (the tables of
    `lengths` rows, then one zero row) that give each query its terms: the
    t and h terms side by side, `[T, H, ct]` for ct = kt + kh rounded up to
    8, and the w terms `[W, channels − ct]`, padded with the zero row;
    `index` the tables' (t, h, w) row maps."""
    (kt, kh, kw), (it, ih, iw) = k_size, index
    zero, ct = sum(lengths), _th_channels(k_size)
    th = torch.cat([it[:, None].expand(-1, len(ih), -1),
                    ih[None].expand(len(it), -1, -1) + lengths[0]], -1)
    return (F.pad(th, (0, ct - kt - kh), value=zero),
            F.pad(iw + lengths[0] + lengths[1], (0, channels - ct - kw), value=zero))


def rel_terms(q: torch.Tensor, q_size, tables, rows, scale: float = 1.0) -> tuple:
    """Rel(q)'s terms of q `[B, h, Nq, d]` on the query grid `q_size`, times
    `scale`: q·R_t[index_t[t]] and q·R_h[index_h[i]] side by side, and
    q·R_w[index_w[j]], for the query at (t, i, j), `[B, h, Nq, ct]` and
    `[B, h, Nq, cw]` with zeros after the terms; `rows` their `term_rows`
    in the joined `tables` (scaled in the tables' dtype before the cast to
    q's, one rounding). The t and h terms are one batched product of q in
    place, `[B·h·T·H, W, d]`, against its (t, i)'s rows; the w term, whose
    rows change along the innermost axis, reads q as the `[W, B·h·T·H, d]`
    batch its strides already are."""
    B, heads, n, d = q.shape
    T, H, W = q_size
    joined = (torch.cat([*tables, tables[0].new_zeros(1, d)]) * scale).to(q.dtype)
    th = torch.matmul(q.reshape(B * heads, T, H, W, d), joined[rows[0]].transpose(-1, -2))
    w = torch.bmm(q.reshape(-1, W, d).transpose(0, 1), joined[rows[1]].transpose(-1, -2))
    return th.reshape(B, heads, n, -1), w.transpose(0, 1).reshape(B, heads, n, -1)


def rel_pos_bias(q: torch.Tensor, q_size, k_size, tables, index) -> torch.Tensor:
    """Rel(q) `[B, h, Nq, Nkv]` of q `[B, h, Nq, d]` on the query grid
    `q_size` and the key grid `k_size`, (t, h, w) each; `tables` and
    `index` the (t, h, w) tables and their row maps: the broadcast sum of
    `rel_terms`, the plain form the packed attention is held against."""
    B, heads, n, _ = q.shape
    kt, kh, kw = k_size
    rows = term_rows(index, [len(t) for t in tables], k_size, _th_channels(k_size) + kw)
    th, w = rel_terms(q, q_size, tables, rows)
    rt, rh, rw = th[..., :kt], th[..., kt:kt + kh], w[..., :kw]
    bias = (rt[..., :, None, None] + rh[..., None, :, None]) + rw[..., None, None, :]
    return bias.reshape(B, heads, n, math.prod(k_size))


def packed_width(d: int, k_size) -> int:
    """The channels of the packed query and keys: d, then the t and h
    terms (kt + kh rounded up to 8) and the w terms, rounded up to 32
    together."""
    return d + _round_up(_th_channels(k_size) + k_size[2], 32)


def key_onehots(k_size, channels: int) -> torch.Tensor:
    """`[Nkv, channels]`: the one-hots of the key (t', i', j') where
    `rel_terms` puts the terms of that coordinate (columns t', kt + i' and
    ct + j' for ct = kt + kh rounded up to 8), zeros elsewhere."""
    grid = torch.stack(torch.meshgrid(*(torch.arange(n) for n in k_size), indexing="ij"), -1)
    cols = grid.reshape(-1, 3) + torch.tensor([0, k_size[0], _th_channels(k_size)])
    return F.one_hot(cols, channels).sum(1).float()


def pack(q, k, q_size, tables, rows, onehots) -> tuple:
    """q′ = [q, √d·Rel(q)'s terms, 0] and k′ = [k, `onehots`] of q, k
    `[B, h, N, d]`, `[B, h, N, d + channels of onehots]` each, so that
    q′·k′ᵀ/√d = q·kᵀ/√d + Rel(q)."""
    B, heads, _, d = q.shape
    terms = rel_terms(q, q_size, tables, rows, math.sqrt(d))
    return (torch.cat([q, *terms], -1),
            torch.cat([k, onehots.to(k.dtype).expand(B, heads, -1, -1)], -1))


def packed_attention(q, k, v, q_size, tables, rows, onehots) -> torch.Tensor:
    """softmax(q·kᵀ/√d + Rel(q))·v + q as one attention call with no mask:
    `pack`'s q′ and k′, v as it is, at the scale 1/√d of q's width d."""
    qp, kp = pack(q, k, q_size, tables, rows, onehots)
    return F.scaled_dot_product_attention(qp, kp, v, scale=q.shape[-1] ** -0.5) + q


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
        self.width = packed_width(d, self.kv_size)
        index = [rel_index(a, b) for a, b in zip(self.q_size, self.kv_size)]
        rows = term_rows(index, (len(self.rel_pos_t), side, side), self.kv_size, self.width - d)
        for name, r in zip(("th", "w"), rows):
            self.register_buffer(f"rows_{name}", r, persistent=False)
        self.register_buffer("onehots", key_onehots(self.kv_size, self.width - d),
                             persistent=False)

    def _pool(self, qkv: torch.Tensor, part: int) -> torch.Tensor:
        """The part `part` (0 q, 1 k, 2 v) of qkv `[B, N, 3·dim_out]`, pooled
        and normed: `[B, h, N', d]` (`ops/attn_pool.py::attn_pool`)."""
        name = "qkv"[part]
        conv, norm = getattr(self, f"pool_{name}"), getattr(self, f"norm_{name}")
        return attn_pool(qkv, part, self.heads, self.size, conv.stride, conv.weight,
                         norm.weight, norm.bias, norm.eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """LN1's output `[B, N, dim]` on the grid `size` → `[B, Nq, dim_out]`
        on the grid `q_size`."""
        B = x.shape[0]
        qkv = _linear(self.qkv, x)
        with span("model.attn_pool"):
            q, k, v = (self._pool(qkv, part) for part in range(3))
        with span("model.attention"):
            out = packed_attention(q, k, v, self.q_size,
                                   (self.rel_pos_t, self.rel_pos_h, self.rel_pos_w),
                                   (self.rows_th, self.rows_w), self.onehots)
        LAUNCHES["packed_attention"] += 1
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
