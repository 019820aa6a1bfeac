"""Video Swin-B as STEP's backbone: attention within shifted 3-D windows,
cut at the end of its stride-16 stage.

The Video Swin Transformer of Liu et al., CVPR 2022 (arXiv:2106.13230;
SwinTransformer/Video-Swin-Transformer, the config
`swin_base_patch244_window877_kinetics400_1k.py` and
`mmaction/models/backbones/swin_transformer.py`: `SwinTransformer3D`,
`BasicLayer`, `SwinTransformerBlock3D`, `WindowAttention3D`,
`PatchMerging`, `PatchEmbed3D`, `get_window_size`, `compute_mask`),
without its classifier:

  tokens = LN(Conv3d(pad(x)))   3→128, kernel = stride = (2, 4, 4), with
                                bias; the clip padded with zeros to a
                                multiple of the patch; no position table
  a stage of width C, h heads of d = C / h, window w (8, 7, 7) and shift
  s = w / 2 (4, 3, 3), each adapted to the grid (`window_size`):
    every block j, shifted when j is odd:
      xn = pad(LN1(x)) to multiples of w, with zeros after the norm
      xn = roll(xn, −s) if shifted; windows of N = wd·wh·ww tokens
      a = softmax(q·kᵀ/√d + table[index] (+ mask if shifted))·v   per window
      x = x + crop(roll(proj(a), +s));  x = x + fc2(GELU(fc1(LN2(x))))
    then PatchMerging, except after the last stage run: the 2x2
    neighbours (h, w) = (0,0), (1,0), (0,1), (1,1) side by side, LN over
    4C, Linear 4C → 2C without bias
  map = out_norm(x) → [B, T', H', W', C]         channels-last

`table` is a block's `[(2wd−1)(2wh−1)(2ww−1), h]` relative-position bias,
read at the displacement of two tokens of the full (8, 7, 7) window offset
by (7, 6, 6), `index[:N, :N]` where a window was adapted to fewer tokens,
as the published code slices it. The shifted blocks' mask is −100 where
two tokens of a window lie in different regions of the rolled grid (the
slices (−w), (−w, −s), (−s, None) of each axis). Padded tokens take part in
the attention (their keys and values are qkv's bias) and are cropped
away. LayerNorm eps 1e-5, exact GELU, MLP width 4C.

Widths by `backbone_depth`: "full" is Swin-B to the end of its third stage
(depths 2, 2, 18 at widths 128/256/512, heads 4/8/16, d 32; it requires
`feature_stride` 16); stage 4 (2 blocks, 1024 wide, stride 32) is left
out, as STEP's I3D map is Mixed_4f, at the end of its stride-16 stage.
"tiny" keeps every kind of block at widths 16/32/64, d 16, two blocks a
stage (W-MSA, then SW-MSA), the published window and table, the patch
`feature_stride` / 4. The parameter names are the published ones under
`features.` (`patch_embed.proj`, `patch_embed.norm`,
`layers.{i}.blocks.{j}.norm1`, `attn.qkv`, `attn.proj`,
`attn.relative_position_bias_table`, `norm2`, `mlp.fc1`, `mlp.fc2`,
`layers.{i}.downsample.norm`, `.reduction`), and `out_norm`, the map's
LayerNorm.

The windows are index maps made for the configured clip (`num_frames`,
`image_size`), buffers outside the state_dict: one gather takes LN1's
output, padded by one zero token, to the windows `[B, nW·N, C]` (the pad,
roll and partition at once), one gather takes the projected windows back
to the tokens (the reverse, roll back and crop). Attention runs window
major, q, k and v `[nW·h, B, N, d]`, so that the bias, summed with the
mask once per set of weights (`utils/tensor_cache.derived`) as
`[nW·h, 1, N, N]` in the compute dtype, broadcasts over the clips in
one `F.scaled_dot_product_attention` call; no tensor of the batch's size
holds a bias. Spans: `model.stem` (the patch embedding and its norm), and
a block's `model.window` (each of the two gathers), `model.attention`
(the split into heads, the bias, the attention call, the merge of the
heads) and `model.mlp` (`vit.Mlp`). Weights follow the activations' dtype
(cast per use), so a float32 tree computes in bfloat16 when its input is.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from step_tpu_torch.models.nets import _linear
from step_tpu_torch.models.vit import Mlp, PatchEmbed, layer_norm
from step_tpu_torch.utils.spans import span
from step_tpu_torch.utils.tensor_cache import derived

NAME = "swin3d_b"
FEATURE_STRIDE = 16
PATCH_T = 2
WINDOW = (8, 7, 7)
SHIFT = tuple(w // 2 for w in WINDOW)
LN_EPS = 1e-5
MASK = -100.0
MLP_RATIO = 4
# depth → (first stage's width, head dim, blocks a stage)
WIDTHS = {"full": (128, 32, (2, 2, 18)), "tiny": (16, 16, (2, 2, 2))}


def feature_frames(num_frames: int) -> int:
    """T' of the map: the clip padded to a multiple of 2 frames, one slice
    a patch (9 of 18)."""
    return -(-num_frames // PATCH_T)


def window_size(size) -> tuple:
    """The published `get_window_size` of `WINDOW` and `SHIFT` on the grid
    `size`: along an axis whose side is at most the window, the window is
    the side and the shift 0."""
    adapted = [(n, 0) if n <= w else (w, s) for n, w, s in zip(size, WINDOW, SHIFT)]
    return tuple(w for w, _ in adapted), tuple(s for _, s in adapted)


def table_rows() -> int:
    return math.prod(2 * w - 1 for w in WINDOW)


def relative_index() -> torch.Tensor:
    """`[N, N]` rows of the bias table for the tokens of a full window,
    (d, h, w)-major: their displacement offset by w − 1 on each axis,
    flattened as Δd·(2wh−1)(2ww−1) + Δh·(2ww−1) + Δw."""
    coords = torch.stack(torch.meshgrid(*(torch.arange(w) for w in WINDOW),
                                        indexing="ij")).flatten(1)
    rel = coords[:, :, None] - coords[:, None, :]
    sides = [2 * w - 1 for w in WINDOW]
    strides = torch.tensor([sides[1] * sides[2], sides[2], 1])
    offset = torch.tensor([w - 1 for w in WINDOW])
    return ((rel + offset[:, None, None]) * strides[:, None, None]).sum(0)


def _slot_coords(padded, window) -> torch.Tensor:
    """`[nW·N, 3]`: the rolled grid's coordinates of every window slot,
    windows (d, h, w)-major and the tokens of a window too, as
    `window_partition` lays them."""
    grid = torch.stack(torch.meshgrid(*(torch.arange(p) for p in padded), indexing="ij"), -1)
    (cd, ch, cw), (wd, wh, ww) = [p // w for p, w in zip(padded, window)], window
    grid = grid.view(cd, wd, ch, wh, cw, ww, 3).permute(0, 2, 4, 1, 3, 5, 6)
    return grid.reshape(-1, 3)


def window_slots(size, window, shift) -> tuple:
    """The index maps of one kind of block on the token grid `size` (D, H,
    W), with `window` and `shift` adapted: `gather` `[nW·N]`, the token
    (of D·H·W, or D·H·W itself, a zero row, where the slot is padding) that
    each window slot reads, the slot at rolled coordinate r holding the
    padded grid's (r + s) mod P; `scatter` `[D·H·W]`, the slot of each
    token."""
    padded = [-(-n // w) * w for n, w in zip(size, window)]
    P, S, Z = (torch.tensor(v) for v in (padded, shift, size))
    p = (_slot_coords(padded, window) + S) % P
    real = (p < Z).all(-1)
    token = (p[:, 0] * size[1] + p[:, 1]) * size[2] + p[:, 2]
    gather = torch.where(real, token, math.prod(size))
    grid = torch.stack(torch.meshgrid(*(torch.arange(n) for n in size), indexing="ij"),
                       -1).reshape(-1, 3)
    r = (grid - S) % P
    W, counts = torch.tensor(window), P // torch.tensor(window)
    win, off = r // W, r % W
    n = math.prod(window)
    scatter = (((win[:, 0] * counts[1] + win[:, 1]) * counts[2] + win[:, 2]) * n
               + (off[:, 0] * window[1] + off[:, 1]) * window[2] + off[:, 2])
    return gather, scatter


def region_labels(size, window, shift) -> torch.Tensor:
    """`[nW, N]`: the region of each window slot in the rolled grid, as
    `compute_mask` labels them (the slices (−w), (−w, −s), (−s, None) of
    each axis; one region along an axis that is not shifted)."""
    padded = [-(-n // w) * w for n, w in zip(size, window)]
    r = _slot_coords(padded, window)
    labels = torch.zeros(r.shape[0], dtype=torch.long)
    for axis, (p, w, s) in enumerate(zip(padded, window, shift)):
        part = ((r[:, axis] >= p - w).long() + (r[:, axis] >= p - s).long()) if s else 0
        labels = labels * 3 + part
    return labels.view(-1, math.prod(window))


def window_mask(labels: torch.Tensor) -> torch.Tensor:
    """`[nW, N, N]`: −100 where two slots' regions differ, else 0."""
    differ = labels[:, :, None] != labels[:, None, :]
    return differ.float() * MASK


class PatchEmbed3D(PatchEmbed):
    """`vit.PatchEmbed`'s tubelet GEMM, (2, p, p), on the clip padded with
    zeros to a multiple of the patch, then `norm`."""

    def __init__(self, dim: int, patch: int):
        super().__init__(dim, patch)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x `[B, T, H, W, 3]` → tokens `[B, N, D]`, (t, h, w)-major."""
        _, _, pt, p, _ = self.proj.weight.shape
        T, H, W = x.shape[1:4]
        pads = ((-W) % p, (-H) % p, (-T) % pt)
        if any(pads):
            x = F.pad(x, (0, 0, 0, pads[0], 0, pads[1], 0, pads[2]))
        return layer_norm(self.norm, super().forward(x))


class WindowAttention3D(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.relative_position_bias_table = nn.Parameter(torch.zeros(table_rows(), heads))
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self._bias = {}

    def bias(self, index: torch.Tensor, labels: torch.Tensor, dtype) -> torch.Tensor:
        """`[nW·h, 1, N, N]` in `dtype`: the table at `index` `[N, N]` for
        each head of each window, plus the mask of `labels` `[nW, N]` (0
        where a window is one region), made once per table."""
        table = self.relative_position_bias_table

        def make():
            nW, N = labels.shape
            b = table.to(dtype)[index].permute(2, 0, 1).contiguous()
            return (b[None] + window_mask(labels).to(dtype)[:, None]).view(
                nW * self.heads, 1, N, N)

        if torch.is_grad_enabled() and table.requires_grad:
            return make()
        return derived(self._bias, (table, index, labels), make, dtype)

    def forward(self, windows: torch.Tensor, index, labels) -> torch.Tensor:
        """The windows `[B, nW·N, C]` → the attention's projected output,
        the same shape."""
        B, _, C = windows.shape
        nW, N = labels.shape
        h, d = self.heads, C // self.heads
        qkv = _linear(self.qkv, windows)
        with span("model.attention"):
            q, k, v = qkv.view(B, nW, N, 3, h, d).permute(3, 1, 4, 0, 2, 5).reshape(
                3, nW * h, B, N, d)
            out = F.scaled_dot_product_attention(q, k, v,
                                                 attn_mask=self.bias(index, labels, q.dtype))
            out = out.view(nW, h, B, N, d).permute(2, 0, 3, 1, 4).reshape(B, nW * N, C)
        return _linear(self.proj, out)


class SwinBlock3D(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention3D(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, MLP_RATIO * dim)

    def forward(self, x: torch.Tensor, gather, scatter, index, labels) -> torch.Tensor:
        """x `[B, L, C]`; `gather`, `scatter` and `labels` the block's kind's
        (`window_slots`, `region_labels`), `index` the layer's table rows."""
        xn = layer_norm(self.norm1, x)
        with span("model.window"):
            windows = F.pad(xn, (0, 0, 0, 1)).index_select(1, gather)
        out = self.attn(windows, index, labels)
        with span("model.window"):
            out = out.index_select(1, scatter)
        x = x + out
        return x + self.mlp(layer_norm(self.norm2, x))


class PatchMerging(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The grid `[B, D, H, W, C]` → `[B, D, ⌈H/2⌉, ⌈W/2⌉, 2C]`: the
        neighbours (h, w) = (0,0), (1,0), (0,1), (1,1) side by side."""
        H, W = x.shape[2:4]
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x = torch.cat([x[:, :, i::2, j::2] for j in (0, 1) for i in (0, 1)], -1)
        return F.linear(layer_norm(self.norm, x), self.reduction.weight.to(x.dtype))


class BasicLayer(nn.Module):
    """A stage on the token grid `size`: its blocks, W-MSA and SW-MSA in
    turn, and the index maps of each kind (`gather_0`, `scatter_0`,
    `labels_0` unshifted; `_1` at the adapted shift, which may be 0), made
    for `size`; `downsample` a `PatchMerging` at its end."""

    def __init__(self, dim: int, blocks: int, heads: int, size, downsample: bool):
        super().__init__()
        self.size = tuple(size)
        self.window, self.shift = window_size(self.size)
        self.blocks = nn.ModuleList(SwinBlock3D(dim, heads) for _ in range(blocks))
        self.downsample = PatchMerging(dim) if downsample else None
        N = math.prod(self.window)
        self.register_buffer("index", relative_index()[:N, :N], persistent=False)
        for k, shift in enumerate(((0, 0, 0), self.shift)):
            gather, scatter = window_slots(self.size, self.window, shift)
            self.register_buffer(f"gather_{k}", gather, persistent=False)
            self.register_buffer(f"scatter_{k}", scatter, persistent=False)
            self.register_buffer(f"labels_{k}", region_labels(self.size, self.window, shift),
                                 persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Tokens `[B, L, C]` on `size` → `[B, L', C']`, merged where the
        stage merges."""
        for j, block in enumerate(self.blocks):
            k = j % 2
            x = block(x, getattr(self, f"gather_{k}"), getattr(self, f"scatter_{k}"),
                      self.index, getattr(self, f"labels_{k}"))
        if self.downsample is not None:
            x = self.downsample(x.view(x.shape[0], *self.size, -1))
            x = x.view(x.shape[0], -1, x.shape[-1])
        return x


class SwinTransformer3D(nn.Module):
    """Video Swin-B to its stride-16 map as the detector's backbone: the
    normalized clip `[B, T, H, W, 3]` → `[B, ⌈T/2⌉, H/16, W/16, 512]`
    (`out_channels`). `num_frames` and `image_size` fix the windows' index
    maps."""

    def __init__(self, depth: str, feature_stride: int, num_frames: int, image_size: int):
        super().__init__()
        if depth not in WIDTHS:
            raise ValueError(f"unknown backbone depth {depth!r}")
        if depth == "full" and feature_stride != FEATURE_STRIDE:
            raise ValueError(f"{NAME} at full depth has spatial stride {FEATURE_STRIDE}, "
                             f"the config asks for feature_stride={feature_stride}")
        width, d, stages = WIDTHS[depth]
        patch = feature_stride // 2 ** (len(stages) - 1)
        self.patch_embed = PatchEmbed3D(width, patch)
        side = -(-image_size // patch)
        size = (feature_frames(num_frames), side, side)
        self.layers = nn.ModuleList()
        for i, blocks in enumerate(stages):
            dim = width << i
            last = i == len(stages) - 1
            self.layers.append(BasicLayer(dim, blocks, dim // d, size, not last))
            if not last:
                size = (size[0], -(-size[1] // 2), -(-size[2] // 2))
        self.out_channels = width << (len(stages) - 1)
        self.out_norm = nn.LayerNorm(self.out_channels, eps=LN_EPS)

    def forward(self, x: torch.Tensor, chunks: int | None = None, train: bool = False,
                flow: torch.Tensor | None = None) -> torch.Tensor:
        """`FeatureNet`'s signature. `chunks`, `train` and `flow` change
        nothing: the detector refuses chunk stems and flow with this
        backbone, and it has no BatchNorm and no dropout."""
        B, T, H, W = x.shape[:4]
        p = self.patch_embed.proj.stride[-1]
        grid, first = (feature_frames(T), -(-H // p), -(-W // p)), self.layers[0].size
        if grid != first:
            raise ValueError(f"a clip of {T}x{H}x{W} makes a {'x'.join(map(str, grid))} grid; "
                             f"the windows were made for {'x'.join(map(str, first))}")
        with span("model.stem"):
            x = self.patch_embed(x)
        for layer in self.layers:
            x = layer(x)
        return layer_norm(self.out_norm, x).view(B, *self.layers[-1].size, self.out_channels)
