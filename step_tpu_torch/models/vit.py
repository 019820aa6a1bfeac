"""VideoMAE ViT-B/16 as STEP's backbone: joint space-time attention over
the clip's tubelets.

The encoder of VideoMAE (Tong et al., NeurIPS 2022, arXiv:2203.12602;
`modeling_finetune.py::VisionTransformer`) without its classifier, run to
its final LayerNorm:

  tokens = PatchEmbed(x) + sinusoid table   Conv3d 3→D, kernel = stride =
                                            (2, p, p), with bias; N = T/2 ·
                                            H/p · W/p tokens in (t, h, w) order
  each block:  x += proj(Attn(LN1(x)))      qkv Linear D→3D without bias,
                                            its bias cat(q_bias, 0, v_bias);
                                            softmax(q·kᵀ / √d)·v over all N
               x += fc2(GELU(fc1(LN2(x))))  exact GELU, MLP width 4D
  map = LN(x) → [B, T/2, H/p, W/p, D]       channels-last, spatial stride p

LayerNorm eps 1e-6. The position table is VideoMAE's fixed one (sin on
even, cos on odd channels at pos / 10000^(2⌊i/2⌋/D)), made once for the
configured clip as a buffer outside the state_dict, and added in the
activations' dtype as VideoMAE's `type_as(x)` adds it. The parameter names
are VideoMAE's (`patch_embed.proj`, `blocks.{i}.norm1`, `attn.qkv`,
`attn.q_bias`, `attn.v_bias`, `attn.proj`, `norm2`, `mlp.fc1`, `mlp.fc2`,
`norm`), so its checkpoint maps one to one under `features.`.

The tubelet embedding is computed as the matrix product it is (each
tubelet flattened in the conv weight's (c, t, h, w) order against the
weight as a `[D, 3·2·p·p]` matrix), the same arithmetic as the strided
conv. Attention runs through `F.scaled_dot_product_attention`, whichever
backend PyTorch picks; the spans `model.attention` (the attention call)
and `model.mlp` (fc1, GELU, fc2) mark each block's two halves.

Widths by `backbone_depth`: "full" is ViT-B/16 (D 768, 12 blocks of 12
heads, MLP 3072, tubelet 2x16x16; it requires `feature_stride` 16);
"tiny" keeps every kind of layer at D 64, 2 blocks of 4 heads, MLP 256,
tubelet 2 x `feature_stride`². Weights follow the activations' dtype
(cast per use), so a float32 tree computes in bfloat16 when its input is.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from step_tpu_torch.models.nets import _linear
from step_tpu_torch.utils.spans import span

NAME = "videomae_vit_b16"
TUBELET_FRAMES = 2
PATCH = 16
LN_EPS = 1e-6
# depth → (width D, blocks, heads, MLP width)
WIDTHS = {"full": (768, 12, 12, 3072), "tiny": (64, 2, 4, 256)}


def feature_frames(num_frames: int) -> int:
    """T' of the map: one slice a tubelet of `TUBELET_FRAMES` frames."""
    return num_frames // TUBELET_FRAMES


def sinusoid_table(n: int, dim: int, device=None) -> torch.Tensor:
    """VideoMAE's `get_sinusoid_encoding_table(n, dim)`: `[n, dim]`
    float32, worked out in float64 as its numpy original is."""
    pos = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    i = torch.arange(dim, device=device)
    angle = pos / torch.pow(10000.0, (2 * (i // 2)).to(torch.float64) / dim)
    return torch.where(i % 2 == 0, torch.sin(angle), torch.cos(angle)).to(torch.float32)


def layer_norm(layer: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """`layer` in the activations' dtype, at its own eps."""
    return F.layer_norm(x, layer.normalized_shape, layer.weight.to(x.dtype),
                        layer.bias.to(x.dtype), layer.eps)


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv3d(3, dim, (TUBELET_FRAMES, patch, patch),
                              (TUBELET_FRAMES, patch, patch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x `[B, T, H, W, C]` → tokens `[B, N, D]`, a remainder of frames
        or pixels dropped as the strided conv drops it."""
        B, T, H, W, C = x.shape
        D, _, pt, p, _ = self.proj.weight.shape
        t, h, w = T // pt, H // p, W // p
        x = x[:, :t * pt, :h * p, :w * p].reshape(B, t, pt, h, p, w, p, C)
        x = x.permute(0, 1, 3, 5, 7, 2, 4, 6).reshape(B, t * h * w, C * pt * p * p)
        return F.linear(x, self.proj.weight.reshape(D, -1).to(x.dtype),
                        self.proj.bias.to(x.dtype))


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.q_bias = nn.Parameter(torch.zeros(dim))
        self.v_bias = nn.Parameter(torch.zeros(dim))
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        bias = torch.cat([self.q_bias, torch.zeros_like(self.v_bias), self.v_bias])
        qkv = F.linear(x, self.qkv.weight.to(x.dtype), bias.to(x.dtype))
        q, k, v = qkv.reshape(B, N, 3, self.heads, D // self.heads).permute(2, 0, 3, 1, 4)
        with span("model.attention"):
            out = F.scaled_dot_product_attention(q, k, v)
        return _linear(self.proj, out.transpose(1, 2).reshape(B, N, D))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("model.mlp"):
            return _linear(self.fc2, F.gelu(_linear(self.fc1, x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, hidden: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(self.norm1, x))
        return x + self.mlp(layer_norm(self.norm2, x))


class VideoMAEViT(nn.Module):
    """The ViT encoder as the detector's backbone: the normalized clip
    `[B, T, H, W, 3]` → the map `[B, T/2, H/p, W/p, D]` (`out_channels` D).
    `num_frames` and `image_size` fix the position table's length."""

    def __init__(self, depth: str, feature_stride: int, num_frames: int, image_size: int):
        super().__init__()
        if depth not in WIDTHS:
            raise ValueError(f"unknown backbone depth {depth!r}")
        if depth == "full" and feature_stride != PATCH:
            raise ValueError(f"{NAME} at full depth has spatial stride {PATCH}, "
                             f"the config asks for feature_stride={feature_stride}")
        dim, blocks, heads, hidden = WIDTHS[depth]
        self.out_channels = dim
        self.patch_embed = PatchEmbed(dim, feature_stride)
        self.blocks = nn.ModuleList(Block(dim, heads, hidden) for _ in range(blocks))
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        n = feature_frames(num_frames) * (image_size // feature_stride) ** 2
        self.register_buffer("pos_embed", sinusoid_table(n, dim), persistent=False)

    def forward(self, x: torch.Tensor, chunks: int | None = None, train: bool = False,
                flow: torch.Tensor | None = None) -> torch.Tensor:
        """`FeatureNet`'s signature. `chunks`, `train` and `flow` change
        nothing: the detector refuses chunk stems and flow with this
        backbone, and it has no BatchNorm and no dropout."""
        B, T, H, W = x.shape[:4]
        p = self.patch_embed.proj.stride[-1]
        tokens = self.patch_embed(x)
        if tokens.shape[1] != self.pos_embed.shape[0]:
            raise ValueError(f"a clip of {T}x{H}x{W} makes {tokens.shape[1]} tokens; the "
                             f"position table was made for {self.pos_embed.shape[0]}")
        x = tokens + self.pos_embed.to(tokens.dtype)
        for block in self.blocks:
            x = block(x)
        x = layer_norm(self.norm, x)
        return x.reshape(B, feature_frames(T), H // p, W // p, x.shape[-1])
