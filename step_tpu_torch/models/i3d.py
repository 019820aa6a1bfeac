"""I3D — the Inflated 3D Inception-v1 backbone.

Port of `step_tpu/models/i3d.py`: `Unit3D` (:138-197), `max_pool_3d`
(:213-261), `InceptionBlock` (:264-319), `I3DStem` (:322-378) and `I3DTail`
(:381-414), at depths "full" and "tiny". Tensors are NCDHW here; the
detector hands in channels-last data as a permuted view, so the backbone
runs in `channels_last_3d` memory order.

Padding is TensorFlow's SAME rule, as in the released I3D checkpoints: the
total pad is max((ceil(n/s) - 1)*s + k - n, 0), with the odd extra cell on
the high side — asymmetric on every strided conv and pool. Pools pad with
-inf. BatchNorm runs in eval mode with eps 1e-3, or is folded into the conv
(`bn_folded`, weights from `models/optimize.py::fold_bn`).

Weights are kept in whatever dtype the module was moved to and cast to the
activation dtype at each call (the JAX package keeps float32 parameters and
casts them to its compute dtype).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

# Inception-v1 branch widths: (b0_1x1, b1_reduce, b1_3x3, b2_reduce, b2_3x3, b3_pool_proj)
INCEPTION_CHANNELS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),      # out 256
    "Mixed_3c": (128, 128, 192, 32, 96, 64),    # out 480
    "Mixed_4b": (192, 96, 208, 16, 48, 64),     # out 512
    "Mixed_4c": (160, 112, 224, 24, 64, 64),    # out 512
    "Mixed_4d": (128, 128, 256, 24, 64, 64),    # out 512
    "Mixed_4e": (112, 144, 288, 32, 64, 64),    # out 528
    "Mixed_4f": (256, 160, 320, 32, 128, 128),  # out 832
    "Mixed_5b": (256, 160, 320, 32, 128, 128),  # out 832
    "Mixed_5c": (384, 192, 384, 48, 128, 128),  # out 1024
}
# The "tiny" depth: same building blocks, a fraction of the widths.
TINY_A = (16, 16, 24, 8, 16, 8)      # out 64
TINY_B = (32, 24, 48, 8, 24, 24)     # out 128
BN_EPS = 1e-3


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF-SAME (low, high) padding of an axis of size n for kernel k, stride s."""
    pad = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


def _same_padding(x: torch.Tensor, kernel, stride):
    """(symmetric padding or None, F.pad list) for an NCDHW tensor."""
    pads = [same_pads(x.shape[2 + i], kernel[i], stride[i]) for i in range(3)]
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
        return tuple(lo for lo, _ in pads), None
    return None, [p for lo_hi in reversed(pads) for p in lo_hi]


def conv3d_same(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None, stride) -> torch.Tensor:
    """3-D convolution with TF-SAME padding; weights cast to x's dtype."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    sym, pad = _same_padding(x, w.shape[2:], stride)
    if sym is not None:
        return F.conv3d(x, w, b, stride, sym)
    return F.conv3d(F.pad(x, pad), w, b, stride)


def max_pool_3d(x: torch.Tensor, window, stride) -> torch.Tensor:
    """3-D max pool with TF-SAME padding of -inf."""
    sym, pad = _same_padding(x, window, stride)
    if sym is not None:
        return F.max_pool3d(x, window, stride, sym)
    return F.max_pool3d(F.pad(x, pad, value=float("-inf")), window, stride)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over channel axis 1, eps 1e-3; its state maps
    one to one onto the JAX package's scale/bias and mean/var."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = x.dtype
        return F.batch_norm(x, self.running_mean.to(d), self.running_var.to(d),
                            self.weight.to(d), self.bias.to(d), False, 0.0,
                            BN_EPS)


class Unit3D(nn.Module):
    """Conv3D → BatchNorm → ReLU (reference `Unit3D`, :138-197). With
    `bn_folded` the BatchNorm is gone and the conv carries a bias."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1),
                 stride=(1, 1, 1), bn_folded: bool = False):
        super().__init__()
        self.stride = tuple(stride)
        self.conv = nn.Conv3d(cin, cout, kernel, stride, bias=bn_folded)
        self.bn = None if bn_folded else BatchNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = conv3d_same(x, self.conv.weight, self.conv.bias, self.stride)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x)


class InceptionBlock(nn.Module):
    """Four parallel branches, concatenated on channels (:264-319)."""

    def __init__(self, cin: int, channels, bn_folded: bool = False):
        super().__init__()
        c = channels
        u = lambda i, o, k: Unit3D(i, o, k, bn_folded=bn_folded)  # noqa: E731
        self.b0 = u(cin, c[0], (1, 1, 1))
        self.b1a = u(cin, c[1], (1, 1, 1))
        self.b1b = u(c[1], c[2], (3, 3, 3))
        self.b2a = u(cin, c[3], (1, 1, 1))
        self.b2b = u(c[3], c[4], (3, 3, 3))
        self.b3b = u(cin, c[5], (1, 1, 1))
        self.out_channels = c[0] + c[2] + c[4] + c[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b0 = self.b0(x)
        b1 = self.b1b(self.b1a(x))
        b2 = self.b2b(self.b2a(x))
        b3 = self.b3b(max_pool_3d(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([b0, b1, b2, b3], dim=1)


class I3DStem(nn.Module):
    """I3D from the RGB clip through Mixed_4f, the shared detection feature
    (:322-378): `[B, 3, T, H, W]` → `[B, 832, T/4, H/16, W/16]` at depth
    "full", `[B, 128, T/4, H/8, W/8]` at depth "tiny"."""

    def __init__(self, depth: str = "full", bn_folded: bool = False):
        super().__init__()
        f = bn_folded
        if depth == "tiny":
            self.Conv3d_1a_7x7 = Unit3D(3, 16, (3, 7, 7), (2, 2, 2), f)
            self.Mixed_3b = InceptionBlock(16, TINY_A, f)
            self.Mixed_4f = InceptionBlock(self.Mixed_3b.out_channels, TINY_B, f)
            self.out_channels = self.Mixed_4f.out_channels
        elif depth == "full":
            self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2), f)
            self.Conv3d_2b_1x1 = Unit3D(64, 64, (1, 1, 1), (1, 1, 1), f)
            self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3), (1, 1, 1), f)
            cin = 192
            for name in ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c",
                         "Mixed_4d", "Mixed_4e", "Mixed_4f"):
                block = InceptionBlock(cin, INCEPTION_CHANNELS[name], f)
                setattr(self, name, block)
                cin = block.out_channels
            self.out_channels = cin
        else:
            raise ValueError(f"unknown backbone depth {depth!r}")
        self.depth = depth

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.depth == "tiny":
            x = self.Conv3d_1a_7x7(x)
            x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
            x = self.Mixed_3b(x)
            x = max_pool_3d(x, (3, 3, 3), (2, 2, 2))
            return self.Mixed_4f(x)
        x = self.Conv3d_1a_7x7(x)
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool_3d(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        return x


class I3DTail(nn.Module):
    """Mixed_5b + Mixed_5c ("full") or one Mixed_5c ("tiny"), run by every
    refinement step's head on pooled tube features (:381-414). The heads
    skip the classifier's MaxPool_5a, keeping the 7x7 ROI grid."""

    def __init__(self, cin: int, depth: str = "full", bn_folded: bool = False):
        super().__init__()
        if depth == "tiny":
            self.Mixed_5c = InceptionBlock(cin, TINY_B, bn_folded)
            self.blocks = ("Mixed_5c",)
        elif depth == "full":
            self.Mixed_5b = InceptionBlock(cin, INCEPTION_CHANNELS["Mixed_5b"],
                                           bn_folded)
            self.Mixed_5c = InceptionBlock(self.Mixed_5b.out_channels,
                                           INCEPTION_CHANNELS["Mixed_5c"],
                                           bn_folded)
            self.blocks = ("Mixed_5b", "Mixed_5c")
        else:
            raise ValueError(f"unknown backbone depth {depth!r}")
        self.out_channels = self.Mixed_5c.out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x
