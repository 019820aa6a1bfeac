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

Inference variants, as in the JAX package:
  * `fused_bn_relu` (BN not folded): each Unit3D's BN + ReLU runs through
    `ops/fused_bn_relu.py` (kernel K4); a 3x3x3 stride-1 unit runs conv, BN
    and ReLU as one `ops/conv3d.py` call (kernel K3), whose contract is
    exactly that unit's;
  * `STEP_TPU_POOL3D=pallas`, read on every call: each 3x3x3 stride-1 max
    pool goes through `ops/pool.py` (kernel K5);
  * `fused_inception` (BN folded): an Inception block's three 1x1x1 branch
    convs run as one conv "b012", then split; `fused_inception3` also runs
    the two 3x3x3 branch convs as one block-diagonal conv "b12" (weights
    from `models/optimize.py`).

Weights are kept in whatever dtype the module was moved to and cast to the
activation dtype at each call (the JAX package keeps float32 parameters and
casts them to its compute dtype).
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn as nn
import torch.nn.functional as F

from step_tpu_torch.ops.conv3d import conv3x3x3_bn_relu
from step_tpu_torch.ops.fused_bn_relu import bn_scale_bias, fused_scale_bias_relu
from step_tpu_torch.ops.pool import max_pool3x3_same

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
    """3-D max pool with TF-SAME padding of -inf. With
    `STEP_TPU_POOL3D=pallas` (read on every call, as the JAX package reads
    it) a 3x3x3 stride-1 pool goes to `ops/pool.py::max_pool3x3_same`."""
    if (os.environ.get("STEP_TPU_POOL3D", "direct") == "pallas"
            and tuple(window) == (3, 3, 3) and tuple(stride) == (1, 1, 1)):
        return max_pool3x3_same(x)
    sym, pad = _same_padding(x, window, stride)
    if sym is not None:
        return F.max_pool3d(x, window, stride, sym)
    return F.max_pool3d(F.pad(x, pad, value=float("-inf")), window, stride)


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over channel axis 1, eps 1e-3; its state maps
    one to one onto the JAX package's scale/bias and mean/var.

    It computes in float32 and rounds once to x's dtype, with flax's order
    of operations, (x - mean) * (rsqrt(var + eps) * gamma) + beta
    (flax `nn.BatchNorm(dtype=...)`, `step_tpu/models/i3d.py:188-194`)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        f32 = lambda t: t.to(torch.float32).reshape(shape)  # noqa: E731
        mul = torch.rsqrt(f32(self.running_var) + BN_EPS) * f32(self.weight)
        y = (x.to(torch.float32) - f32(self.running_mean)) * mul + f32(self.bias)
        return y.to(x.dtype)

    def scale_bias(self):
        """The float32 affine (scale, bias) `[C]` of this BN."""
        return bn_scale_bias(self.weight, self.bias, self.running_mean,
                             self.running_var, BN_EPS)


class Unit3D(nn.Module):
    """Conv3D → BatchNorm → ReLU (reference `Unit3D`, :138-197). With
    `bn_folded` the BatchNorm is gone and the conv carries a bias;
    `bn_folded` wins over `fused_bn_relu`, as in the JAX package. With
    `fused_bn_relu` a 3x3x3 stride-1 unit runs as one `conv3x3x3_bn_relu`
    and any other as conv + `fused_scale_bias_relu`."""

    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1),
                 stride=(1, 1, 1), bn_folded: bool = False,
                 fused_bn_relu: bool = False):
        super().__init__()
        self.stride = tuple(stride)
        self.conv = nn.Conv3d(cin, cout, kernel, stride, bias=bn_folded)
        self.bn = None if bn_folded else BatchNorm(cout)
        self.fused = fused_bn_relu and not bn_folded
        self.conv_bn_relu = (self.fused and tuple(kernel) == (3, 3, 3)
                             and self.stride == (1, 1, 1))
        self._kernel_weight = {}    # the conv kernel's weight layout, reused

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv_bn_relu:
            return conv3x3x3_bn_relu(x, self.conv.weight, *self.bn.scale_bias(),
                                     weight_cache=self._kernel_weight)
        x = conv3d_same(x, self.conv.weight, self.conv.bias, self.stride)
        if self.fused:
            return fused_scale_bias_relu(x, *self.bn.scale_bias())
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x)


class InceptionBlock(nn.Module):
    """Four parallel branches, concatenated on channels (:264-319).

    `fused_inception`: b0/b1a/b2a are one 1x1x1 conv "b012" whose output is
    split on channels. `fused_inception3` (needs `fused_inception`): b1b and
    b2b are one block-diagonal 3x3x3 conv "b12" over the contiguous
    [b1 | b2] slice of that output."""

    def __init__(self, cin: int, channels, bn_folded: bool = False,
                 fused_bn_relu: bool = False, fused_inception: bool = False,
                 fused_inception3: bool = False):
        super().__init__()
        if fused_inception3 and not fused_inception:
            raise ValueError("fused_inception3 requires fused_inception")
        c = self.channels = tuple(channels)
        u = lambda i, o, k: Unit3D(i, o, k, bn_folded=bn_folded,  # noqa: E731
                                   fused_bn_relu=fused_bn_relu)
        self.fused_inception = fused_inception
        self.fused_inception3 = fused_inception3
        if fused_inception:
            self.b012 = u(cin, c[0] + c[1] + c[3], (1, 1, 1))
        else:
            self.b0 = u(cin, c[0], (1, 1, 1))
            self.b1a = u(cin, c[1], (1, 1, 1))
            self.b2a = u(cin, c[3], (1, 1, 1))
        if fused_inception3:
            self.b12 = u(c[1] + c[3], c[2] + c[4], (3, 3, 3))
        else:
            self.b1b = u(c[1], c[2], (3, 3, 3))
            self.b2b = u(c[3], c[4], (3, 3, 3))
        self.b3b = u(cin, c[5], (1, 1, 1))
        self.out_channels = c[0] + c[2] + c[4] + c[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.channels
        b3 = self.b3b(max_pool_3d(x, (3, 3, 3), (1, 1, 1)))
        if self.fused_inception:
            y = self.b012(x)
            b0 = y[:, : c[0]]
            if self.fused_inception3:
                return torch.cat([b0, self.b12(y[:, c[0]:]), b3], dim=1)
            b1, b2 = y[:, c[0]: c[0] + c[1]], y[:, c[0] + c[1]:]
        else:
            b0, b1, b2 = self.b0(x), self.b1a(x), self.b2a(x)
        return torch.cat([b0, self.b1b(b1), self.b2b(b2), b3], dim=1)


class I3DStem(nn.Module):
    """I3D from the RGB clip through Mixed_4f, the shared detection feature
    (:322-378): `[B, 3, T, H, W]` → `[B, 832, T/4, H/16, W/16]` at depth
    "full", `[B, 128, T/4, H/8, W/8]` at depth "tiny"."""

    def __init__(self, depth: str = "full", bn_folded: bool = False,
                 fused_bn_relu: bool = False, fused_inception: bool = False,
                 fused_inception3: bool = False):
        super().__init__()
        unit = lambda i, o, k, s: Unit3D(i, o, k, s, bn_folded,  # noqa: E731
                                         fused_bn_relu)
        blk = lambda i, ch: InceptionBlock(  # noqa: E731
            i, ch, bn_folded, fused_bn_relu, fused_inception, fused_inception3)
        if depth == "tiny":
            self.Conv3d_1a_7x7 = unit(3, 16, (3, 7, 7), (2, 2, 2))
            self.Mixed_3b = blk(16, TINY_A)
            self.Mixed_4f = blk(self.Mixed_3b.out_channels, TINY_B)
            self.out_channels = self.Mixed_4f.out_channels
        elif depth == "full":
            self.Conv3d_1a_7x7 = unit(3, 64, (7, 7, 7), (2, 2, 2))
            self.Conv3d_2b_1x1 = unit(64, 64, (1, 1, 1), (1, 1, 1))
            self.Conv3d_2c_3x3 = unit(64, 192, (3, 3, 3), (1, 1, 1))
            cin = 192
            for name in ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c",
                         "Mixed_4d", "Mixed_4e", "Mixed_4f"):
                block = blk(cin, INCEPTION_CHANNELS[name])
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

    def __init__(self, cin: int, depth: str = "full", bn_folded: bool = False,
                 fused_bn_relu: bool = False, fused_inception: bool = False,
                 fused_inception3: bool = False):
        super().__init__()
        blk = lambda i, ch: InceptionBlock(  # noqa: E731
            i, ch, bn_folded, fused_bn_relu, fused_inception, fused_inception3)
        if depth == "tiny":
            self.Mixed_5c = blk(cin, TINY_B)
            self.blocks = ("Mixed_5c",)
        elif depth == "full":
            self.Mixed_5b = blk(cin, INCEPTION_CHANNELS["Mixed_5b"])
            self.Mixed_5c = blk(self.Mixed_5b.out_channels,
                                INCEPTION_CHANNELS["Mixed_5c"])
            self.blocks = ("Mixed_5b", "Mixed_5c")
        else:
            raise ValueError(f"unknown backbone depth {depth!r}")
        self.out_channels = self.Mixed_5c.out_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x
