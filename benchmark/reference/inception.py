"""The I3D units that a backbone and the detector's heads share, in float32
PyTorch: TF-SAME convolution and max pool, BatchNorm on its running
statistics or, in training, on the batch's, the conv-BN-ReLU unit, the
Inception block and its channel tables, and the shapes of their weights.

Activations are NCDHW. `run` is the forward's `detector.Run`: its
precision, train mode, the BatchNorm statistics it keeps, and its record of
the kernels run. Nothing here imports the program.

A stride-1 max pool under autograd credits every tied maximum
(`_MaxPoolS1`), as the program's does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

INCEPTION_CHANNELS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
TINY_A = (16, 16, 24, 8, 16, 8)
TINY_B = (32, 24, 48, 8, 24, 24)
BN_EPS = 1e-3


def block_out(c) -> int:
    """Channels out of an Inception block of channels `c`."""
    return c[0] + c[2] + c[4] + c[5]


# ---------------------------------------------------------------- parameters
def unit_shapes(name, cin, cout, kernel):
    out = {f"{name}.conv.weight": ((cout, cin) + tuple(kernel), "conv")}
    for part, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                       ("running_mean", "bn_mean"), ("running_var", "bn_var")):
        out[f"{name}.bn.{part}"] = ((cout,), kind)
    return out


def block_shapes(name, cin, c):
    out = {}
    for branch, i, o, k in (("b0", cin, c[0], 1), ("b1a", cin, c[1], 1),
                            ("b1b", c[1], c[2], 3), ("b2a", cin, c[3], 1),
                            ("b2b", c[3], c[4], 3), ("b3b", cin, c[5], 1)):
        out.update(unit_shapes(f"{name}.{branch}", i, o, (k, k, k)))
    return out, block_out(c)


# ---------------------------------------------------------------- units
def same_pads(n: int, k: int, s: int):
    pad = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


def _pad_list(x, kernel, stride):
    pads = [same_pads(x.shape[2 + i], kernel[i], stride[i]) for i in range(3)]
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def conv3d_same(x, w, b, stride, prec):
    return F.conv3d(F.pad(x, _pad_list(x, w.shape[2:], stride)), prec(w),
                    None if b is None else prec(b), stride)


def _pool1d(x, dim, k):
    lo = (k - 1) // 2
    y = x.clone()
    for o in range(k):
        t = o - lo
        a, b = max(0, -t), min(x.shape[dim], x.shape[dim] - t)
        if t and b > a:
            view = y.narrow(dim, a, b - a)
            torch.maximum(view, x.narrow(dim, a + t, b - a), out=view)
    return y


def _pool1d_grad(x, y, g, dim, k):
    lo = (k - 1) // 2
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    grad = torch.zeros_like(x)
    for o in range(k):
        t = lo - o
        a, b = max(0, -t), min(x.shape[dim], x.shape[dim] - t)
        if b <= a:
            continue
        n = b - a
        grad.narrow(dim, a, n).add_(torch.where(
            x.narrow(dim, a, n) == y.narrow(dim, a + t, n), g.narrow(dim, a + t, n), zero))
    return grad


class _MaxPoolS1(torch.autograd.Function):
    """Stride-1 SAME max pool whose backward credits every tied maximum,
    stage by stage over T, H and W."""

    @staticmethod
    def forward(ctx, x, window):
        ctx.window = window
        ctx.save_for_backward(x)
        pad = [p for k in reversed(window) for p in ((k - 1) // 2, k - 1 - (k - 1) // 2)]
        return F.max_pool3d(F.pad(x, pad, value=float("-inf")), window, 1)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        stages, cur = [], x
        for dim, k in zip((2, 3, 4), ctx.window):
            if k > 1:
                y = _pool1d(cur, dim, k)
                stages.append((cur, y, dim, k))
                cur = y
        for cur, y, dim, k in reversed(stages):
            g = _pool1d_grad(cur, y, g, dim, k)
        return g, None


def max_pool(x, window, stride, run):
    """TF-SAME 3-D max pool, recorded as a `pool3d` kernel: its input read
    once and its output written once."""
    window, stride = tuple(window), tuple(stride)
    if stride == (1, 1, 1) and torch.is_grad_enabled() and x.requires_grad:
        y = _MaxPoolS1.apply(x, window)
    else:
        pad = _pad_list(x, window, stride)
        y = F.max_pool3d(F.pad(x, pad, value=float("-inf")), window, stride)
    run.record("pool3d", (x.numel() + y.numel()) * run.width)
    return y


def batch_norm(x, P, name, train, stats):
    """flax's BatchNorm in float32: running statistics, or in training the
    batch's (mean and the clamped E[x^2] - mean^2, kept in `stats`)."""
    shape = (1, -1, 1, 1, 1)
    if train:
        dims = (0, 2, 3, 4)
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
        stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    mul = torch.rsqrt(var.reshape(shape) + BN_EPS) * P[f"{name}.weight"].reshape(shape)
    return (x - mean.reshape(shape)) * mul + P[f"{name}.bias"].reshape(shape)


def unit(x, P, name, stride, run):
    x = conv3d_same(x, P[f"{name}.conv.weight"], None, stride, run.prec)
    return run.prec(F.relu(batch_norm(x, P, f"{name}.bn", run.train, run.stats)))


def inception(x, P, name, run):
    b3 = unit(max_pool(x, (3, 3, 3), (1, 1, 1), run), P, f"{name}.b3b", (1, 1, 1), run)
    b0 = unit(x, P, f"{name}.b0", (1, 1, 1), run)
    b1 = unit(unit(x, P, f"{name}.b1a", (1, 1, 1), run), P, f"{name}.b1b", (1, 1, 1), run)
    b2 = unit(unit(x, P, f"{name}.b2a", (1, 1, 1), run), P, f"{name}.b2b", (1, 1, 1), run)
    return torch.cat([b0, b1, b2, b3], dim=1)
