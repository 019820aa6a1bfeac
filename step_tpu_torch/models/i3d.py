"""I3D — the Inflated 3D Inception-v1 backbone.

Port of `step_tpu/models/i3d.py`: `Unit3D` (:138-197), `max_pool_3d`
(:213-261), `InceptionBlock` (:264-319), `I3DStem` (:322-378), `I3DTail`
(:381-414) at depths "full" and "tiny", and `I3DClassifier` (:417-456).
Tensors are NCDHW here; the detector hands in channels-last data as a
permuted view, so the backbone runs in `channels_last_3d` memory order.

Padding is TensorFlow's SAME rule, as in the released I3D checkpoints: the
total pad is max((ceil(n/s) - 1)*s + k - n, 0), with the odd extra cell on
the high side — asymmetric on every strided conv and pool. Pools pad with
-inf. BatchNorm has eps 1e-3; it runs on its running statistics, or is
folded into the conv (`bn_folded`, weights from
`models/optimize.py::fold_bn`), or, with `train=True`, on the batch
statistics as flax's train-mode BatchNorm does (`BatchNorm.forward`).

Training (`train=True`, passed down every module as flax passes it): each
unit runs conv → train-mode BN → ReLU, never a fused form (the JAX
package takes the fused BN + ReLU only in inference, `step_tpu/models/
i3d.py:186`), and a BN-folded unit refuses. Under autograd every stride-1
max pool goes through `ops/pool_grad.py::max_pool_3d_s1_sepgrad` (K5 on
the card for 3x3x3), whose backward credits every tied maximum as the JAX
package's default does; strided pools keep PyTorch's pool and backward.

Pools in inference (`max_pool_3d`) go to `ops/pool.py::max_pool_same`,
which picks the kernel: on the card every max pool runs a hand-written
channels-last kernel, whatever the configuration; on the CPU the
operators' bodies, the plain versions.

Inference variants, as in the JAX package:
  * `fused_bn_relu` (BN not folded): each Unit3D's BN + ReLU runs through
    `ops/fused_bn_relu.py` (kernel K4); a 3x3x3 stride-1 unit runs conv, BN
    and ReLU as one `ops/conv3d.py` call (kernel K3), whose contract is
    exactly that unit's;
  * the stem unit (Conv3d_1a_7x7) of a bf16 CUDA tensor with autograd off
    runs the hand-written stem kernel (`ops/stem_conv.py`) in every
    variant, the unit's bias or BN affine and its ReLU in the epilogue;
  * `fused_inception` (BN folded): an Inception block's three 1x1x1 branch
    convs run as one conv "b012", then split; `fused_inception3` also runs
    the two 3x3x3 branch convs as one block-diagonal conv "b12" (weights
    from `models/optimize.py`);
  * the heads' tail (`I3DTail`) of BN-folded, fused blocks (not
    `fused_inception3`) on a bf16 CUDA tensor with autograd off runs each
    block as one `ops/inception.py::inception_block`: every conv adds its
    bias and applies the ReLU in its epilogue and stores into its channel
    slice of the block's output. The stem's blocks keep the module path.

Weights are kept in whatever dtype the module was moved to and cast to the
activation dtype at each call (the JAX package keeps float32 parameters and
casts them to its compute dtype).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from step_tpu_torch.ops.conv3d import conv3x3x3_bn_relu
from step_tpu_torch.ops.fused_bn_relu import bn_scale_bias, fused_scale_bias_relu
from step_tpu_torch.ops.inception import block_kernel_weights, inception_block, kernel_takes
from step_tpu_torch.ops.pool import max_pool3d_same_plain, max_pool_same, same_padding
from step_tpu_torch.ops.pool_grad import max_pool_3d_s1_sepgrad
from step_tpu_torch.ops.stem_conv import stem_conv, stem_kernel_takes
from step_tpu_torch.parallel.distributed import all_reduce_sum
from step_tpu_torch.utils.spans import span
from step_tpu_torch.utils.tensor_cache import derived

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
BN_MOMENTUM = 0.9           # flax's running-average decay (`step_tpu/models/i3d.py:44`)


def conv3d_same(x: torch.Tensor, weight: torch.Tensor,
                bias: torch.Tensor | None, stride) -> torch.Tensor:
    """3-D convolution with TF-SAME padding; weights cast to x's dtype."""
    w = weight.to(x.dtype)
    b = None if bias is None else bias.to(x.dtype)
    sym, pad = same_padding(x, w.shape[2:], stride)
    if sym is not None:
        return F.conv3d(x, w, b, stride, sym)
    return F.conv3d(F.pad(x, pad), w, b, stride)


def max_pool_3d(x: torch.Tensor, window, stride) -> torch.Tensor:
    """3-D max pool with TF-SAME padding of -inf, routed on autograd alone.

    Under autograd a stride-1 pool goes to `ops/pool_grad.py::
    max_pool_3d_s1_sepgrad` and a strided one to PyTorch's pool and its
    backward (`max_pool3d_same_plain`). Every other call goes to
    `ops/pool.py::max_pool_same`, which picks the kernel on either device."""
    if torch.is_grad_enabled() and x.requires_grad:
        if tuple(stride) == (1, 1, 1):
            return max_pool_3d_s1_sepgrad(x, window)
        return max_pool3d_same_plain(x, window, stride)
    return max_pool_same(x, window, stride)


class BatchNorm(nn.Module):
    """BatchNorm over channel axis 1, eps 1e-3; its state maps one to one
    onto the JAX package's scale/bias and mean/var.

    It computes in float32 and rounds once to x's dtype, with flax's order
    of operations, (x - mean) * (rsqrt(var + eps) * gamma) + beta
    (flax `nn.BatchNorm(dtype=...)`, `step_tpu/models/i3d.py:188-194`).

    `train=True` normalizes with the batch's statistics as flax does: mean
    and E[x^2] - mean^2 (flax's fast variance, clamped at 0) reduced in
    float32 over every axis but the channels, gradients flowing through
    both. The running statistics are not touched in the forward: it keeps
    the batch's (mean, biased variance) in `batch_stats`, and
    `running_updates` gives flax's running update from them. The trainer
    commits that update after the backward, so a forward that
    `torch.utils.checkpoint` runs again leaves the same values, not a
    second update.

    In a data-parallel train step (`batch_group` set to the "data" axis's
    process group, `train/trainer.py::make_parallel_train_step`) the
    statistics are the global batch's, as GSPMD computes them for the JAX
    package: the per-channel sum and sum of squares in float32, summed over
    the ranks in one differentiable all-reduce, then flax's one-pass
    formula on the global element count. Every rank issues the same
    collectives in the same order, the remat recompute included."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self._affine = {}           # scale_bias(), reused while the state holds
        self.batch_stats = None     # (mean, var) of the last train-mode batch
        self.batch_group = None     # the process group of a data-parallel step

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        f32 = lambda t: t.to(torch.float32).reshape(shape)  # noqa: E731
        x32 = x.to(torch.float32)
        if train:
            dims = (0,) + tuple(range(2, x.dim()))
            if self.batch_group is None:
                mean = x32.mean(dim=dims)
                var = torch.clamp((x32 * x32).mean(dim=dims) - mean * mean, min=0.0)
            else:
                group = self.batch_group
                n = x32.numel() // x32.shape[1] * dist.get_world_size(group)
                sums = all_reduce_sum(torch.cat([x32.sum(dim=dims),
                                                 (x32 * x32).sum(dim=dims)]), group)
                mean, mean2 = (sums / n).chunk(2)
                var = torch.clamp(mean2 - mean * mean, min=0.0)
            self.batch_stats = (mean.detach(), var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(f32(var) + BN_EPS) * f32(self.weight)
        y = (x32 - f32(mean)) * mul + f32(self.bias)
        return y.to(x.dtype)

    def scale_bias(self):
        """The float32 affine (scale, bias) `[C]` of this BN.

        With autograd off (serving) it is computed once and reused until
        one of the four state tensors changes (`utils/tensor_cache.py::
        derived`): `load_state_dict` and `.to()` recompute it. With
        autograd on it is computed on every call, so that gradients reach
        the parameters."""
        state = (self.weight, self.bias, self.running_mean, self.running_var)
        make = lambda: bn_scale_bias(*state, BN_EPS)  # noqa: E731
        return make() if torch.is_grad_enabled() else derived(self._affine, state, make)


@torch.no_grad()
def running_updates(bns):
    """flax's running update of the BatchNorms `bns` from their last
    train-mode batch: (means, variances), each momentum * running +
    (1 - momentum) * batch (the biased variance), in multi-tensor ops."""
    def ema(running, batch):
        return torch._foreach_add(torch._foreach_mul(running, BN_MOMENTUM),
                                  torch._foreach_mul(batch, 1 - BN_MOMENTUM))

    return (ema([b.running_mean for b in bns], [b.batch_stats[0] for b in bns]),
            ema([b.running_var for b in bns], [b.batch_stats[1] for b in bns]))


class Unit3D(nn.Module):
    """Conv3D → BatchNorm → ReLU (reference `Unit3D`, :138-197). With
    `bn_folded` the BatchNorm is gone and the conv carries a bias;
    `bn_folded` wins over `fused_bn_relu`, as in the JAX package. With
    `fused_bn_relu` a 3x3x3 stride-1 unit runs as one `conv3x3x3_bn_relu`
    and any other as conv + `fused_scale_bias_relu`.

    The stem unit (7x7x7, stride 2, 2 or 3 channels to 64) of a bf16 CUDA
    tensor with autograd off runs `ops/stem_conv.py::stem_conv`, the
    hand-written kernel, in every variant: with the folded bias and the
    ReLU, with `fused_bn_relu`'s affine and the ReLU, or alone before an
    unfolded BN and the ReLU. Training, autograd, float32 and the CPU keep
    `conv3d_same`."""

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

    def _stem_kernel(self, x: torch.Tensor) -> bool:
        if not stem_kernel_takes(x, self.conv.weight, self.stride):
            return False
        return not (torch.is_grad_enabled()
                    and any(t.requires_grad for t in (x, *self.parameters())))

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        if train:
            if self.bn is None:
                raise ValueError(
                    "a BN-folded unit cannot train: folding (optimize_for_inference) "
                    "replaces the BatchNorm and its statistics by a conv bias; "
                    "train the unfolded tree and fold it afterwards")
            x = conv3d_same(x, self.conv.weight, self.conv.bias, self.stride)
            return F.relu(self.bn(x, train=True))
        if self.conv_bn_relu:
            return conv3x3x3_bn_relu(x, self.conv.weight, *self.bn.scale_bias(),
                                     weight_cache=self._kernel_weight)
        if self._stem_kernel(x):
            if self.bn is None:
                return stem_conv(x, self.conv.weight, None, self.conv.bias,
                                 weight_cache=self._kernel_weight)
            if self.fused:
                return stem_conv(x, self.conv.weight, *self.bn.scale_bias(),
                                 weight_cache=self._kernel_weight)
            x = stem_conv(x, self.conv.weight, relu=False, weight_cache=self._kernel_weight)
            return F.relu(self.bn(x))
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
        self.cin = cin
        self.out_channels = c[0] + c[2] + c[4] + c[5]
        self._kernel_weights = {}   # the operator's weight layouts, reused

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        c = self.channels
        b3 = self.b3b(max_pool_3d(x, (3, 3, 3), (1, 1, 1)), train)
        if self.fused_inception:
            y = self.b012(x, train)
            b0 = y[:, : c[0]]
            if self.fused_inception3:
                return torch.cat([b0, self.b12(y[:, c[0]:], train), b3], dim=1)
            b1, b2 = y[:, c[0]: c[0] + c[1]], y[:, c[0] + c[1]:]
        else:
            b0, b1, b2 = self.b0(x, train), self.b1a(x, train), self.b2a(x, train)
        return torch.cat([b0, self.b1b(b1, train), self.b2b(b2, train), b3], dim=1)

    def forward_kernel(self, x: torch.Tensor) -> torch.Tensor:
        """The same block, BN-folded and fused, in inference, as one
        `step::inception_block` (`ops/inception.py`): the block's kernels on
        the card, `forward`'s math on the CPU."""
        units = (self.b012, self.b1b, self.b2b, self.b3b)
        tensors = [t for u in units for t in (u.conv.weight, u.conv.bias)]
        weights = block_kernel_weights(tensors, x.dtype, self._kernel_weights)
        return inception_block(x, weights, self.channels)


class I3DStem(nn.Module):
    """I3D from the input clip through Mixed_4f, the shared detection
    feature (:322-378): `[B, in_channels, T, H, W]` (3 for RGB, 2 for
    flow) → `[B, 832, T/4, H/16, W/16]` at depth "full", `[B, 128, T/4,
    H/8, W/8]` at depth "tiny"."""

    def __init__(self, depth: str = "full", bn_folded: bool = False,
                 fused_bn_relu: bool = False, fused_inception: bool = False,
                 fused_inception3: bool = False, in_channels: int = 3):
        super().__init__()
        unit = lambda i, o, k, s: Unit3D(i, o, k, s, bn_folded,  # noqa: E731
                                         fused_bn_relu)
        blk = lambda i, ch: InceptionBlock(  # noqa: E731
            i, ch, bn_folded, fused_bn_relu, fused_inception, fused_inception3)
        if depth == "tiny":
            self.Conv3d_1a_7x7 = unit(in_channels, 16, (3, 7, 7), (2, 2, 2))
            self.Mixed_3b = blk(16, TINY_A)
            self.Mixed_4f = blk(self.Mixed_3b.out_channels, TINY_B)
            self.out_channels = self.Mixed_4f.out_channels
        elif depth == "full":
            self.Conv3d_1a_7x7 = unit(in_channels, 64, (7, 7, 7), (2, 2, 2))
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

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        with span("model.stem"):
            x = self.Conv3d_1a_7x7(x, train)
        if self.depth == "tiny":
            x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
            x = self.Mixed_3b(x, train)
            x = max_pool_3d(x, (3, 3, 3), (2, 2, 2))
            return self.Mixed_4f(x, train)
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x, train), train)
        x = max_pool_3d(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x, train), train)
        x = max_pool_3d(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x, train)
        return x


class I3DTail(nn.Module):
    """Mixed_5b + Mixed_5c ("full") or one Mixed_5c ("tiny"), run by every
    refinement step's head on pooled tube features (:381-414). The heads
    skip the classifier's MaxPool_5a, keeping the 7x7 ROI grid; the
    classifier passes `pool_5a=True` for the 2x2x2 stride-2 SAME max pool
    before the blocks.

    The tail owns the served form of its blocks (`block_kernel`): in
    inference on a bf16 CUDA tensor with autograd off, BN-folded blocks
    fused by `fused_inception` (and not `fused_inception3`) run as one
    `step::inception_block` each. Training, autograd, float32, the CPU, the
    unfolded kernel configuration and `fused_inception3` run `forward` of
    each block."""

    def __init__(self, cin: int, depth: str = "full", bn_folded: bool = False,
                 fused_bn_relu: bool = False, fused_inception: bool = False,
                 fused_inception3: bool = False, pool_5a: bool = False):
        super().__init__()
        self.pool_5a = pool_5a
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

    def block_kernel(self, x: torch.Tensor, train: bool = False) -> bool:
        """Whether the blocks run as `step::inception_block` on input x."""
        blocks = [getattr(self, name) for name in self.blocks]
        if train or not all(b.fused_inception and not b.fused_inception3
                            and b.b012.bn is None for b in blocks):
            return False
        if torch.is_grad_enabled() and (
                x.requires_grad or any(p.requires_grad for p in self.parameters())):
            return False
        return all(kernel_takes(x, b.cin, b.channels) for b in blocks)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        kernel = self.block_kernel(x, train)
        if self.pool_5a:
            x = max_pool_3d(x, (2, 2, 2), (2, 2, 2))
        for name in self.blocks:
            block = getattr(self, name)
            x = block.forward_kernel(x) if kernel else block(x, train)
        return x


class I3DClassifier(nn.Module):
    """The whole I3D as a video classifier with the Kinetics head
    (`step_tpu/models/i3d.py:417-456`): the stem, the tail after MaxPool_5a,
    the spatial mean (time kept), dropout, a 1x1x1 `logits` conv with bias,
    and the mean of the logits over time (the TF I3D convention).

    It takes the detector's variant flags (`bn_folded`, `fused_bn_relu`,
    `fused_inception`), so under `fused_bn_relu` its units run kernels K3
    and K4; on the card its pools run K5 and `ops/pool.py::max_pool3d_same`
    in any configuration. Weights come from
    `models/convert.py::convert_torch_i3d` or the JAX package's tree through
    `step_tpu_torch/convert.py::from_jax_classifier_variables`."""

    def __init__(self, num_classes: int = 400, dropout_rate: float = 0.5,
                 bn_folded: bool = False, fused_bn_relu: bool = False,
                 fused_inception: bool = False):
        super().__init__()
        variants = (bn_folded, fused_bn_relu, fused_inception)
        self.stem = I3DStem("full", *variants)
        self.tail = I3DTail(self.stem.out_channels, "full", *variants, pool_5a=True)
        self.dropout_rate = dropout_rate
        self.logits = nn.Conv3d(self.tail.out_channels, num_classes, (1, 1, 1))

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x `[B, T, H, W, 3]` channels-last, normalized (`preprocess.
        device_preprocess`), computed in x's dtype → logits `[B,
        num_classes]` in that dtype. `train` runs the BatchNorms on the batch
        statistics and, with a dropout rate, drops features by a mask drawn
        from `generator`."""
        from step_tpu_torch.models.nets import _dropout, draw_dropout_masks

        x = self.tail(self.stem(x.permute(0, 4, 1, 2, 3), train), train)
        x = x.mean(dim=(3, 4), keepdim=True)                 # [B, C, T', 1, 1]
        if train and self.dropout_rate > 0:
            if generator is None:
                raise ValueError("training with dropout needs a torch.Generator "
                                 "for its mask (generator=...)")
            keep, = draw_dropout_masks((x.shape,), self.dropout_rate, generator, x.device)
            x = _dropout(x, keep, self.dropout_rate)
        x = conv3d_same(x, self.logits.weight, self.logits.bias, (1, 1, 1))
        return x.mean(dim=(2, 3, 4))
