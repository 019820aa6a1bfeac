"""A served Inception block of the heads' I3D tail as one operator, and the
heads' 1x1x1 conv with bias and ReLU: plain PyTorch versions and the kernel
wrappers.

`step::inception_block` runs one BN-folded, fused block (`fused_inception`:
b0, b1a and b2a as one 1x1x1 conv "b012"), with the widths
`channels` = (c0, c1, c2, c3, c4, c5) of `models/i3d.py::
INCEPTION_CHANNELS`:

    y  = relu(conv1x1x1(x, w012) + b012)            # [b0 | b1 | b2], c0 + c1 + c3
    out = cat(y[:c0],
              relu(conv3x3x3(y[c0:c0+c1], w1b) + b1b),
              relu(conv3x3x3(y[c0+c1:], w2b) + b2b),
              relu(conv1x1x1(maxpool3x3x3(x), w3b) + b3b))

`inception_block_plain` is that math as the model computes it without the
operator (`InceptionBlock.forward`: each unit a conv with its bias in x's
dtype and a ReLU; the slices and the concatenation). On the card the
operator allocates the block's output and one dense scratch for b012's
b1|b2 columns, and launches, in order (`_inception_block_launch`):

  1. b012 on the 1x1x1 GEMM (`csrc/gemm.cu`): its epilogue writes the b0
     columns into the output's first c0 channels and the b1|b2 columns
     into the scratch;
  2. b1b and b2b on the tube conv (`csrc/conv3d.cu::tube_conv_kernel`,
     the 3x3x3 conv over the 7x7 grid), each reading its channel slice of
     the scratch in place and writing its slice of the output;
  3. the 3x3x3 max pool (K5, `ops/pool.py::max_pool3x3_same`) of x;
  4. b3b on the 1x1x1 GEMM from the pooled map into the output's last c5
     channels.

Every epilogue adds the bias to the float32 accumulator, applies the ReLU,
rounds once to bf16 and stores into the output's slice: no bias, ReLU, copy
or concatenation pass. `step::conv1x1x1_bias_relu` is the same GEMM for
the head's `reg_reduce` (1024 → 64). Both take bf16 on the card; tensors
are NCDHW in `channels_last_3d` memory order, weights in the kernels'
layouts (`block_kernel_weights`), biases float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from step_tpu_torch.ops.conv3d import (pack_conv_weight, pack_tube_weight,
                                       unpack_kernel_weight, unpack_tube_weight)
from step_tpu_torch.ops.kernel_op import kernel_op
from step_tpu_torch.ops.pool import max_pool3x3_same, max_pool3x3_same_plain
from step_tpu_torch.utils.tensor_cache import derived


def _unit(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """A BN-folded stride-1 Unit3D as the model runs it: the conv with its
    bias in x's dtype (SAME padding of a 1x1x1 or 3x3x3 kernel), the ReLU."""
    return F.relu(F.conv3d(x, weight.to(x.dtype), bias.to(x.dtype), 1, weight.shape[2] // 2))


def inception_block_plain(x: torch.Tensor, w012: torch.Tensor, b012: torch.Tensor,
                          w1b: torch.Tensor, b1b: torch.Tensor, w2b: torch.Tensor,
                          b2b: torch.Tensor, w3b: torch.Tensor, b3b: torch.Tensor,
                          channels) -> torch.Tensor:
    """A BN-folded, fused Inception block on x `[N, Cin, T, H, W]`, with the
    units' OIDHW weights and biases: `InceptionBlock.forward`'s ops, in its
    order, on the same layouts (the pool's output in `channels_last_3d`
    order, as K5's operator returns it) → `[N, c0 + c2 + c4 + c5, T, H, W]`."""
    c0, c1 = channels[0], channels[1]
    pooled = max_pool3x3_same_plain(x).contiguous(memory_format=torch.channels_last_3d)
    b3 = _unit(pooled, w3b, b3b)
    y = _unit(x, w012, b012)
    b1, b2 = y[:, c0: c0 + c1], y[:, c0 + c1:]
    return torch.cat([y[:, :c0], _unit(b1, w1b, b1b), _unit(b2, w2b, b2b), b3], dim=1)


def kernel_takes(x: torch.Tensor, cin: int, channels) -> bool:
    """Whether the block's kernels take it: a bf16 CUDA tensor on the 7x7
    ROI grid (the tube conv's), Cin and every width a multiple of 8
    (16-byte rows and stores at every slice)."""
    from step_tpu_torch import kernels

    return (x.is_cuda and x.dtype == torch.bfloat16 and x.dim() == 5
            and tuple(x.shape[3:]) == (kernels.TUBE_GRID,) * 2
            and all(c % 8 == 0 for c in (cin, *channels)))


def block_kernel_weights(tensors, dtype: torch.dtype, cache: dict | None = None) -> tuple:
    """The operator's weight arguments from the four units' (weight, bias)
    pairs `tensors` = (w012, b012, w1b, b1b, w2b, b2b, w3b, b3b), or one
    1x1x1 pair: each weight packed in `dtype`, a 1x1x1 one for the GEMM
    (`pack_conv_weight`), a 3x3x3 one for the tube conv
    (`pack_tube_weight`), each bias rounded to `dtype` (as the unit
    adds it) and held in float32. With a `cache` (a dict its owner keeps)
    they are made once and reused until a tensor changes
    (`utils/tensor_cache.py::derived`); under `torch.export` they are made in
    the program."""
    def pack(w: torch.Tensor) -> torch.Tensor:
        return (pack_tube_weight if w.shape[2] == 3 else pack_conv_weight)(w, dtype)

    def make() -> tuple:
        return tuple(pack(t) if i % 2 == 0 else t.to(dtype).to(torch.float32)
                     for i, t in enumerate(tensors))

    return make() if cache is None else derived(cache, tuple(tensors), make, dtype)


def _out_shape(x_shape, channels) -> tuple:
    N, _, T, H, W = x_shape
    c0, _, c2, _, c4, c5 = channels
    return (N, c0 + c2 + c4 + c5, T, H, W)


def _inception_block_cpu(x: torch.Tensor, w012: torch.Tensor, b012: torch.Tensor,
                         w1b: torch.Tensor, b1b: torch.Tensor, w2b: torch.Tensor,
                         b2b: torch.Tensor, w3b: torch.Tensor, b3b: torch.Tensor,
                         channels: list[int]) -> torch.Tensor:
    """`step::inception_block`: on a CPU tensor the plain version, on a CUDA
    tensor the block's kernels. x is `[N, Cin, T, H, W]`; the weights are
    packed (`block_kernel_weights`), which the CPU version unpacks; the
    biases float32; `channels` the block's six widths. Each returns a
    `channels_last_3d` tensor `[N, c0 + c2 + c4 + c5, T, H, W]`."""
    c0, c1, c2, c3, c4, c5 = channels
    cin = x.shape[1]
    weights = (unpack_kernel_weight(w012, cin, c0 + c1 + c3, 1), b012,
               unpack_tube_weight(w1b, c1, c2), b1b, unpack_tube_weight(w2b, c3, c4), b2b,
               unpack_kernel_weight(w3b, cin, c5, 1), b3b)
    return inception_block_plain(x, *weights, channels).contiguous(
        memory_format=torch.channels_last_3d)


def _inception_block_fake(x, w012, b012, w1b, b1b, w2b, b2b, w3b, b3b, channels):
    return torch.empty(_out_shape(x.shape, channels), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last_3d)


def _inception_block_launch(x, w012, b012, w1b, b1b, w2b, b2b, w3b, b3b, channels):
    """The block's four convs and its pool, each writing in place (the
    module's note); x is read as its channels-last view (`kernels.ndhwc`)."""
    from step_tpu_torch import kernels

    c0, c1, c2, c3, c4, c5 = channels
    out = kernels.empty_ncdhw(_out_shape(x.shape, channels), x)
    o = kernels.ndhwc(out)
    xr = kernels.ndhwc(x)
    scratch = torch.empty((*xr.shape[:4], c1 + c3), dtype=x.dtype, device=x.device)
    kernels.igemm_forward(xr, w012, None, b012, (o[..., :c0], scratch), 1)
    kernels.tube_conv_forward(scratch[..., :c1], w1b, b1b, o[..., c0: c0 + c2])
    kernels.tube_conv_forward(scratch[..., c1:], w2b, b2b, o[..., c0 + c2: c0 + c2 + c4])
    pooled = kernels.ndhwc(max_pool3x3_same(x))
    kernels.igemm_forward(pooled, w3b, None, b3b, (o[..., c0 + c2 + c4:],), 1)
    return out


def _inception_block_flop(x_shape, w012, b012, w1b, b1b, w2b, b2b, w3b, b3b, channels,
                          out_shape=None, **kwargs) -> int:
    """`torch.utils.flop_counter`'s count for `step::inception_block`: the
    four convs' 2·M·(products a position), as its formula for aten's
    convolution counts them; the pool and the epilogues count nothing."""
    c0, c1, c2, c3, c4, c5 = channels
    N, cin, T, H, W = x_shape
    return 2 * N * T * H * W * (cin * (c0 + c1 + c3) + 27 * (c1 * c2 + c3 * c4) + cin * c5)


inception_block_op = kernel_op("inception_block", _inception_block_cpu,
                               _inception_block_launch, _inception_block_fake,
                               _inception_block_flop)


def inception_block(x: torch.Tensor, weights, channels) -> torch.Tensor:
    """A BN-folded, fused Inception block (`inception_block_plain`'s
    contract) on x `[N, Cin, T, H, W]`, with `weights` from
    `block_kernel_weights` → a `channels_last_3d` tensor
    `[N, c0 + c2 + c4 + c5, T, H, W]`, through `step::inception_block`: the
    block's kernels on a CUDA tensor, the plain version on a CPU tensor.
    Inference only: the operator has no backward."""
    return inception_block_op(x, *weights, [int(c) for c in channels])


def _conv1x1x1_cpu(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """`step::conv1x1x1_bias_relu`: relu(conv1x1x1(x, w) + bias) on x
    `[N, C, T, H, W]`, w packed (`pack_conv_weight`), bias float32 `[K]`: on
    a CPU tensor the plain version (`_unit`, the conv with its bias in x's
    dtype and the ReLU), on a CUDA tensor `csrc/gemm.cu`. Each returns a
    `channels_last_3d` tensor `[N, K, T, H, W]`."""
    weight = unpack_kernel_weight(w, x.shape[1], bias.shape[0], 1)
    return _unit(x, weight, bias).contiguous(memory_format=torch.channels_last_3d)


def _conv1x1x1_fake(x, w, bias):
    N, _, T, H, W = x.shape
    return torch.empty((N, bias.shape[0], T, H, W), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last_3d)


def _conv1x1x1_launch(x, w, bias):
    from step_tpu_torch import kernels

    N, _, T, H, W = x.shape
    out = kernels.empty_ncdhw((N, bias.shape[0], T, H, W), x)
    kernels.igemm_forward(kernels.ndhwc(x), w, None, bias, (kernels.ndhwc(out),), 1)
    return out


def _conv1x1x1_flop(x_shape, w_shape, bias_shape, out_shape=None, **kwargs) -> int:
    N, C, T, H, W = x_shape
    return 2 * N * T * H * W * C * bias_shape[0]


conv1x1x1_bias_relu_op = kernel_op("conv1x1x1_bias_relu", _conv1x1x1_cpu, _conv1x1x1_launch,
                                   _conv1x1x1_fake, _conv1x1x1_flop)


def conv1x1x1_bias_relu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        cache: dict | None = None) -> torch.Tensor:
    """relu(conv1x1x1(x, weight) + bias) for x `[N, C, T, H, W]`, weight
    `[K, C, 1, 1, 1]`, bias `[K]`, the bias rounded to x's dtype as the model
    adds it → a `channels_last_3d` tensor `[N, K, T, H, W]`, through
    `step::conv1x1x1_bias_relu` (`cache` as `block_kernel_weights`'s)."""
    w, b = block_kernel_weights((weight, bias), x.dtype, cache)
    return conv1x1x1_bias_relu_op(x, w, b)
