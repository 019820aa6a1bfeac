"""The backbone's 3-D max pools with TF-SAME padding of -inf: plain PyTorch
versions and the kernel wrappers.

K5, `max_pool3x3_same`: the 3x3x3 stride-1 pool, port of
`step_tpu/ops/pool_pallas.py::max_pool3x3_same_pallas`, the Inception
b3-branch pool. `max_pool3d_same`: every other window up to 3 and stride
up to 2 on each axis (the stem's MaxPool_2a, 3a and 4a, the classifier's
MaxPool_5a), a kernel of the port's own (`csrc/pool3d_same.cu`; the JAX
package leaves these pools to XLA's `reduce_window`). The window is padded
with -inf, so a border output is the max over the taps inside the tensor.
Tensors are the backbone's: NCDHW, in `channels_last_3d` memory order.

`max_pool_same`, the one entry point of `models/i3d.py::max_pool_3d` for a
pool with autograd off, picks the kernel: K5 for 3x3x3 stride 1, the
strided kernel otherwise. Both are `step::` operators
(`ops/kernel_op.py`): on the CPU their bodies are the plain versions, on
the card the kernels; an eager CUDA call launches the kernel itself, a
traced one (`torch.export`, on either device) is one node of the program.

Under autograd (an input that requires a gradient) `max_pool_3d` sends a
stride-1 pool to `ops/pool_grad.py::max_pool_3d_s1_sepgrad`, whose forward
is K5 on the card and whose backward credits every tied maximum, as the
JAX package's default backward does, and a strided pool to
`max_pool3d_same_plain`, PyTorch's forward and backward.

The TPU kernel's VMEM guard (`pool_pallas.py:67-77`, which sends the large
28x28 Mixed_3 pools back to XLA) is not carried over: the CUDA kernel takes
every shape.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from step_tpu_torch.ops.kernel_op import kernel_op


def max_pool3x3_same_plain(x: torch.Tensor) -> torch.Tensor:
    """`[N, C, T, H, W]` → the same shape: PyTorch's max pool, whose
    implicit padding is -inf."""
    return F.max_pool3d(x, 3, 1, 1)


def _max_pool3x3_cpu(x: torch.Tensor) -> torch.Tensor:
    """`step::max_pool3x3_same`, K5: the plain version
    (`max_pool3x3_same_plain`) in `channels_last_3d` order on a CPU tensor,
    `csrc/pool3d.cu` on a CUDA tensor."""
    return max_pool3x3_same_plain(x).contiguous(memory_format=torch.channels_last_3d)


def _max_pool3x3_launch(x):
    """K5 reads the channels-last view (`kernels.ndhwc`: a tensor not in
    `channels_last_3d` order is copied into it first)."""
    from step_tpu_torch import kernels

    out = kernels.empty_ncdhw(x.shape, x)
    kernels.max_pool3x3_forward(kernels.ndhwc(x), kernels.ndhwc(out))
    return out


def _max_pool3x3_fake(x):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last_3d)


# 3x3x3 / stride 1 / SAME max pool of an NCDHW tensor, bit for bit the
# plain version's, as a `channels_last_3d` tensor; inference only.
max_pool3x3_same = kernel_op("max_pool3x3_same", _max_pool3x3_cpu, _max_pool3x3_launch,
                             _max_pool3x3_fake)


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """TF-SAME (low, high) padding of an axis of size n for kernel k, stride s."""
    pad = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


def same_padding(x: torch.Tensor, kernel, stride):
    """TF-SAME padding of an NCDHW tensor for a pool or a conv (`models/
    i3d.py::conv3d_same`): (symmetric padding, None) where PyTorch's
    implicit padding gives it, else (None, the `F.pad` list)."""
    pads = [same_pads(x.shape[2 + i], kernel[i], stride[i]) for i in range(3)]
    if all(lo == hi and 2 * lo <= k for (lo, hi), k in zip(pads, kernel)):
        return tuple(lo for lo, _ in pads), None
    return None, [p for lo_hi in reversed(pads) for p in lo_hi]


def max_pool3d_same_plain(x: torch.Tensor, window, stride) -> torch.Tensor:
    """Max pool of an NCDHW tensor with TF-SAME padding of -inf: PyTorch's
    implicit padding where the pads are even and fit its limit, else
    `F.pad(x, pads, value=-inf)` followed by `F.max_pool3d`."""
    window, stride = tuple(window), tuple(stride)
    sym, pad = same_padding(x, window, stride)
    if sym is not None:
        return F.max_pool3d(x, window, stride, sym)
    return F.max_pool3d(F.pad(x, pad, value=float("-inf")), window, stride)


def max_pool3d_same_shape(shape, stride) -> tuple:
    """The NCDHW output shape of a SAME pool: ceil(n / s) on T, H and W."""
    return (*shape[:2], *(-(-n // s) for n, s in zip(shape[2:], stride)))


def _max_pool3d_same_cpu(x: torch.Tensor, window: list[int],
                         stride: list[int]) -> torch.Tensor:
    """`step::max_pool3d_same`, the strided pool: the plain version
    (`max_pool3d_same_plain`) in `channels_last_3d` order on a CPU tensor,
    `csrc/pool3d_same.cu` on a CUDA tensor."""
    return max_pool3d_same_plain(x, window, stride).contiguous(
        memory_format=torch.channels_last_3d)


def _max_pool3d_same_launch(x, window, stride):
    """The kernel reads the channels-last view (`kernels.ndhwc`, which
    copies a tensor in another order first)."""
    from step_tpu_torch import kernels

    out = kernels.empty_ncdhw(max_pool3d_same_shape(x.shape, stride), x)
    kernels.max_pool3d_same_forward(kernels.ndhwc(x), kernels.ndhwc(out), window, stride)
    return out


def _max_pool3d_same_fake(x, window, stride):
    return torch.empty(max_pool3d_same_shape(x.shape, stride), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last_3d)


max_pool3d_same_op = kernel_op("max_pool3d_same", _max_pool3d_same_cpu,
                               _max_pool3d_same_launch, _max_pool3d_same_fake)


def max_pool3d_same(x: torch.Tensor, window, stride) -> torch.Tensor:
    """Max pool of an NCDHW tensor with TF-SAME padding of -inf, each
    window 1 to 3 and each stride 1 or 2 (`max_pool3d_same_plain`'s
    contract), bit for bit, as a `channels_last_3d` tensor, through
    `step::max_pool3d_same`. It refuses, on either device, a window or
    stride outside the kernel's contract
    (`kernels.max_pool3d_same_contract`), and an input that requires a
    gradient: it is inference only (`models/i3d.py::max_pool_3d` keeps
    PyTorch's pool and backward there)."""
    from step_tpu_torch import kernels

    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("max_pool3d_same is inference only: its input requires a gradient")
    window, stride = kernels.max_pool3d_same_contract(window, stride)
    return max_pool3d_same_op(x, list(window), list(stride))


def max_pool_same(x: torch.Tensor, window, stride) -> torch.Tensor:
    """The inference max pool of `models/i3d.py::max_pool_3d`: K5
    (`max_pool3x3_same`) for a 3x3x3 stride-1 window, the strided kernel
    (`max_pool3d_same`) for every other, which refuses a window over 3 or a
    stride over 2. On the CPU the operators' bodies are the plain versions."""
    if tuple(window) == (3, 3, 3) and tuple(stride) == (1, 1, 1):
        return max_pool3x3_same(x)
    return max_pool3d_same(x, window, stride)
