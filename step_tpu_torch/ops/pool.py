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

`models/i3d.py::max_pool_3d` sends every pool of a CUDA tensor with
autograd off to these kernels; an eager call launches the kernel itself,
a traced one (`torch.export`) goes through the custom operator, so that
the program keeps its node. On a CPU tensor it takes the plain
versions, and `STEP_TPU_POOL3D=pallas` only decides whether a 3x3x3
stride-1 pool is the `step::max_pool3x3_same` node of a program traced
there; the strided pools of such a program stay PyTorch's.

Under autograd (an input that requires a gradient) the stride-1 pool goes
through `ops/pool_grad.py::max_pool_3d_s1_sepgrad`, whose forward is K5 on
the card and whose backward credits every tied maximum, as the JAX
package's default backward does; the strided pools keep PyTorch's forward
and backward.

The TPU kernel's VMEM guard (`pool_pallas.py:67-77`, which sends the large
28x28 Mixed_3 pools back to XLA) is not carried over: the CUDA kernel takes
every shape.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _eager_cuda(x: torch.Tensor) -> bool:
    """Whether a call may launch the kernel itself rather than through its
    custom operator: a plain CUDA tensor outside `torch.export` and
    `torch.compile` (a tracer's tensors are fake or functional, and the
    program must keep the operator's node). The operator's dispatch costs
    some 25-40 us of host time a call on an H100 machine (`PERF.md` §6),
    which a host-bound B=1 request would pay at each of its 16 pools."""
    return x.is_cuda and type(x) is torch.Tensor and not torch.compiler.is_compiling()


def max_pool3x3_same_plain(x: torch.Tensor) -> torch.Tensor:
    """`[N, C, T, H, W]` → the same shape: PyTorch's max pool, whose
    implicit padding is -inf."""
    return F.max_pool3d(x, 3, 1, 1)


def max_pool3x3_kernel(x: torch.Tensor) -> torch.Tensor:
    """Launch K5 (`csrc/pool3d.cu`) on a CUDA tensor and count the launch
    in `max_pool3x3_same.launches`. The kernel reads the channels-last
    view (`kernels.ndhwc`: a tensor not in `channels_last_3d` order is
    copied into it first) and returns a `channels_last_3d` tensor."""
    from step_tpu_torch import kernels

    out = kernels.empty_ncdhw(x.shape, x)
    kernels.max_pool3x3_forward(kernels.ndhwc(x), kernels.ndhwc(out))
    max_pool3x3_same.launches += 1
    return out


@torch.library.custom_op("step::max_pool3x3_same", mutates_args=(), device_types="cpu")
def max_pool3x3_same_op(x: torch.Tensor) -> torch.Tensor:
    """`step::max_pool3x3_same`, K5 as a custom operator, so that
    `torch.export` keeps it as one node of a served program: on a CPU
    tensor the plain version, on a CUDA tensor the kernel
    (`max_pool3x3_kernel`), on a fake tensor the shape. Each returns a
    `channels_last_3d` tensor."""
    return max_pool3x3_same_plain(x).contiguous(memory_format=torch.channels_last_3d)


@max_pool3x3_same_op.register_fake
def _max_pool3x3_same_fake(x):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last_3d)


max_pool3x3_same_op.register_kernel("cuda")(max_pool3x3_kernel)


def max_pool3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3x3x3 / stride 1 / SAME max pool of an NCDHW tensor
    (`max_pool3x3_same_plain`'s contract), bit for bit, as a
    `channels_last_3d` tensor.

    Through `step::max_pool3x3_same`: the hand-written kernel on a CUDA
    tensor, the plain version on a CPU tensor; an eager CUDA call launches
    the kernel without the operator's dispatch (`_eager_cuda`). The
    operator is inference only; under autograd both devices go through
    `pool_grad.max_pool_3d_s1_sepgrad`, so the result has a `grad_fn`.
    `max_pool3x3_same.launches` counts kernel launches.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"max_pool3x3_same: no kernel for device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        from step_tpu_torch.ops.pool_grad import max_pool_3d_s1_sepgrad

        return max_pool_3d_s1_sepgrad(x, (3, 3, 3))
    if _eager_cuda(x):
        return max_pool3x3_kernel(x)
    return max_pool3x3_same_op(x)


max_pool3x3_same.launches = 0


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


def max_pool3d_same_kernel(x: torch.Tensor, window: list[int],
                           stride: list[int]) -> torch.Tensor:
    """Launch `csrc/pool3d_same.cu` on a CUDA tensor and count the launch in
    `max_pool3d_same.launches`. The kernel reads the channels-last view
    (`kernels.ndhwc`, which copies a tensor in another order first) and
    returns a `channels_last_3d` tensor."""
    from step_tpu_torch import kernels

    out = kernels.empty_ncdhw(max_pool3d_same_shape(x.shape, stride), x)
    kernels.max_pool3d_same_forward(kernels.ndhwc(x), kernels.ndhwc(out), window, stride)
    max_pool3d_same.launches += 1
    return out


@torch.library.custom_op("step::max_pool3d_same", mutates_args=(), device_types="cpu")
def max_pool3d_same_op(x: torch.Tensor, window: list[int], stride: list[int]) -> torch.Tensor:
    """`step::max_pool3d_same`, the strided pool kernel as a custom
    operator, so that `torch.export` keeps it as one node: on a CPU tensor
    the plain version, on a CUDA tensor the kernel
    (`max_pool3d_same_kernel`), on a fake tensor the shape. Each returns a
    `channels_last_3d` tensor."""
    return max_pool3d_same_plain(x, window, stride).contiguous(
        memory_format=torch.channels_last_3d)


@max_pool3d_same_op.register_fake
def _max_pool3d_same_fake(x, window, stride):
    return torch.empty(max_pool3d_same_shape(x.shape, stride), dtype=x.dtype,
                       device=x.device, memory_format=torch.channels_last_3d)


max_pool3d_same_op.register_kernel("cuda")(max_pool3d_same_kernel)


def max_pool3d_same(x: torch.Tensor, window, stride) -> torch.Tensor:
    """Max pool of an NCDHW tensor with TF-SAME padding of -inf, each
    window 1 to 3 and each stride 1 or 2 (`max_pool3d_same_plain`'s
    contract), bit for bit, as a `channels_last_3d` tensor.

    Through `step::max_pool3d_same`: the hand-written kernel on a CUDA
    tensor, the plain version on a CPU tensor; an eager CUDA call launches
    the kernel without the operator's dispatch (`_eager_cuda`). It
    refuses, on either
    device, a window or stride outside the kernel's contract
    (`kernels.max_pool3d_same_contract`), and an input that requires a
    gradient: it is inference only (`models/i3d.py::max_pool_3d` keeps
    PyTorch's pool and backward there). `max_pool3d_same.launches` counts
    kernel launches.
    """
    from step_tpu_torch import kernels

    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"max_pool3d_same: no kernel for device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError("max_pool3d_same is inference only: its input requires a gradient")
    window, stride = kernels.max_pool3d_same_contract(window, stride)
    if _eager_cuda(x):
        return max_pool3d_same_kernel(x, list(window), list(stride))
    return max_pool3d_same_op(x, list(window), list(stride))


max_pool3d_same.launches = 0
