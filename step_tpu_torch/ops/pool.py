"""3x3x3 max pool, stride 1, SAME: a plain PyTorch version and the kernel
wrapper.

Port of `step_tpu/ops/pool_pallas.py::max_pool3x3_same_pallas`, the
Inception b3-branch pool, which `models/i3d.py::max_pool_3d` takes when
`STEP_TPU_POOL3D=pallas`. The window is padded with -inf, so a border
output is the max over the taps inside the tensor. Tensors are the
backbone's: NCDHW, in `channels_last_3d` memory order.

Under autograd (an input that requires a gradient) the pool goes through
`ops/pool_grad.py::max_pool_3d_s1_sepgrad`, whose forward is this kernel
on the card and whose backward credits every tied maximum, as the JAX
package's default backward does.

The TPU kernel's VMEM guard (`pool_pallas.py:67-77`, which sends the large
28x28 Mixed_3 pools back to XLA) is not carried over: the CUDA kernel takes
every shape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    tensor, the plain version on a CPU tensor. The operator is inference
    only; under autograd both devices go through
    `pool_grad.max_pool_3d_s1_sepgrad`, so the result has a `grad_fn`.
    `max_pool3x3_same.launches` counts kernel launches.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"max_pool3x3_same: no kernel for device {x.device}")
    if torch.is_grad_enabled() and x.requires_grad:
        from step_tpu_torch.ops.pool_grad import max_pool_3d_s1_sepgrad

        return max_pool_3d_s1_sepgrad(x, (3, 3, 3))
    return max_pool3x3_same_op(x)


max_pool3x3_same.launches = 0
