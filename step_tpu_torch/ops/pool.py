"""3x3x3 max pool, stride 1, SAME: a plain PyTorch version and the kernel
wrapper.

Port of `step_tpu/ops/pool_pallas.py::max_pool3x3_same_pallas`, the
Inception b3-branch pool, which `models/i3d.py::max_pool_3d` takes when
`STEP_TPU_POOL3D=pallas`. The window is padded with -inf, so a border
output is the max over the taps inside the tensor. Tensors are the
backbone's: NCDHW, in `channels_last_3d` memory order.

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


def max_pool3x3_same(x: torch.Tensor) -> torch.Tensor:
    """3x3x3 / stride 1 / SAME max pool of an NCDHW tensor
    (`max_pool3x3_same_plain`'s contract), bit for bit.

    A CUDA tensor goes to the hand-written kernel (`csrc/pool3d.cu`), which
    reads the channels-last view (`kernels.ndhwc`: a tensor not in
    `channels_last_3d` order is copied into it first) and returns a
    `channels_last_3d` tensor. A CPU tensor goes to the plain version.
    `max_pool3x3_same.launches` counts kernel launches.
    """
    if x.device.type == "cpu":
        return max_pool3x3_same_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"max_pool3x3_same: no kernel for device {x.device}")
    from step_tpu_torch import kernels

    out = kernels.empty_ncdhw(x.shape, x)
    kernels.max_pool3x3_forward(kernels.ndhwc(x), kernels.ndhwc(out))
    max_pool3x3_same.launches += 1
    return out


max_pool3x3_same.launches = 0
