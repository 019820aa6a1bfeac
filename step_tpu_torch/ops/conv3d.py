"""3x3x3 conv + inference BN + ReLU: a plain PyTorch version and the kernel
wrapper.

Port of `step_tpu/ops/conv3d_pallas.py::conv3x3x3_bn_relu`:

    relu(conv3d_SAME(x, w) * scale + bias),  stride 1, float32 accumulation

with `scale`/`bias` the BN affine of `ops/fused_bn_relu.py::bn_scale_bias`.
This is an inference Unit3D with a 3x3x3 stride-1 kernel. Tensors are the
backbone's: x NCDHW in `channels_last_3d` memory order, the weight in
`nn.Conv3d`'s OIDHW layout `[K, C, 3, 3, 3]`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from step_tpu_torch.ops.fused_bn_relu import fused_scale_bias_relu_plain


def conv3x3x3_bn_relu_plain(x: torch.Tensor, weight: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The weight rounded to x's dtype, as the kernel takes it; the
    convolution in float32 (the package keeps TF32 off), then the affine and
    the ReLU in float32, rounded once to x's dtype."""
    w = weight.to(x.dtype).to(torch.float32)
    y = F.conv3d(x.to(torch.float32), w, None, 1, 1)
    return fused_scale_bias_relu_plain(y, scale, bias).to(x.dtype)


def conv3x3x3_bn_relu(x: torch.Tensor, weight: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """relu(conv3d_SAME(x, weight) * scale + bias) for x `[N, C, T, H, W]`,
    weight `[K, C, 3, 3, 3]` (cast to x's dtype), scale and bias `[K]`
    (`conv3x3x3_bn_relu_plain`'s contract) → `[N, K, T, H, W]`.

    A CUDA tensor goes to the hand-written kernel (`csrc/conv3d.cu`), which
    reads the channels-last view of x (`kernels.ndhwc`: a tensor not in
    `channels_last_3d` order is copied into it first) and tap-major weights
    `[27, C, K]`, and returns a `channels_last_3d` tensor. A CPU tensor goes
    to the plain version. `conv3x3x3_bn_relu.launches` counts kernel
    launches.
    """
    if x.device.type == "cpu":
        return conv3x3x3_bn_relu_plain(x, weight, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3x3x3_bn_relu: no kernel for device {x.device}")
    from step_tpu_torch import kernels

    N, C, T, H, W = x.shape
    K = weight.shape[0]
    if tuple(weight.shape) != (K, C, 3, 3, 3):
        raise ValueError(f"conv3x3x3_bn_relu: weight {tuple(weight.shape)} is "
                         f"not [K, {C}, 3, 3, 3]")
    taps = weight.to(x.dtype).permute(2, 3, 4, 1, 0).reshape(27, C, K).contiguous()
    out = kernels.empty_ncdhw((N, K, T, H, W), x)
    kernels.conv3x3x3_bn_relu_forward(
        kernels.ndhwc(x), taps, scale.to(torch.float32).contiguous(),
        bias.to(torch.float32).contiguous(), kernels.ndhwc(out))
    conv3x3x3_bn_relu.launches += 1
    return out


conv3x3x3_bn_relu.launches = 0
