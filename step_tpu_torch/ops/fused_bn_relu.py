"""Inference BatchNorm + ReLU: a plain PyTorch version and the kernel wrapper.

Port of `step_tpu/ops/fused_bn_relu.py`: `fused_scale_bias_relu` computes
max(x * scale + bias, 0) in float32 and rounds once to x's dtype;
`bn_relu_inference` first derives, in float32 from the float32 BN
parameters,

    scale = gamma / sqrt(var + eps)        bias = beta - mean * scale

Tensors are the backbone's: NCDHW, in `channels_last_3d` memory order, with
the per-channel vectors on axis 1.
"""

from __future__ import annotations

import torch

from step_tpu_torch.ops.kernel_op import kernel_op


def bn_scale_bias(gamma: torch.Tensor, beta: torch.Tensor, mean: torch.Tensor,
                  var: torch.Tensor, eps: float = 1e-3):
    """The inference BN affine as float32 (scale, bias) `[C]`."""
    f32 = lambda t: t.to(torch.float32)  # noqa: E731
    scale = f32(gamma) * torch.rsqrt(f32(var) + eps)
    return scale, f32(beta) - f32(mean) * scale


def fused_scale_bias_relu_plain(x: torch.Tensor, scale: torch.Tensor,
                                bias: torch.Tensor) -> torch.Tensor:
    """`[N, C, T, H, W]` → max(x * scale + bias, 0) in float32, rounded once
    to x's dtype."""
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = x.to(torch.float32) * scale.to(torch.float32).reshape(shape)
    y = y + bias.to(torch.float32).reshape(shape)
    return torch.relu(y).to(x.dtype)


def _scale_bias_relu_cpu(x: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """`step::scale_bias_relu`, K4: on a CPU tensor the plain version, on a
    CUDA tensor `csrc/bn_relu.cu`. x is `[N, C, T, H, W]`, scale and bias
    float32 `[C]`; each returns a `channels_last_3d` tensor."""
    return fused_scale_bias_relu_plain(x, scale, bias).contiguous(
        memory_format=torch.channels_last_3d)


def _scale_bias_relu_fake(x, scale, bias):
    return torch.empty(x.shape, dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last_3d)


def _scale_bias_relu_launch(x, scale, bias):
    """The kernel runs over the `[rows, C]` channels-last view
    (`kernels.ndhwc`: a tensor not in `channels_last_3d` order is copied
    into it first)."""
    from step_tpu_torch import kernels

    C = x.shape[1]
    out = kernels.empty_ncdhw(x.shape, x)
    kernels.scale_bias_relu_forward(kernels.ndhwc(x).reshape(-1, C), scale.contiguous(),
                                    bias.contiguous(), kernels.ndhwc(out).view(-1, C))
    return out


scale_bias_relu_op = kernel_op("scale_bias_relu", _scale_bias_relu_cpu,
                               _scale_bias_relu_launch, _scale_bias_relu_fake)


def fused_scale_bias_relu(x: torch.Tensor, scale: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """max(x * scale + bias, 0) over an NCDHW tensor
    (`fused_scale_bias_relu_plain`'s contract), as a `channels_last_3d`
    tensor, through `step::scale_bias_relu`: the hand-written kernel
    (`csrc/bn_relu.cu`) on a CUDA tensor, the plain version on a CPU
    tensor. Inference only: the operator has no backward."""
    return scale_bias_relu_op(x, scale.to(torch.float32), bias.to(torch.float32))


def bn_relu_inference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      mean: torch.Tensor, var: torch.Tensor,
                      eps: float = 1e-3) -> torch.Tensor:
    """Inference BN + ReLU from the raw BN parameters, through
    `fused_scale_bias_relu`."""
    return fused_scale_bias_relu(x, *bn_scale_bias(gamma, beta, mean, var, eps))

