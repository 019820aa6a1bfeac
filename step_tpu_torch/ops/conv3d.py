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
from torch.utils.flop_counter import register_flop_formula

from step_tpu_torch.ops.fused_bn_relu import fused_scale_bias_relu_plain
from step_tpu_torch.utils.tensor_cache import derived


def conv3x3x3_bn_relu_plain(x: torch.Tensor, weight: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The weight rounded to x's dtype, as the kernel takes it; the
    convolution in float32 (the package keeps TF32 off), then the affine and
    the ReLU in float32, rounded once to x's dtype."""
    w = weight.to(x.dtype).to(torch.float32)
    y = F.conv3d(x.to(torch.float32), w, None, 1, 1)
    return fused_scale_bias_relu_plain(y, scale, bias).to(x.dtype)


def pack_conv3x3x3_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The bf16 kernel's weight layout: `[K, C, 3, 3, 3]` → a dense,
    zero-padded `[Kw, Rpad]` matrix in `dtype`, output channels by
    reduction index `tap * Cpad + c` (tap = 9*dt + 3*dh + dw), with C padded
    to Cpad, the reduction to Rpad and K to Kw
    (`kernels.conv_packed_shape`). Each row is contiguous along the
    reduction, as the kernel's K-major B tiles read it."""
    from step_tpu_torch import kernels

    K, C = weight.shape[:2]
    kw, rpad, cpad = kernels.conv_packed_shape(C, K)
    taps = weight.to(dtype).permute(0, 2, 3, 4, 1).reshape(K, 27, C)
    taps = F.pad(taps, (0, cpad - C)).reshape(K, 27 * cpad)
    return F.pad(taps, (0, rpad - 27 * cpad, 0, kw - K)).contiguous()


def kernel_weight(weight: torch.Tensor, dtype: torch.dtype,
                  cache: dict | None = None) -> torch.Tensor:
    """The weight as the kernel reads it for activations of `dtype`: packed
    by `pack_conv3x3x3_weight` for bfloat16, tap-major `[27, C, K]` for
    float32.

    With a `cache` (a dict its owner keeps, one per weight), the layout is
    made once and reused until the weight changes
    (`utils/tensor_cache.py::derived`): `load_state_dict` and `.to()` make
    it anew."""
    def make() -> torch.Tensor:
        if dtype == torch.float32:
            K, C = weight.shape[:2]
            return weight.to(dtype).permute(2, 3, 4, 1, 0).reshape(27, C, K).contiguous()
        return pack_conv3x3x3_weight(weight, dtype)

    return make() if cache is None else derived(cache, (weight,), make, dtype)


def unpack_kernel_weight(w: torch.Tensor, C: int, K: int) -> torch.Tensor:
    """`kernel_weight`'s layout back to OIDHW `[K, C, 3, 3, 3]`, in the
    layout's dtype: tap-major `[27, C, K]` (float32) or the packed
    `[Kw, Rpad]` matrix, whose padding is dropped."""
    if w.dim() == 3:
        return w.permute(2, 1, 0).reshape(K, C, 3, 3, 3)
    cpad = -(-C // 8) * 8                    # as `kernels.conv_packed_shape`
    taps = w[:K, :27 * cpad].reshape(K, 27, cpad)[:, :, :C]
    return taps.reshape(K, 3, 3, 3, C).permute(0, 4, 1, 2, 3)


@torch.library.custom_op("step::conv3x3x3_bn_relu", mutates_args=(), device_types="cpu")
def conv3x3x3_bn_relu_op(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """`step::conv3x3x3_bn_relu`, K3 as a custom operator, so that
    `torch.export` keeps it as one node of a served program: on a CPU
    tensor the plain version, on a CUDA tensor the kernel
    (`_conv3x3x3_bn_relu_cuda`), on a fake tensor the shape. x is
    `[N, C, T, H, W]`; w is the weight in the kernel's layout for x's
    dtype (`kernel_weight`), which the CPU version unpacks
    (`unpack_kernel_weight`); scale and bias are float32 `[K]`. Each
    returns a `channels_last_3d` tensor `[N, K, T, H, W]`."""
    weight = unpack_kernel_weight(w, x.shape[1], scale.shape[0])
    return conv3x3x3_bn_relu_plain(x, weight, scale, bias).contiguous(
        memory_format=torch.channels_last_3d)


@conv3x3x3_bn_relu_op.register_fake
def _conv3x3x3_bn_relu_fake(x, w, scale, bias):
    N, _, T, H, W = x.shape
    return torch.empty((N, scale.shape[0], T, H, W), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last_3d)


@conv3x3x3_bn_relu_op.register_kernel("cuda")
def _conv3x3x3_bn_relu_cuda(x, w, scale, bias):
    """The kernel (`csrc/conv3d.cu`), which reads the channels-last view of
    x (`kernels.ndhwc`: a tensor not in `channels_last_3d` order is copied
    into it first): in bfloat16 the tensor-core kernel, in float32 the
    CUDA-core kernel. Counted by `conv3x3x3_bn_relu.launches`."""
    from step_tpu_torch import kernels

    N, _, T, H, W = x.shape
    out = kernels.empty_ncdhw((N, scale.shape[0], T, H, W), x)
    kernels.conv3x3x3_bn_relu_forward(kernels.ndhwc(x), w, scale.contiguous(),
                                      bias.contiguous(), kernels.ndhwc(out))
    conv3x3x3_bn_relu.launches += 1
    return out


@register_flop_formula(torch.ops.step.conv3x3x3_bn_relu)
def _conv3x3x3_bn_relu_flop(x_shape, w_shape, scale_shape, bias_shape,
                            out_shape=None, **kwargs) -> int:
    """`torch.utils.flop_counter`'s count for `step::conv3x3x3_bn_relu`,
    which it cannot see into: 2·N·T·H·W·K·27·C, what its formula for aten's
    convolution counts at the same shape. The BN affine and the ReLU count
    nothing, as aten's elementwise ops count nothing."""
    N, C = x_shape[:2]
    T, H, W = out_shape[2:]
    return 2 * N * T * H * W * scale_shape[0] * 27 * C


def conv3x3x3_bn_relu(x: torch.Tensor, weight: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor,
                      weight_cache: dict | None = None) -> torch.Tensor:
    """relu(conv3d_SAME(x, weight) * scale + bias) for x `[N, C, T, H, W]`,
    weight `[K, C, 3, 3, 3]` (cast to x's dtype), scale and bias `[K]`
    (`conv3x3x3_bn_relu_plain`'s contract) → a `channels_last_3d` tensor
    `[N, K, T, H, W]`.

    The weight goes into the kernel's layout for x's dtype
    (`kernel_weight`; `weight_cache` keeps it between calls, and under
    `torch.export` the layout is made in the program), then through
    `step::conv3x3x3_bn_relu`: the hand-written kernel (`csrc/conv3d.cu`)
    on a CUDA tensor, the plain version on a CPU tensor. Inference only:
    the operator has no backward. `conv3x3x3_bn_relu.launches` counts
    kernel launches.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"conv3x3x3_bn_relu: no kernel for device {x.device}")
    K, C = weight.shape[0], x.shape[1]
    if tuple(weight.shape) != (K, C, 3, 3, 3):
        raise ValueError(f"conv3x3x3_bn_relu: weight {tuple(weight.shape)} is "
                         f"not [K, {C}, 3, 3, 3]")
    return conv3x3x3_bn_relu_op(x, kernel_weight(weight, x.dtype, weight_cache),
                                scale.to(torch.float32), bias.to(torch.float32))


conv3x3x3_bn_relu.launches = 0
