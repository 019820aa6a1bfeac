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

import weakref

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
    made once and reused while the weight is the same tensor with the same
    storage and version counter: an in-place write such as
    `load_state_dict` bumps the counter, and `.to()` gives new storage, so
    either makes it anew."""
    key = (weight.data_ptr(), weight._version, weight.device, weight.dtype, dtype)
    if cache is not None and cache.get("key") == key and cache["ref"]() is weight:
        return cache["w"]
    if dtype == torch.float32:
        K, C = weight.shape[:2]
        w = weight.to(dtype).permute(2, 3, 4, 1, 0).reshape(27, C, K).contiguous()
    else:
        w = pack_conv3x3x3_weight(weight, dtype)
    if cache is not None:
        cache.update(key=key, ref=weakref.ref(weight), w=w)
    return w


def conv3x3x3_bn_relu(x: torch.Tensor, weight: torch.Tensor,
                      scale: torch.Tensor, bias: torch.Tensor,
                      weight_cache: dict | None = None) -> torch.Tensor:
    """relu(conv3d_SAME(x, weight) * scale + bias) for x `[N, C, T, H, W]`,
    weight `[K, C, 3, 3, 3]` (cast to x's dtype), scale and bias `[K]`
    (`conv3x3x3_bn_relu_plain`'s contract) → `[N, K, T, H, W]`.

    A CUDA tensor goes to the hand-written kernel (`csrc/conv3d.cu`), which
    reads the channels-last view of x (`kernels.ndhwc`: a tensor not in
    `channels_last_3d` order is copied into it first) and returns a
    `channels_last_3d` tensor: in bfloat16 the tensor-core kernel, with the
    weight packed by `pack_conv3x3x3_weight`; in float32 the CUDA-core
    kernel, with tap-major weights `[27, C, K]`. `weight_cache` keeps that
    layout between calls (`kernel_weight`). A CPU tensor goes to the plain
    version. `conv3x3x3_bn_relu.launches` counts kernel launches.
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
    w = kernel_weight(weight, x.dtype, weight_cache)
    out = kernels.empty_ncdhw((N, K, T, H, W), x)
    kernels.conv3x3x3_bn_relu_forward(
        kernels.ndhwc(x), w, scale.to(torch.float32).contiguous(),
        bias.to(torch.float32).contiguous(), kernels.ndhwc(out))
    conv3x3x3_bn_relu.launches += 1
    return out


conv3x3x3_bn_relu.launches = 0
