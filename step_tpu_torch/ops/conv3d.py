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
from step_tpu_torch.ops.kernel_op import kernel_op
from step_tpu_torch.utils.tensor_cache import derived


def conv3x3x3_bn_relu_plain(x: torch.Tensor, weight: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The weight rounded to x's dtype, as the kernel takes it; the
    convolution in float32 (the package keeps TF32 off), then the affine and
    the ReLU in float32, rounded once to x's dtype."""
    w = weight.to(x.dtype).to(torch.float32)
    y = F.conv3d(x.to(torch.float32), w, None, 1, 1)
    return fused_scale_bias_relu_plain(y, scale, bias).to(x.dtype)


def pack_conv_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The bf16 tensor-core kernel's weight layout (`csrc/igemm.cuh`) of a
    cubic conv with k^3 taps (k 3 or 1): `[K, C, k, k, k]` → a dense,
    zero-padded `[Kw, Rpad]` matrix in `dtype`, output channels by reduction
    index `tap * Cpad + c` (tap = 9*dt + 3*dh + dw for k = 3), with C padded
    to Cpad, the reduction to Rpad and K to Kw
    (`kernels.conv_packed_shape`). Each row is contiguous along the
    reduction, as the kernel's K-major B tiles read it."""
    from step_tpu_torch import kernels

    K, C = weight.shape[:2]
    taps = weight[0, 0].numel()
    kw, rpad, cpad = kernels.conv_packed_shape(C, K, taps)
    rows = weight.to(dtype).permute(0, 2, 3, 4, 1).reshape(K, taps, C)
    rows = F.pad(rows, (0, cpad - C)).reshape(K, taps * cpad)
    return F.pad(rows, (0, rpad - taps * cpad, 0, kw - K)).contiguous()


def _swizzled(tiles: torch.Tensor) -> torch.Tensor:
    """`[..., rows, 8, 8]` (16-byte pieces of 128-byte rows) with piece j of
    row r moved to j ^ (r mod 8), wgmma's 128-byte swizzle; its own
    inverse."""
    rows = torch.arange(tiles.shape[-3], device=tiles.device)
    piece = torch.arange(8, device=tiles.device)[None, :] ^ (rows[:, None] % 8)
    return torch.gather(tiles, -2, piece[:, :, None].expand(tiles.shape))


def pack_tube_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The tube conv's weight layout (`csrc/conv3d.cu::tube_conv_kernel`,
    which takes bf16): `[K, C, 3, 3, 3]` → `[tiles, steps, tile width, 64]`
    in `dtype` (`kernels.tube_packed_shape`): for each output-channel tile,
    the B tile of each step (a chunk of 64 channels, then a tap) in the
    order the kernel reads them, zero past C and K, each tile's 128-byte
    rows already in wgmma's 128-byte swizzle (`_swizzled`), so one bulk copy
    lands a step's tile as the tensor cores read it."""
    from step_tpu_torch import kernels

    K, C = weight.shape[:2]
    tiles, steps, bn, chunk = kernels.tube_packed_shape(C, K)
    taps = weight.to(dtype).permute(0, 2, 3, 4, 1).reshape(K, 27, C)
    taps = F.pad(taps, (0, steps // 27 * chunk - C, 0, 0, 0, tiles * bn - K))
    taps = taps.reshape(tiles, bn, 27, steps // 27, 8, 8).permute(0, 3, 2, 1, 4, 5)
    return _swizzled(taps).reshape(tiles, steps, bn, chunk).contiguous()


def unpack_tube_weight(w: torch.Tensor, C: int, K: int) -> torch.Tensor:
    """`pack_tube_weight`'s layout back to OIDHW `[K, C, 3, 3, 3]` in its
    dtype, contiguous."""
    tiles, steps, bn, chunk = w.shape
    taps = _swizzled(w.reshape(tiles, steps // 27, 27, bn, 8, 8)).permute(0, 3, 2, 1, 4, 5)
    taps = taps.reshape(tiles * bn, 27, -1)[:K, :, :C]
    return taps.reshape(K, 3, 3, 3, C).permute(0, 4, 1, 2, 3).contiguous()


def kernel_weight(weight: torch.Tensor, dtype: torch.dtype,
                  cache: dict | None = None) -> torch.Tensor:
    """The weight as the kernel reads it for activations of `dtype`: packed
    by `pack_conv_weight` for bfloat16, tap-major `[27, C, K]` for
    float32.

    With a `cache` (a dict its owner keeps, one per weight), the layout is
    made once and reused until the weight changes
    (`utils/tensor_cache.py::derived`): `load_state_dict` and `.to()` make
    it anew."""
    def make() -> torch.Tensor:
        if dtype == torch.float32:
            K, C = weight.shape[:2]
            return weight.to(dtype).permute(2, 3, 4, 1, 0).reshape(27, C, K).contiguous()
        return pack_conv_weight(weight, dtype)

    return make() if cache is None else derived(cache, (weight,), make, dtype)


def unpack_kernel_weight(w: torch.Tensor, C: int, K: int, k: int = 3) -> torch.Tensor:
    """`kernel_weight`'s layout back to OIDHW `[K, C, k, k, k]`, in the
    layout's dtype: tap-major `[27, C, K]` (float32, k = 3) or the packed
    `[Kw, Rpad]` matrix of `pack_conv_weight`, whose padding is dropped;
    contiguous, as the module's weight is, so that a CPU convolution takes
    the same path on either."""
    if w.dim() == 3:
        return w.permute(2, 1, 0).reshape(K, C, 3, 3, 3).contiguous()
    taps = k ** 3
    cpad = -(-C // 8) * 8                    # as `kernels.conv_packed_shape`
    rows = w[:K, :taps * cpad].reshape(K, taps, cpad)[:, :, :C]
    return rows.reshape(K, k, k, k, C).permute(0, 4, 1, 2, 3).contiguous()


def _conv3x3x3_bn_relu_cpu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """`step::conv3x3x3_bn_relu`, K3: on a CPU tensor the plain version, on a
    CUDA tensor `csrc/conv3d.cu`. x is `[N, C, T, H, W]`; w is the weight in
    the kernel's layout for x's dtype (`kernel_weight`), which the CPU
    version unpacks (`unpack_kernel_weight`); scale and bias are float32
    `[K]`. Each returns a `channels_last_3d` tensor `[N, K, T, H, W]`."""
    weight = unpack_kernel_weight(w, x.shape[1], scale.shape[0])
    return conv3x3x3_bn_relu_plain(x, weight, scale, bias).contiguous(
        memory_format=torch.channels_last_3d)


def _conv3x3x3_bn_relu_fake(x, w, scale, bias):
    N, _, T, H, W = x.shape
    return torch.empty((N, scale.shape[0], T, H, W), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last_3d)


def _conv3x3x3_bn_relu_launch(x, w, scale, bias):
    """The kernel reads the channels-last view of x (`kernels.ndhwc`: a
    tensor not in `channels_last_3d` order is copied into it first): in
    bfloat16 the tensor-core kernel, in float32 the CUDA-core kernel."""
    from step_tpu_torch import kernels

    N, _, T, H, W = x.shape
    out = kernels.empty_ncdhw((N, scale.shape[0], T, H, W), x)
    kernels.conv3x3x3_bn_relu_forward(kernels.ndhwc(x), w, scale.contiguous(),
                                      bias.contiguous(), kernels.ndhwc(out))
    return out


def _conv3x3x3_bn_relu_flop(x_shape, w_shape, scale_shape, bias_shape,
                            out_shape=None, **kwargs) -> int:
    """`torch.utils.flop_counter`'s count for `step::conv3x3x3_bn_relu`,
    which it cannot see into: 2·N·T·H·W·K·27·C, what its formula for aten's
    convolution counts at the same shape. The BN affine and the ReLU count
    nothing, as aten's elementwise ops count nothing."""
    N, C = x_shape[:2]
    T, H, W = out_shape[2:]
    return 2 * N * T * H * W * scale_shape[0] * 27 * C


conv3x3x3_bn_relu_op = kernel_op("conv3x3x3_bn_relu", _conv3x3x3_bn_relu_cpu,
                                 _conv3x3x3_bn_relu_launch, _conv3x3x3_bn_relu_fake,
                                 _conv3x3x3_bn_relu_flop)


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
    the operator has no backward.
    """
    K, C = weight.shape[0], x.shape[1]
    if tuple(weight.shape) != (K, C, 3, 3, 3):
        raise ValueError(f"conv3x3x3_bn_relu: weight {tuple(weight.shape)} is "
                         f"not [K, {C}, 3, 3, 3]")
    return conv3x3x3_bn_relu_op(x, kernel_weight(weight, x.dtype, weight_cache),
                                scale.to(torch.float32), bias.to(torch.float32))
