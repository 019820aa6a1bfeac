"""The I3D stem unit's convolution, Conv3d_1a_7x7: a plain PyTorch version
and the kernel wrapper.

    relu?(conv3d_SAME(x, w, stride (2, 2, 2)) * scale? + bias?)

over 2 or 3 input channels to 64, float32 accumulation, rounded once to x's
dtype. The JAX package recasts this convolution for the TPU's matrix unit
(`step_tpu/ops/stem_conv.py::space_to_depth_conv3d`); the port computes it
with a hand-written Hopper kernel (`csrc/stem_conv.cu`) on every inference
stem unit of a bf16 CUDA tensor (`models/i3d.py::Unit3D`). The epilogue is
the unit's: the folded BN's bias, or the BN affine of `fused_bn_relu`,
then the ReLU; or nothing, where an unfolded BN and the ReLU follow.
Tensors are the backbone's: x NCDHW in `channels_last_3d` memory order,
the weight in `nn.Conv3d`'s OIDHW layout `[64, C, 7, 7, 7]`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from step_tpu_torch.ops.kernel_op import kernel_op
from step_tpu_torch.ops.pool import same_padding
from step_tpu_torch.utils.tensor_cache import derived

KERNEL = (7, 7, 7)
STRIDE = (2, 2, 2)


def stem_conv_plain(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor | None = None,
                    bias: torch.Tensor | None = None, relu: bool = True) -> torch.Tensor:
    """The weight rounded to x's dtype, as the kernel takes it; the
    TF-SAME convolution in float32 (`models/i3d.py::conv3d_same`'s
    padding), then the scale, the bias and the ReLU in float32, rounded once
    to x's dtype."""
    w = weight.to(x.dtype).to(torch.float32)
    y = x.to(torch.float32)
    sym, pad = same_padding(y, KERNEL, STRIDE)
    y = F.conv3d(y, w, None, STRIDE, sym) if sym is not None else F.conv3d(
        F.pad(y, pad), w, None, STRIDE)
    shape = (1, -1, 1, 1, 1)
    if scale is not None:
        y = y * scale.to(torch.float32).reshape(shape)
    if bias is not None:
        y = y + bias.to(torch.float32).reshape(shape)
    return (torch.relu(y) if relu else y).to(x.dtype)


def pack_stem_weight(weight: torch.Tensor) -> torch.Tensor:
    """The kernel's weight layout: `[64, C, 7, 7, 7]` → a dense bf16
    `[64, Rpad]` matrix whose column `(7 dt + dh) * seg + C dw + c` holds
    tap (dt, dh, dw) of channel c: each (dt, dh) row segment is the 7 dw
    taps x C channels in the input's NDHWC order, zero-padded to `seg`
    (`kernels.stem_packed_shape`), and the segments to Rpad."""
    from step_tpu_torch import kernels

    K, C = weight.shape[:2]
    seg, rpad = kernels.stem_packed_shape(C)
    rows = weight.to(torch.bfloat16).permute(0, 2, 3, 4, 1).reshape(K, 49, 7 * C)
    rows = F.pad(rows, (0, seg - 7 * C)).reshape(K, 49 * seg)
    return F.pad(rows, (0, rpad - 49 * seg)).contiguous()


def unpack_stem_weight(w: torch.Tensor, C: int) -> torch.Tensor:
    """`pack_stem_weight`'s layout back to OIDHW `[64, C, 7, 7, 7]`."""
    from step_tpu_torch import kernels

    seg, _ = kernels.stem_packed_shape(C)
    taps = w[:, :49 * seg].reshape(w.shape[0], 49, seg)[:, :, :7 * C]
    return taps.reshape(w.shape[0], 7, 7, 7, C).permute(0, 4, 1, 2, 3)


def stem_kernel_weight(weight: torch.Tensor, cache: dict | None = None) -> torch.Tensor:
    """The packed weight (`pack_stem_weight`); with a `cache` (a dict its
    owner keeps), made once and reused until the weight changes
    (`utils/tensor_cache.py::derived`): `load_state_dict` and `.to()` make
    it anew, and under `torch.export` it is made in the program."""
    make = lambda: pack_stem_weight(weight)  # noqa: E731
    return make() if cache is None else derived(cache, (weight,), make)


def _out_shape(x_shape) -> tuple:
    N, _, T, H, W = x_shape
    return (N, 64, -(-T // 2), -(-H // 2), -(-W // 2))


def _stem_conv_cpu(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None,
                   bias: torch.Tensor | None, relu: bool) -> torch.Tensor:
    """`step::stem_conv`, the stem kernel: on a CPU tensor the plain version,
    on a CUDA tensor `csrc/stem_conv.cu`. x is `[N, C, T, H, W]`; w the
    packed weight (`stem_kernel_weight`), which the CPU version unpacks;
    scale and bias float32 `[64]` or None. Each returns a `channels_last_3d`
    tensor `[N, 64, ceil(T/2), ceil(H/2), ceil(W/2)]`."""
    weight = unpack_stem_weight(w, x.shape[1])
    return stem_conv_plain(x, weight, scale, bias, relu).contiguous(
        memory_format=torch.channels_last_3d)


def _stem_conv_fake(x, w, scale, bias, relu):
    return torch.empty(_out_shape(x.shape), dtype=x.dtype, device=x.device,
                       memory_format=torch.channels_last_3d)


def _stem_conv_launch(x, w, scale, bias, relu):
    """The kernel reads the channels-last view of x in place."""
    from step_tpu_torch import kernels

    out = kernels.empty_ncdhw(_out_shape(x.shape), x)
    kernels.stem_conv_forward(x.permute(0, 2, 3, 4, 1), w, scale, bias, kernels.ndhwc(out),
                              relu)
    return out


def _stem_conv_flop(x_shape, w_shape, scale_shape, bias_shape, relu, out_shape=None,
                    **kwargs) -> int:
    """`torch.utils.flop_counter`'s count for `step::stem_conv`:
    2·N·T'·H'·W'·64·343·C, what its formula for aten's convolution counts
    at the same shape; the epilogue counts nothing."""
    N, C = x_shape[:2]
    T, H, W = out_shape[2:]
    return 2 * N * T * H * W * 64 * 343 * C


stem_conv_op = kernel_op("stem_conv", _stem_conv_cpu, _stem_conv_launch, _stem_conv_fake,
                         _stem_conv_flop)


def stem_kernel_takes(x: torch.Tensor, weight: torch.Tensor, stride) -> bool:
    """Whether the kernel takes this stem unit's call: a bf16 CUDA tensor,
    a `[64, C, 7, 7, 7]` weight with C 2 or 3, stride (2, 2, 2)."""
    from step_tpu_torch import kernels

    return (x.is_cuda and x.dtype == torch.bfloat16 and tuple(stride) == STRIDE
            and weight.dim() == 5 and tuple(weight.shape[2:]) == KERNEL
            and weight.shape[0] == kernels.STEM_OUT and weight.shape[1] in kernels.STEM_CHANNELS)


def stem_conv(x: torch.Tensor, weight: torch.Tensor, scale: torch.Tensor | None = None,
              bias: torch.Tensor | None = None, relu: bool = True,
              weight_cache: dict | None = None) -> torch.Tensor:
    """relu?(conv3d_SAME(x, weight, stride 2) * scale? + bias?) for a bf16 x
    `[N, C, T, H, W]` in `channels_last_3d` order, C 2 or 3, weight
    `[64, C, 7, 7, 7]`, scale and bias `[64]` or None (`stem_conv_plain`'s
    contract) → a `channels_last_3d` bf16 tensor `[N, 64, ceil(T/2),
    ceil(H/2), ceil(W/2)]`.

    The weight goes into the kernel's layout (`stem_kernel_weight`;
    `weight_cache` keeps it between calls), then through `step::stem_conv`:
    the hand-written kernel (`csrc/stem_conv.cu`) on a CUDA tensor, which
    reads x in place, the plain version on a CPU tensor. It refuses, on
    either device, another dtype, shape or memory order. Inference only:
    the operator has no backward."""
    from step_tpu_torch import kernels

    if x.dtype != torch.bfloat16:
        raise ValueError(f"stem_conv takes bfloat16 activations, got {x.dtype}")
    if x.dim() != 5 or x.shape[1] not in kernels.STEM_CHANNELS:
        raise ValueError(f"stem_conv: x {tuple(x.shape)} is not [N, C, T, H, W] with C in "
                         f"{kernels.STEM_CHANNELS}")
    C = x.shape[1]
    if tuple(weight.shape) != (kernels.STEM_OUT, C, *KERNEL):
        raise ValueError(f"stem_conv: weight {tuple(weight.shape)} is not "
                         f"[{kernels.STEM_OUT}, {C}, 7, 7, 7]")
    if not x.permute(0, 2, 3, 4, 1).is_contiguous():
        raise ValueError("stem_conv reads x in place: it must be in channels_last_3d order")
    f32 = lambda t: None if t is None else t.to(torch.float32).reshape(-1).contiguous()  # noqa: E731
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None and t.numel() != kernels.STEM_OUT:
            raise ValueError(f"stem_conv: {name} has {t.numel()} values, not "
                             f"{kernels.STEM_OUT}")
    return stem_conv_op(x, stem_kernel_weight(weight, weight_cache), f32(scale), f32(bias),
                        bool(relu))
