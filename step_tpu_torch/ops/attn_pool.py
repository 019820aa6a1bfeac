"""MViTv2's attention pools: a plain PyTorch version and the kernel wrapper.

One part (q, k or v) of a block's qkv GEMM output `[B, T·H·W, 3·dim_out]`,
its `heads` heads of d channels each:

    LN_d(conv3d(part, w, stride (1, s, s), padding 1, groups d))  → [B, h, N', d]

the depthwise 3x3x3 convolution with one `[d, 1, 3, 3, 3]` weight shared by
the heads, then the LayerNorm over d (`models/mvit.py::MultiScaleAttention`).
On a CUDA tensor it is the hand-written kernel `csrc/attn_pool.cu`, which
reads the part in place and keeps the conv's float32 sums for the norm; on a
CPU tensor the plain version. The JAX package has no MViTv2 and no such
kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from step_tpu_torch.ops.kernel_op import kernel_op


def attn_pool_plain(qkv: torch.Tensor, part: int, heads: int, size, stride,
                    weight: torch.Tensor, norm_weight: torch.Tensor, norm_bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """The part's heads as channel-major `[B·h, d, T, H, W]`, the weights
    rounded to qkv's dtype, then in float32 the depthwise conv
    (`F.conv3d(groups=d)`, padding 1, `stride`) and the LayerNorm over d of
    its `[B, h, N', d]` view, rounded once to qkv's dtype, contiguous."""
    B, _, C = qkv.shape
    dim_out = C // 3
    d = dim_out // heads
    x = qkv[..., part * dim_out:(part + 1) * dim_out].float()
    x = x.reshape(B, *size, heads, d).permute(0, 4, 5, 1, 2, 3).reshape(B * heads, d, *size)
    f32 = lambda t: t.to(qkv.dtype).float()  # noqa: E731
    y = F.conv3d(x, f32(weight), None, tuple(stride), 1, 1, d)
    y = y.reshape(B, heads, d, -1).transpose(2, 3)
    y = F.layer_norm(y, (d,), f32(norm_weight), f32(norm_bias), eps)
    return y.to(qkv.dtype).contiguous()


def _attn_pool_cpu(qkv: torch.Tensor, weight: torch.Tensor, norm_weight: torch.Tensor,
                   norm_bias: torch.Tensor, part: int, heads: int, size: list[int],
                   stride: list[int], eps: float) -> torch.Tensor:
    """`step::attn_pool`, an MViTv2 attention pool: on a CPU tensor the
    plain version (`attn_pool_plain`), on a CUDA tensor `csrc/attn_pool.cu`.
    Both return a contiguous `[B, heads, N', d]` in qkv's dtype."""
    return attn_pool_plain(qkv, part, heads, size, stride, weight, norm_weight, norm_bias, eps)


def _attn_pool_fake(qkv, weight, norm_weight, norm_bias, part, heads, size, stride, eps):
    from step_tpu_torch import kernels

    return qkv.new_empty(kernels.attn_pool_shape(qkv.shape, heads, size, stride))


def _attn_pool_launch(qkv, weight, norm_weight, norm_bias, part, heads, size, stride, eps):
    """The kernel reads qkv in place (`kernels.attn_pool_contract` refuses
    what it does not take)."""
    from step_tpu_torch import kernels

    out = qkv.new_empty(kernels.attn_pool_shape(qkv.shape, heads, size, stride))
    kernels.attn_pool_forward(qkv, part, heads, size, stride, weight, norm_weight, norm_bias,
                              eps, out)
    return out


def _attn_pool_flop(qkv_shape, weight_shape, norm_weight_shape, norm_bias_shape, part, heads,
                    size, stride, eps, out_shape=None, **kwargs) -> int:
    """`torch.utils.flop_counter`'s count for `step::attn_pool`: 2·27 a
    pooled value, what its formula for aten's convolution counts for the
    depthwise conv; the norm counts nothing."""
    B, heads, n, d = out_shape
    return 2 * 27 * B * heads * n * d


attn_pool_op = kernel_op("attn_pool", _attn_pool_cpu, _attn_pool_launch, _attn_pool_fake,
                         _attn_pool_flop)


def attn_pool(qkv: torch.Tensor, part: int, heads: int, size, stride, weight: torch.Tensor,
              norm_weight: torch.Tensor, norm_bias: torch.Tensor, eps: float) -> torch.Tensor:
    """The pooled, normed part `part` (0 q, 1 k, 2 v) of qkv `[B, T·H·W,
    3·dim_out]` on the grid `size` (t, h, w): `attn_pool_plain`'s contract,
    through `step::attn_pool`. On a CUDA tensor the kernel launches or the
    call raises: it takes bf16 qkv, heads of d = 96, strides (1, s, s) for s
    in 1, 2, 4, 8, and weights all float32 or all bf16
    (`kernels.attn_pool_contract`). A meta tensor (a model built on the
    meta device, for its shapes) takes the operator's fake. Inference only:
    the operator has no backward."""
    args = (qkv, weight, norm_weight, norm_bias, int(part), int(heads), [int(n) for n in size],
            [int(s) for s in stride], float(eps))
    if qkv.device.type == "meta":
        return torch.ops.step.attn_pool(*args)
    return attn_pool_op(*args)
