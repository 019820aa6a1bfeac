"""Stride-1 SAME max pool with the separable shift-and-compare backward.

Port of `step_tpu/ops/pool3d_grad.py::max_pool_3d_s1_sepgrad` (:116-152),
the JAX package's default for every stride-1 pool under differentiation
(`step_tpu/models/i3d.py:245-256`). The value is the plain max pool; on
the card a 3x3x3 window is kernel K5 (`ops/pool.py`). The backward runs
the pool as 1-D stages over T, then H, then W (max is separable, so the
value is the same), re-computed from the saved input, and walks back
through them: at each stage every input element equal to a window's
maximum receives that window's gradient,

    grad_in[q] = sum over offsets o of g[p] * (x[q] == y[p]),  p = q + lo - o,

the offsets taken in the JAX package's order (`_bwd_core`, :61-94). So a
tie credits EVERY tied maximum, where PyTorch's own max-pool backward
credits one argmax: the two differ on ties, which bfloat16 activations
have often. Strided pools keep PyTorch's native backward, whose argmax
is the first maximum in window order, as XLA's select-and-scatter is
(`tests/test_torch_port_train.py` holds both against `jax.grad` on
integer-valued inputs).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from step_tpu_torch.ops.pool import max_pool3x3_same


def _same_pads(k: int) -> tuple[int, int]:
    """TF-SAME (low, high) padding of a stride-1 axis for window k."""
    pad = k - 1
    return pad // 2, pad - pad // 2


def _overlap(n: int, t: int) -> tuple[int, int]:
    """The q in [lo, hi) for which q + t is also in [0, n)."""
    return max(0, -t), min(n, n - t)


def _pool_1d(x: torch.Tensor, dim: int, k: int) -> torch.Tensor:
    """Stride-1 SAME max pool of x along `dim` with -inf padding, as
    elementwise maxima of shifted views (the backward reads its values only
    through equality, so the order of the maxima does not matter)."""
    lo, _ = _same_pads(k)
    y = x.clone()
    for o in range(k):
        t = o - lo
        a, b = _overlap(x.shape[dim], t)
        if t and b > a:
            view = y.narrow(dim, a, b - a)
            torch.maximum(view, x.narrow(dim, a + t, b - a), out=view)
    return y


def _bwd_1d(x: torch.Tensor, y: torch.Tensor, g: torch.Tensor, dim: int,
            k: int) -> torch.Tensor:
    """Gradient wrt x of y = `_pool_1d(x, dim, k)` for the cotangent g.

    The JAX package adds, offset by offset, `where(x == y[q + t], g[q + t],
    0)` with y padded by -inf and g by 0 (`_bwd_core`); here each offset
    adds its term on the overlapping views only, which is the same sum:
    the padded terms are +0, and the accumulator, which starts at +0, never
    holds -0."""
    lo, _ = _same_pads(k)
    g = g.to(x.dtype)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    grad = torch.zeros_like(x)
    for o in range(k):
        t = lo - o
        a, b = _overlap(x.shape[dim], t)
        if b <= a:
            continue
        n = b - a
        view = grad.narrow(dim, a, n)
        view.add_(torch.where(x.narrow(dim, a, n) == y.narrow(dim, a + t, n),
                              g.narrow(dim, a + t, n), zero))
    return grad


def max_pool_s1_backward(x: torch.Tensor, g: torch.Tensor, window) -> torch.Tensor:
    """Gradient wrt x of the stride-1 SAME pool for the cotangent g: the 1-D
    stages over T, H, W re-computed from x, then walked back."""
    stages, cur = [], x
    for dim, k in zip((2, 3, 4), window):
        if k > 1:
            y = _pool_1d(cur, dim, k)
            stages.append((cur, y, dim, k))
            cur = y
    for cur, y, dim, k in reversed(stages):
        g = _bwd_1d(cur, y, g, dim, k)
    return g


def max_pool_plain(x: torch.Tensor, window) -> torch.Tensor:
    """Stride-1 SAME max pool of an NCDHW tensor, padded with -inf."""
    pad = []
    for d in (4, 3, 2):
        pad += _same_pads(window[d - 2])
    return F.max_pool3d(F.pad(x, pad, value=float("-inf")), tuple(window), 1)


class _MaxPoolS1SepGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, window):
        ctx.window = window
        ctx.save_for_backward(x)
        if x.device.type == "cuda" and window == (3, 3, 3):
            return max_pool3x3_same(x)
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"max_pool_3d_s1_sepgrad: no path for device {x.device}")
        return max_pool_plain(x, window)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return max_pool_s1_backward(x, g, ctx.window), None


def max_pool_3d_s1_sepgrad(x: torch.Tensor, window) -> torch.Tensor:
    """Stride-1 SAME max pool of an NCDHW tensor whose backward credits
    every tied maximum, stage by stage, as the JAX package's
    `max_pool_3d_s1_sepgrad` does. The forward is K5 for a 3x3x3 window on
    the card, the plain pool otherwise."""
    return _MaxPoolS1SepGrad.apply(x, tuple(int(k) for k in window))
