"""AdamW with 8-bit blockwise moments: int8 mu and uint8 nu, a float32
scale per 256-element block.

Port of `step_tpu/train/optim_int8.py`. Both moments are stored in a
log-domain code (not linear absmax), so every nonzero element keeps a
bounded relative error: ln(1e4)/126 for mu over 127 levels, ln(1e6)/254
for nu over 255, values below the range clamping up to its floor so that
Adam's denominators never collapse. q = 0 only for an exact 0, so the
zero initial state round-trips exactly. About 2.03 bytes a parameter
against float32 moments' 8.

The step is the JAX package's: dequantize, Adam in float32 with its bias
correction in float32, requantize; `trainer.Optimizer` then adds the
decoupled weight decay and scales by -lr, inside its global-norm clip.

The state is one flat buffer a moment for all the trainable tensors
(`init_state`), each tensor zero-padded to whole blocks as the JAX package
pads each leaf, so the blocks never straddle two tensors. Quantizing and
dequantizing run over the flat buffers in a few operations, not per
tensor: the full-width training step is bound by its launches.
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK = 256
R_SIGNED = 9.2103      # ln(1e4): the signed (mu) log range below the block absmax
R_UNSIGNED = 13.8155   # ln(1e6): the unsigned (nu) log range below the block absmax


def _levels(signed: bool) -> int:
    return 127 if signed else 255


def quantize_blockwise(blocks: torch.Tensor, signed: bool = True):
    """float32 `[nblocks, BLOCK]` → (codes int8 or uint8 `[nblocks, BLOCK]`,
    float32 absmax `[nblocks]`): q = 0 iff x == 0, else |q| in 1..L codes
    ln(|x| / absmax) linearly over [-R, 0], rounded half to even, values
    below exp(-R) * absmax clamped up to 1."""
    L = _levels(signed)
    R = R_SIGNED if signed else R_UNSIGNED
    mag = blocks.abs()
    absmax = mag.amax(dim=1)
    ratio = mag / torch.clamp(absmax, min=1e-30)[:, None]
    lq = 1.0 + (L - 1) * (1.0 + torch.log(torch.clamp(ratio, min=1e-37)) / R)
    q = torch.clamp(torch.round(lq), 1, L).masked_fill_(blocks == 0.0, 0.0)
    if signed:
        return (q * torch.sign(blocks)).to(torch.int8), absmax
    return q.to(torch.uint8), absmax


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """(codes `[nblocks, BLOCK]`, absmax `[nblocks]`) → float32 blocks."""
    signed = q.dtype == torch.int8
    L = _levels(signed)
    R = R_SIGNED if signed else R_UNSIGNED
    qf = q.to(torch.float32)
    mag = torch.exp(R * ((qf.abs() - 1.0) / (L - 1) - 1.0))
    val = torch.where(qf == 0.0, torch.zeros((), device=q.device), mag * torch.sign(qf))
    return val * scale[:, None]


def block_offsets(params) -> list[int]:
    """The first block of each tensor in the flat buffers, and the total
    number of blocks last."""
    offsets = [0]
    for p in params:
        offsets.append(offsets[-1] + -(-p.numel() // BLOCK))
    return offsets


def init_state(params) -> dict:
    """Zero moments for `params`: int8 `mu`, uint8 `nu` (`[nblocks,
    BLOCK]`) and their float32 scales (`[nblocks]`), on the params' device."""
    n = block_offsets(params)[-1]
    device = params[0].device
    return {"count": 0,
            "mu": torch.zeros((n, BLOCK), dtype=torch.int8, device=device),
            "mu_scale": torch.zeros(n, device=device),
            "nu": torch.zeros((n, BLOCK), dtype=torch.uint8, device=device),
            "nu_scale": torch.zeros(n, device=device)}


def state_bytes(state: dict) -> int:
    """The bytes the moments hold on the device."""
    return sum(state[k].numel() * state[k].element_size()
               for k in ("mu", "mu_scale", "nu", "nu_scale"))


@torch.no_grad()
def adam_step(grads, state: dict, t: int, b1: float, b2: float, eps: float):
    """Adam's scaled step `t` (counted from 1) from `grads` (float32, one a
    trainable tensor, in `init_state`'s order) with the moments of
    `state`, which it updates → the step of each tensor, a view of one
    flat buffer."""
    offsets = block_offsets(grads)
    flat = torch.zeros((offsets[-1] * BLOCK,), device=grads[0].device)
    views = [flat[a * BLOCK: a * BLOCK + g.numel()] for a, g in zip(offsets, grads)]
    torch._foreach_copy_(views, [g.reshape(-1) for g in grads])
    g = flat.view(-1, BLOCK)
    mu = dequantize_blockwise(state["mu"], state["mu_scale"])
    nu = dequantize_blockwise(state["nu"], state["nu_scale"])
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * (g * g)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
    step = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    state["mu"], state["mu_scale"] = quantize_blockwise(mu, signed=True)
    state["nu"], state["nu_scale"] = quantize_blockwise(nu, signed=False)
    step = step.view(-1)
    return [step[a * BLOCK: a * BLOCK + p.numel()].view(p.shape)
            for a, p in zip(offsets, grads)]
