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
(`init_state`), blocked as the JAX package blocks its parameter leaves,
so each block holds the elements of the JAX package's block, with its
scale and codes: a conv kernel in DHWIO order (OIDHW permuted by (2, 3,
4, 1, 0)), a Dense weight as `[in, out]`, and the `steps.{s}.` tensors
of one name concatenated in step order into one leaf, as `nn.scan`
stacks the heads' parameters (`step_tpu/models/detector.py:177-184`).
Each leaf is zero-padded to whole blocks once, at its end, so no block
straddles two leaves. `blocking` builds the gather index of that order
once (int32, one entry a parameter), which `trainer.Optimizer` holds: it
is derived from the parameters, so the state does not carry it. Each step
gathers the gradients into it and scatters the step back, and the
quantizing and dequantizing run over the flat buffers in a few
operations, not per tensor: the full-width training step is bound by its
launches. The state carries the layout's name (`LAYOUT`) and its leaves,
and a checkpoint's moments in another layout are refused
(`check_restorable`).
"""

from __future__ import annotations

import re

import numpy as np
import torch

BLOCK = 256
R_SIGNED = 9.2103      # ln(1e4): the signed (mu) log range below the block absmax
R_UNSIGNED = 13.8155   # ln(1e6): the unsigned (nu) log range below the block absmax
# The blocking of the moments, saved with them: the JAX package's leaves.
LAYOUT = "jax-leaves"
_STEP = re.compile(r"^steps\.\d+\.")


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


def leaf_name(name: str) -> str:
    """The JAX leaf a trainable tensor belongs to: its own name, or, for a
    per-step head's tensor, its name with `steps.{s}.` as `steps.*.`."""
    return _STEP.sub("steps.*.", name)


def _jax_positions(shape, device) -> torch.Tensor:
    """For each element of a tensor of `shape` in torch's order, its index
    in the JAX package's layout of the tensor: conv kernels OIDHW → DHWIO,
    Dense weights `[out, in]` → `[in, out]`, any other tensor as it is."""
    n = int(np.prod(shape, dtype=np.int64))
    if len(shape) == 5:
        o, i, d, h, w = shape
        return torch.arange(n, device=device).view(d, h, w, i, o).permute(
            4, 3, 0, 1, 2).reshape(-1)
    if len(shape) == 2:
        return torch.arange(n, device=device).view(shape[1], shape[0]).t().reshape(-1)
    return torch.arange(n, device=device)


def blocking(params, names):
    """The JAX package's blocking of `params`, named by `names` (their
    names in the model, which put the per-step heads' tensors into one
    leaf) → (index, leaves). `index` (int32) gives, for each element of
    the tensors flattened and concatenated in order, its place in the flat
    blocked buffer; `leaves` holds (leaf name, first block, blocks) in the
    order of each leaf's first tensor. The tensors of a leaf follow one
    another in their order in `params`, which is step order."""
    names = list(names)
    if len(names) != len(params):
        raise ValueError(f"{len(names)} names for {len(params)} tensors")
    device = params[0].device
    members: dict[str, list[int]] = {}
    for i, name in enumerate(names):
        members.setdefault(leaf_name(name), []).append(i)
    index: list = [None] * len(params)
    leaves, block = [], 0
    for leaf, group in members.items():
        start = base = block * BLOCK
        for i in group:
            index[i] = _jax_positions(tuple(params[i].shape), device) + base
            base += params[i].numel()
        n = -(-(base - start) // BLOCK)
        leaves.append((leaf, block, n))
        block += n
    return torch.cat(index).to(torch.int32), tuple(leaves)


def init_state(leaves, device) -> dict:
    """Zero moments over `leaves` (`blocking`'s): int8 `mu`, uint8 `nu`
    (`[nblocks, BLOCK]`) and their float32 scales (`[nblocks]`) on
    `device`, with the layout's name and the leaves."""
    n = leaves[-1][1] + leaves[-1][2]
    return {"count": 0,
            "mu": torch.zeros((n, BLOCK), dtype=torch.int8, device=device),
            "mu_scale": torch.zeros(n, device=device),
            "nu": torch.zeros((n, BLOCK), dtype=torch.uint8, device=device),
            "nu_scale": torch.zeros(n, device=device),
            "layout": LAYOUT, "leaves": leaves}


def check_restorable(saved: dict, current: dict, source: str = "the checkpoint") -> None:
    """Raises ValueError unless the optimizer state `saved` in a checkpoint
    can take the place of `current`, when `current` holds int8 moments
    (its `layout`): `saved` must hold moments in the same layout over the
    same leaves, or, restored into these blocks, their codes and scales
    would belong to other elements. Other states (float32 moments, SGD's
    trace) are not blocked and pass."""
    if "layout" not in current:
        return
    if saved.get("layout") != current["layout"]:
        raise ValueError(
            f"{source} holds no Adam moments in the JAX package's blocking (DHWIO, "
            "[in, out], the heads stacked by step): int8 moments saved before the "
            "moments took it are blocked in torch's own layout (each tensor flattened "
            "as OIDHW or [out, in], the per-step heads apart), so their blocks hold "
            "other elements than this optimizer's and they cannot be restored. Start "
            "the moments anew from the checkpoint's weights "
            "(utils/checkpoint.py::load_model_state).")
    if saved["leaves"] != current["leaves"]:
        raise ValueError(f"{source} holds int8 Adam moments over other parameters than "
                         "this optimizer's (adam_moments, the frozen subtrees or the "
                         "model differ)")


def state_bytes(state: dict) -> int:
    """The bytes the moments hold on the device."""
    return sum(state[k].numel() * state[k].element_size()
               for k in ("mu", "mu_scale", "nu", "nu_scale"))


@torch.no_grad()
def adam_step(grads, state: dict, index: torch.Tensor, t: int, b1: float, b2: float,
              eps: float):
    """Adam's scaled step `t` (counted from 1) from `grads` (float32, one a
    trainable tensor, in `blocking`'s order) with the moments of `state`,
    which it updates → the step of each tensor, a view of one flat buffer.
    One gather along `index` (`blocking`'s) puts the gradients into the
    blocked order (the padding stays 0) and one scatter puts the step
    back."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    g = torch.zeros(state["mu"].numel(), device=flat.device).index_add_(0, index, flat)
    g = g.view(-1, BLOCK)
    mu = dequantize_blockwise(state["mu"], state["mu_scale"])
    nu = dequantize_blockwise(state["nu"], state["nu_scale"])
    mu = b1 * mu + (1.0 - b1) * g
    nu = b2 * nu + (1.0 - b2) * (g * g)
    bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(t))
    bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(t))
    step = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
    state["mu"], state["mu_scale"] = quantize_blockwise(mu, signed=True)
    state["nu"], state["nu_scale"] = quantize_blockwise(nu, signed=False)
    step = step.view(-1).index_select(0, index)
    return [s.view(p.shape) for s, p in zip(step.split([p.numel() for p in grads]), grads)]
