"""MViTv2-B as STEP's backbone, to the end of its stride-16 stage, in
float32 PyTorch (Li et al., 2022, arXiv:2112.01526; SlowFast
`configs/Kinetics/MVITv2_B_32x3.yaml`, `attention.py::MultiScaleBlock`,
`MultiScaleAttention`, `attention_pool`, `cal_rel_pos_spatial`,
`cal_rel_pos_temporal`), without the cls token:

  tokens = Conv3d 3→96, kernel (3, 7, 7), stride (2, 4, 4), padding (1, 3, 3)
  each block (width dim → dim_out, heads of d = dim_out / heads):
    xn = LN1(x); q, k, v = qkv(xn)
    q, k, v = LN(pool(q)), LN(pool(k)), LN(pool(v))   depthwise 3x3x3 conv,
              padding 1, one weight shared by the heads; LN over d
    attn = (q·scale)·kᵀ + Rel_h + Rel_w + Rel_t        scale d^-0.5
    o = proj(softmax(attn)·v + q)
    x = maxpool_(1,3,3)/(1,2,2), pad (0,1,1)(proj(xn)) at a transition, else x
    x = x + o;  x = x + fc2(GELU(fc1(LN2(x))))
  map = out_norm(x) as `[B, T', H', W', C]`

Blocks by `backbone_depth`: "full" blocks 0–20 of MViTv2-B (stages of 2,
3 and 16 blocks, widths 96/192/384, heads 1/2/4, K/V stride 8 in stage 1
divided by each query stride; `feature_stride` must be 16); "tiny" stages
of 1, 2 and 2 blocks at widths 16/32/64, d 16, K/V stride 4, spatial stride
`feature_stride`. LayerNorm eps 1e-6, exact GELU. The relative tables hold
2·max(q, k) − 1 rows of the pooled query's and keys' sides (2·T' − 1 in
time); the rows are SlowFast's dist, so no table is resized.

Rounding (`run.prec`) where the program holds its compute dtype: the
input, each layer's output (patch embedding, norms, qkv, pools, the three
relative terms, the attention's output, `+ q`, projections, the skip pool's
input, GELU, fc1, fc2) and the residual stream after each add. Where the
two part: the program adds the three relative terms into one bias in the
compute dtype and hands it to its attention kernel, which adds it to its
float32 logits; the reference adds each rounded term to its float32 logits.
Inside the attention call the program's kernel may round the probabilities
before their product with v, which the reference keeps in float32.

Each block records (`run.record`, elements at `run.width` bytes, with Nq,
Nkv and N_in the block's query, key and input tokens, D = h·d and k_t,
k_h, k_w the key grid's sides): `attention`, bytes (2·Nq + 2·Nkv)·D (q read
once for the logits, Rel and the residual; k and v; the output), ops
h·Nq·(4·Nkv·d + 2·d·(k_t + k_h + k_w)); `attn_pool`, bytes (3·N_in + Nq +
2·Nkv)·D, ops 2·27·(Nq + 2·Nkv)·D; `mlp` as the ViT's; and at a transition
`pool3d`, the skip pool's input and output.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FEAT = "features"
LN_EPS = 1e-6
PATCH_KERNEL, PATCH_PADDING, PATCH_STRIDE_T = (3, 7, 7), (1, 3, 3), 2
# depth → (first stage's width = head dim, blocks a stage, first stage's K/V stride)
WIDTHS = {"full": (96, (2, 3, 16), 8), "tiny": (16, (1, 2, 2), 4)}


def _plan(cfg):
    """(dim, dim_out, heads, q stride, K/V stride) of every block."""
    if cfg.backbone_depth == "full" and cfg.feature_stride != 16:
        raise ValueError(f"MViTv2-B's map is at spatial stride 16, not {cfg.feature_stride}")
    width, stages, kv0 = WIDTHS[cfg.backbone_depth]
    plan, dim = [], width
    for s, blocks in enumerate(stages):
        for b in range(blocks):
            q = 2 if s > 0 and b == 0 else 1
            kv = max(kv0 // 2 ** s, 1)
            plan.append((dim, width * 2 ** s, 2 ** s, (1, q, q), (1, kv, kv)))
            dim = width * 2 ** s
    return plan


def _pooled(size, stride):
    return [(n + 2 - 3) // s + 1 for n, s in zip(size, stride)]


def _grids(cfg):
    """The input grid (t, h, w) of every block, and the patch stride."""
    plan = _plan(cfg)
    stride = cfg.feature_stride // 2 ** sum(q[1] > 1 for *_, q, _ in plan)
    t = (cfg.total_frames + 2 * PATCH_PADDING[0] - PATCH_KERNEL[0]) // PATCH_STRIDE_T + 1
    side = (cfg.image_size + 2 * PATCH_PADDING[1] - PATCH_KERNEL[1]) // stride + 1
    sizes, size = [], [t, side, side]
    for *_, q_stride, _ in plan:
        sizes.append(size)
        size = _pooled(size, q_stride)
    return sizes, stride


def out_channels(cfg) -> int:
    return _plan(cfg)[-1][1]


def parameter_shapes(cfg) -> dict:
    """The patch embedding and the depthwise pools are convolutions (kind
    `conv`); qkv, the projections, fc1, fc2 and the three relative tables
    are `linear`, the tables at std sqrt(1/d), so that their terms show in
    the logits."""
    plan = _plan(cfg)
    sizes, _ = _grids(cfg)
    out = {f"{FEAT}.patch_embed.proj.weight": ((plan[0][0], 3, *PATCH_KERNEL), "conv"),
           f"{FEAT}.patch_embed.proj.bias": ((plan[0][0],), "bias")}
    for i, ((dim, dim_out, heads, q_stride, kv_stride), size) in enumerate(zip(plan, sizes)):
        b, d = f"{FEAT}.blocks.{i}", dim_out // heads
        q_side, kv_side = _pooled(size, q_stride)[1], _pooled(size, kv_stride)[1]
        for name, shape in (("norm1", dim), ("norm2", dim_out), ("attn.norm_q", d),
                            ("attn.norm_k", d), ("attn.norm_v", d)):
            out[f"{b}.{name}.weight"] = ((shape,), "ln_weight")
            out[f"{b}.{name}.bias"] = ((shape,), "ln_bias")
        for name, (n_out, n_in) in (("attn.qkv", (3 * dim_out, dim)),
                                    ("attn.proj", (dim_out, dim_out)),
                                    ("mlp.fc1", (4 * dim_out, dim_out)),
                                    ("mlp.fc2", (dim_out, 4 * dim_out)),
                                    *((("proj", (dim_out, dim)),) if dim != dim_out else ())):
            out[f"{b}.{name}.weight"] = ((n_out, n_in), "linear")
            out[f"{b}.{name}.bias"] = ((n_out,), "bias")
        for name in ("q", "k", "v"):
            out[f"{b}.attn.pool_{name}.weight"] = ((d, 1, 3, 3, 3), "conv")
        for name, rows in (("h", 2 * max(q_side, kv_side) - 1),
                           ("w", 2 * max(q_side, kv_side) - 1), ("t", 2 * size[0] - 1)):
            out[f"{b}.attn.rel_pos_{name}"] = ((rows, d), "linear")
    out[f"{FEAT}.out_norm.weight"] = ((plan[-1][1],), "ln_weight")
    out[f"{FEAT}.out_norm.bias"] = ((plan[-1][1],), "ln_bias")
    return out


def _norm(x, P, name, prec):
    return prec(F.layer_norm(x, x.shape[-1:], prec(P[f"{name}.weight"]),
                             prec(P[f"{name}.bias"]), LN_EPS))


def _linear(x, P, name, prec):
    return prec(F.linear(x, prec(P[f"{name}.weight"]), prec(P[f"{name}.bias"])))


def attention_pool(x, P, b, name, size, stride, prec):
    """SlowFast's `attention_pool` with block b's `pool_<name>` and
    `norm_<name>`: x `[B, h, N, d]` on the grid `size` → `[B, h, N', d]`
    and its grid."""
    B, heads, _, d = x.shape
    x = x.reshape(B * heads, *size, d).permute(0, 4, 1, 2, 3)
    x = prec(F.conv3d(x, prec(P[f"{b}.attn.pool_{name}.weight"]), None, stride, 1, 1, d))
    new = list(x.shape[2:])
    x = x.reshape(B, heads, d, -1).transpose(2, 3)
    return _norm(x, P, f"{b}.attn.norm_{name}", prec), new


def _dist(q, k, device):
    q_ratio, k_ratio = max(k / q, 1.0), max(q / k, 1.0)
    dist = (torch.arange(q, device=device)[:, None] * q_ratio
            - torch.arange(k, device=device)[None, :] * k_ratio + (k - 1) * k_ratio)
    return dist.long()


def cal_rel_pos_spatial(attn, q, q_shape, k_shape, rel_pos_h, rel_pos_w, prec):
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    Rh = rel_pos_h[_dist(q_h, k_h, q.device)]
    Rw = rel_pos_w[_dist(q_w, k_w, q.device)]
    B, n_head, _, dim = q.shape
    r_q = q.reshape(B, n_head, q_t, q_h, q_w, dim)
    rel_h = prec(torch.einsum("bythwc,hkc->bythwk", r_q, Rh))
    rel_w = prec(torch.einsum("bythwc,wkc->bythwk", r_q, Rw))
    attn = (attn.view(B, -1, q_t, q_h, q_w, k_t, k_h, k_w)
            + rel_h[:, :, :, :, :, None, :, None] + rel_w[:, :, :, :, :, None, None, :])
    return attn.view(B, -1, q_t * q_h * q_w, k_t * k_h * k_w)


def cal_rel_pos_temporal(attn, q, q_shape, k_shape, rel_pos_t, prec):
    q_t, q_h, q_w = q_shape
    k_t, k_h, k_w = k_shape
    Rt = rel_pos_t[_dist(q_t, k_t, q.device)]
    B, n_head, _, dim = q.shape
    r_q = q.reshape(B, n_head, q_t, q_h, q_w, dim)
    r_q = r_q.permute(2, 0, 1, 3, 4, 5).reshape(q_t, B * n_head * q_h * q_w, dim)
    rel = prec(torch.matmul(r_q, Rt.transpose(1, 2)).transpose(0, 1))
    rel = rel.view(B, n_head, q_h, q_w, q_t, k_t).permute(0, 1, 4, 2, 3, 5)
    attn = attn.view(B, -1, q_t, q_h, q_w, k_t, k_h, k_w) + rel[:, :, :, :, :, :, None, None]
    return attn.view(B, -1, q_t * q_h * q_w, k_t * k_h * k_w)


def attention(xn, P, b, plan, size, run):
    """One block's attention on LN1(x) `[B, N, dim]` → (its output after
    `proj`, the query's grid)."""
    prec = run.prec
    dim, dim_out, heads, q_stride, kv_stride = plan
    B, N, _ = xn.shape
    d = dim_out // heads
    qkv = _linear(xn, P, f"{b}.attn.qkv", prec).reshape(B, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, q_shape = attention_pool(qkv[0], P, b, "q", size, q_stride, prec)
    k, k_shape = attention_pool(qkv[1], P, b, "k", size, kv_stride, prec)
    v, _ = attention_pool(qkv[2], P, b, "v", size, kv_stride, prec)
    Nq, Nkv = q.shape[2], k.shape[2]
    run.record("attn_pool", (3 * N + Nq + 2 * Nkv) * dim_out * B * run.width,
               2 * 27 * (Nq + 2 * Nkv) * dim_out * B)
    attn = (q * d ** -0.5) @ k.transpose(-2, -1)
    tables = {n: prec(P[f"{b}.attn.rel_pos_{n}"]) for n in "hwt"}
    attn = cal_rel_pos_spatial(attn, q, q_shape, k_shape, tables["h"], tables["w"], prec)
    attn = cal_rel_pos_temporal(attn, q, q_shape, k_shape, tables["t"], prec)
    out = prec(prec(attn.softmax(dim=-1) @ v) + q)
    run.record("attention", (2 * Nq + 2 * Nkv) * dim_out * B * run.width,
               B * heads * Nq * (4 * Nkv * d + 2 * d * sum(k_shape)))
    out = out.transpose(1, 2).reshape(B, Nq, dim_out)
    return _linear(out, P, f"{b}.attn.proj", prec), q_shape


def mlp(x, P, b, run):
    prec = run.prec
    B, N, D = x.shape
    h = _linear(x, P, f"{b}.mlp.fc1", prec)
    out = _linear(prec(F.gelu(h)), P, f"{b}.mlp.fc2", prec)
    H = h.shape[-1]
    run.record("mlp", (2 * B * N * D + 2 * D * H) * run.width, 2 * B * N * 2 * D * H)
    return out


def skip_pool(x, size, stride, run):
    """SlowFast's `pool_skip`: MaxPool3d(kernel s + 1 where s > 1, stride
    s, padding kernel // 2) on tokens `[B, N, C]` of the grid `size`."""
    B, N, C = x.shape
    kernel = [s + 1 if s > 1 else s for s in stride]
    y = F.max_pool3d(x.transpose(1, 2).reshape(B, C, *size), kernel, stride,
                     [k // 2 for k in kernel])
    run.record("pool3d", (N + y[0, 0].numel()) * B * C * run.width)
    return y.reshape(B, C, -1).transpose(1, 2)


def forward(P, cfg, x, run):
    prec = run.prec
    plan = _plan(cfg)
    sizes, stride = _grids(cfg)
    B = x.shape[0]
    emb = F.conv3d(x.permute(0, 4, 1, 2, 3), prec(P[f"{FEAT}.patch_embed.proj.weight"]),
                   prec(P[f"{FEAT}.patch_embed.proj.bias"]), (PATCH_STRIDE_T, stride, stride),
                   PATCH_PADDING)
    if list(emb.shape[2:]) != sizes[0]:
        raise ValueError(f"a clip of {list(x.shape[1:4])} makes the grid {list(emb.shape[2:])}, "
                         f"not the configuration's {sizes[0]}")
    x = prec(emb).flatten(2).transpose(1, 2)                        # [B, N, 96], (t, h, w)
    for i, (block, size) in enumerate(zip(plan, sizes)):
        b = f"{FEAT}.blocks.{i}"
        xn = _norm(x, P, f"{b}.norm1", prec)
        out, q_shape = attention(xn, P, b, block, size, run)
        if block[0] != block[1]:
            x = _linear(xn, P, f"{b}.proj", prec)
        if math.prod(block[3]) > 1:
            x = skip_pool(x, size, block[3], run)
        x = prec(x + out)
        x = prec(x + mlp(_norm(x, P, f"{b}.norm2", prec), P, b, run))
    return _norm(x, P, f"{FEAT}.out_norm", prec).reshape(B, *q_shape, plan[-1][1])
