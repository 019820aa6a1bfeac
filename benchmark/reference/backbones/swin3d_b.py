"""Video Swin-B as STEP's backbone, to the end of its stride-16 stage, in
float32 PyTorch (Liu et al., CVPR 2022, arXiv:2106.13230;
SwinTransformer/Video-Swin-Transformer,
`configs/recognition/swin/swin_base_patch244_window877_kinetics400_1k.py`,
`mmaction/models/backbones/swin_transformer.py`), without the classifier:

  tokens = LN(Conv3d(pad(x)))      3→128, kernel = stride = (2, 4, 4), the
                                   clip padded to a multiple of the patch
  each stage (width C, heads h, d = C / h), window (8, 7, 7) and shift
  (4, 3, 3) adapted by `get_window_size`; Dp, Hp, Wp the grid padded to
  multiples of the window; `compute_mask` once:
    each block j (shifted when j is odd):
      xn = F.pad(LN1(x)); xn = roll(xn, −shift) if shifted
      windows = window_partition(xn)                 [B·nW, N, C]
      attn = (q·d^-0.5)@kᵀ + table[index[:N, :N]]    WindowAttention3D
      attn = attn.view(B, nW, h, N, N) + mask        if shifted
      o = proj(softmax(attn)@v); window_reverse; roll(+shift); crop
      x = x + o;  x = x + fc2(GELU(fc1(LN2(x))))
    PatchMerging after stages 1 and 2: cat of the 2x2 neighbours x0..x3 =
    (0,0), (1,0), (0,1), (1,1) in (h, w), LN over 4C, Linear 4C→2C no bias
  map = out_norm(x) as `[B, T', H', W', C]`

Stages by `backbone_depth`: "full" depths 2, 2, 18 at widths 128/256/512,
heads 4/8/16 (`feature_stride` must be 16: patch 4, two merges); "tiny"
depths 2, 2, 2 at widths 16/32/64, d 16, patch `feature_stride` / 4. The
window, shift and table (2535 rows of (2·8−1)(2·7−1)(2·7−1)) are the
published at every depth. LayerNorm eps 1e-5, exact GELU, the mask −100.0.

Rounding (`run.prec`) where the program holds its compute dtype: the
input, each layer's output (patch embedding, norms, qkv, the attention's
output, projections, the merges' reduction, GELU, fc1, fc2), the weights
and the bias table, and the residual stream after each add. Where the two
part: the program sums the bias and the mask once in the compute dtype
(exact where the mask is 0) and its attention kernel adds them to its
float32 logits, where the reference adds each to its float32 logits; the
kernel may round the probabilities before their product with v, which the
reference keeps in float32.

Each block records (`run.record`, elements at `run.width` bytes, Np the
padded grid's tokens, L the grid's, C the width, nW the windows of N
tokens a clip): `attention`, bytes 4·Np·C (q, k, v read, the output
written), ops h·nW·4·N²·d; `mlp` as the ViT's, on the L tokens.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

FEAT = "features"
LN_EPS = 1e-5
WINDOW = (8, 7, 7)
SHIFT = (4, 3, 3)
PATCH_T = 2
# depth → (first stage's width, head dim, blocks a stage)
WIDTHS = {"full": (128, 32, (2, 2, 18)), "tiny": (16, 16, (2, 2, 2))}


def _stages(cfg):
    """(width, heads, blocks) of each stage, and the spatial patch."""
    if cfg.backbone_depth == "full" and cfg.feature_stride != 16:
        raise ValueError(f"Video Swin-B's map is at spatial stride 16, not {cfg.feature_stride}")
    width, d, blocks = WIDTHS[cfg.backbone_depth]
    stages = [(width * 2 ** i, width * 2 ** i // d, n) for i, n in enumerate(blocks)]
    return stages, cfg.feature_stride // 2 ** (len(blocks) - 1)


def out_channels(cfg) -> int:
    return _stages(cfg)[0][-1][0]


def table_rows():
    return math.prod(2 * w - 1 for w in WINDOW)


def parameter_shapes(cfg) -> dict:
    """The patch embedding is a convolution (kind `conv`); qkv, the
    projections, fc1, fc2, the merges' reduction and the bias tables are
    `linear`, the tables `[2535, h]` at std 1/√h, so that the bias shows
    in the logits."""
    stages, p = _stages(cfg)
    C0 = stages[0][0]
    out = {f"{FEAT}.patch_embed.proj.weight": ((C0, 3, PATCH_T, p, p), "conv"),
           f"{FEAT}.patch_embed.proj.bias": ((C0,), "bias"),
           f"{FEAT}.patch_embed.norm.weight": ((C0,), "ln_weight"),
           f"{FEAT}.patch_embed.norm.bias": ((C0,), "ln_bias")}
    for i, (C, heads, blocks) in enumerate(stages):
        for j in range(blocks):
            b = f"{FEAT}.layers.{i}.blocks.{j}"
            for norm in ("norm1", "norm2"):
                out[f"{b}.{norm}.weight"] = ((C,), "ln_weight")
                out[f"{b}.{norm}.bias"] = ((C,), "ln_bias")
            out[f"{b}.attn.relative_position_bias_table"] = ((table_rows(), heads), "linear")
            for name, (n_out, n_in) in (("attn.qkv", (3 * C, C)), ("attn.proj", (C, C)),
                                        ("mlp.fc1", (4 * C, C)), ("mlp.fc2", (C, 4 * C))):
                out[f"{b}.{name}.weight"] = ((n_out, n_in), "linear")
                out[f"{b}.{name}.bias"] = ((n_out,), "bias")
        if i < len(stages) - 1:
            ds = f"{FEAT}.layers.{i}.downsample"
            out[f"{ds}.norm.weight"] = ((4 * C,), "ln_weight")
            out[f"{ds}.norm.bias"] = ((4 * C,), "ln_bias")
            out[f"{ds}.reduction.weight"] = ((2 * C, 4 * C), "linear")
    C = stages[-1][0]
    out[f"{FEAT}.out_norm.weight"] = ((C,), "ln_weight")
    out[f"{FEAT}.out_norm.bias"] = ((C,), "ln_bias")
    return out


def _norm(x, P, name, prec):
    return prec(F.layer_norm(x, x.shape[-1:], prec(P[f"{name}.weight"]),
                             prec(P[f"{name}.bias"]), LN_EPS))


def _linear(x, P, name, prec):
    return prec(F.linear(x, prec(P[f"{name}.weight"]), prec(P[f"{name}.bias"])))


def get_window_size(x_size, window_size, shift_size):
    use_window, use_shift = list(window_size), list(shift_size)
    for i in range(len(x_size)):
        if x_size[i] <= window_size[i]:
            use_window[i] = x_size[i]
            use_shift[i] = 0
    return tuple(use_window), tuple(use_shift)


def window_partition(x, window_size):
    """`[B, D, H, W, C]` → `[B·nW, N, C]`."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window_size
    x = x.view(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).contiguous().view(-1, wd * wh * ww, C)


def window_reverse(windows, window_size, B, D, H, W):
    wd, wh, ww = window_size
    x = windows.view(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).contiguous().view(B, D, H, W, -1)


def compute_mask(D, H, W, window_size, shift_size, device):
    img_mask = torch.zeros((1, D, H, W, 1), device=device)
    cnt = 0
    for d in (slice(-window_size[0]), slice(-window_size[0], -shift_size[0]),
              slice(-shift_size[0], None)):
        for h in (slice(-window_size[1]), slice(-window_size[1], -shift_size[1]),
                  slice(-shift_size[1], None)):
            for w in (slice(-window_size[2]), slice(-window_size[2], -shift_size[2]),
                      slice(-shift_size[2], None)):
                img_mask[:, d, h, w, :] = cnt
                cnt += 1
    mask_windows = window_partition(img_mask, window_size).squeeze(-1)
    attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
    return attn_mask.masked_fill(attn_mask != 0, -100.0).masked_fill(attn_mask == 0, 0.0)


def relative_position_index(device):
    coords = torch.stack(torch.meshgrid(*(torch.arange(w, device=device) for w in WINDOW),
                                        indexing="ij")).flatten(1)
    rel = (coords[:, :, None] - coords[:, None, :]).permute(1, 2, 0).contiguous()
    rel[:, :, 0] += WINDOW[0] - 1
    rel[:, :, 1] += WINDOW[1] - 1
    rel[:, :, 2] += WINDOW[2] - 1
    rel[:, :, 0] *= (2 * WINDOW[1] - 1) * (2 * WINDOW[2] - 1)
    rel[:, :, 1] *= 2 * WINDOW[2] - 1
    return rel.sum(-1)


def window_attention(x, P, b, heads, mask, run):
    """`WindowAttention3D.forward`: windows `[B·nW, N, C]` → projected
    output, the same shape."""
    prec = run.prec
    B_, N, C = x.shape
    d = C // heads
    qkv = _linear(x, P, f"{b}.attn.qkv", prec).reshape(B_, N, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    attn = (q * d ** -0.5) @ k.transpose(-2, -1)
    table = prec(P[f"{b}.attn.relative_position_bias_table"])
    index = relative_position_index(x.device)[:N, :N].reshape(-1)
    bias = table[index].reshape(N, N, -1).permute(2, 0, 1).contiguous()
    attn = attn + bias.unsqueeze(0)
    if mask is not None:
        nW = mask.shape[0]
        attn = attn.view(B_ // nW, nW, heads, N, N) + mask.unsqueeze(1).unsqueeze(0)
        attn = attn.view(-1, heads, N, N)
    out = prec(attn.softmax(dim=-1) @ v).transpose(1, 2).reshape(B_, N, C)
    return _linear(out, P, f"{b}.attn.proj", prec)


def mlp(x, P, b, run):
    prec = run.prec
    B, N, D = x.shape
    h = _linear(x, P, f"{b}.mlp.fc1", prec)
    out = _linear(prec(F.gelu(h)), P, f"{b}.mlp.fc2", prec)
    H = h.shape[-1]
    run.record("mlp", (2 * B * N * D + 2 * D * H) * run.width, 2 * B * N * 2 * D * H)
    return out


def block(x, P, b, heads, window, shift, mask, run):
    """`SwinTransformerBlock3D.forward` on `[B, D, H, W, C]` with the
    layer's adapted `window` and this block's `shift`."""
    prec = run.prec
    B, D, H, W, C = x.shape
    shortcut = x
    x = _norm(x, P, f"{b}.norm1", prec)
    pads = [(w - n % w) % w for n, w in zip((D, H, W), window)]
    x = F.pad(x, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]))
    _, Dp, Hp, Wp, _ = x.shape
    shifted = any(s > 0 for s in shift)
    if shifted:
        x = torch.roll(x, shifts=tuple(-s for s in shift), dims=(1, 2, 3))
    windows = window_partition(x, window)
    out = window_attention(windows, P, b, heads, mask if shifted else None, run)
    nW, N = windows.shape[0] // B, windows.shape[1]
    d = C // heads
    run.record("attention", 4 * B * Dp * Hp * Wp * C * run.width,
               B * heads * nW * 4 * N * N * d)
    x = window_reverse(out.view(-1, *window, C), window, B, Dp, Hp, Wp)
    if shifted:
        x = torch.roll(x, shifts=shift, dims=(1, 2, 3))
    x = prec(shortcut + x[:, :D, :H, :W, :])
    tokens = x.reshape(B, -1, C)
    tokens = prec(tokens + mlp(_norm(tokens, P, f"{b}.norm2", prec), P, b, run))
    return tokens.view(B, D, H, W, C)


def patch_merging(x, P, name, prec):
    B, D, H, W, C = x.shape
    if H % 2 == 1 or W % 2 == 1:
        x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
    x0 = x[:, :, 0::2, 0::2, :]
    x1 = x[:, :, 1::2, 0::2, :]
    x2 = x[:, :, 0::2, 1::2, :]
    x3 = x[:, :, 1::2, 1::2, :]
    x = _norm(torch.cat([x0, x1, x2, x3], -1), P, f"{name}.norm", prec)
    return prec(F.linear(x, prec(P[f"{name}.reduction.weight"])))


def forward(P, cfg, x, run):
    prec = run.prec
    stages, p = _stages(cfg)
    x = x.permute(0, 4, 1, 2, 3)                                      # [B, 3, T, H, W]
    _, _, T, H, W = x.shape
    x = F.pad(x, (0, (-W) % p, 0, (-H) % p, 0, (-T) % PATCH_T))
    x = prec(F.conv3d(x, prec(P[f"{FEAT}.patch_embed.proj.weight"]),
                      prec(P[f"{FEAT}.patch_embed.proj.bias"]), stride=(PATCH_T, p, p)))
    x = _norm(x.permute(0, 2, 3, 4, 1), P, f"{FEAT}.patch_embed.norm", prec)   # [B, D, H, W, C]
    for i, (C, heads, blocks) in enumerate(stages):
        _, D, H, W, _ = x.shape
        window, shift = get_window_size((D, H, W), WINDOW, SHIFT)
        Dp, Hp, Wp = (-(-n // w) * w for n, w in zip((D, H, W), window))
        mask = compute_mask(Dp, Hp, Wp, window, shift, x.device)
        for j in range(blocks):
            x = block(x, P, f"{FEAT}.layers.{i}.blocks.{j}", heads, window,
                      shift if j % 2 else (0, 0, 0), mask, run)
        if i < len(stages) - 1:
            x = patch_merging(x, P, f"{FEAT}.layers.{i}.downsample", prec)
    return _norm(x, P, f"{FEAT}.out_norm", prec)
