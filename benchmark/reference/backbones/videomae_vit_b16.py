"""The VideoMAE ViT-B/16 encoder as STEP's backbone, in float32 PyTorch
(Tong et al., NeurIPS 2022, arXiv:2203.12602; MCG-NJU/VideoMAE,
`modeling_finetune.py::VisionTransformer`, without its classifier):

  tokens = Conv3d(x), kernel = stride = (2, p, p), + the sinusoid table
  each block: x += proj(softmax(q·kᵀ / √d)·v) of LN1(x), qkv bias
              cat(q_bias, 0, v_bias); x += fc2(GELU(fc1(LN2(x))))
  map = LN(x), the N = T/2 · H/p · W/p tokens as `[B, T/2, H/p, W/p, D]`

LayerNorm eps 1e-6, exact GELU. Widths by `backbone_depth`: "full" D 768,
12 blocks of 12 heads, MLP 3072, p = 16 (the configuration's
`feature_stride` must be 16); "tiny" D 64, 2 blocks of 4 heads, MLP 256,
p = `feature_stride`. Attention is written as its two matrix products and
a softmax over all N tokens of a clip, so the FLOP counter counts it.

Rounding (`run.prec`) where the program holds its compute dtype: the
input, each layer's output, the residual stream after each add. Where the
two part: the position table is rounded to the compute dtype and added
there, as VideoMAE adds it (`type_as(x)`), not in float32; inside the
attention call the program's kernel may round the probabilities to the
compute dtype before their product with v, which the reference keeps in
float32 (it rounds the call's output only).

Each block records two kernels (`run.record`): `attention`, bytes q, k
and v read and the output written (4·B·N·D elements), operations 4·B·N²·D;
`mlp`, bytes its input read and output written and both weights read once
(2·B·N·D + 2·D·4D elements), operations 2·B·N·2·D·4D.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

FEAT = "features"
TUBELET_FRAMES = 2
PATCH = 16
LN_EPS = 1e-6
# depth → (width D, blocks, heads, MLP width)
WIDTHS = {"full": (768, 12, 12, 3072), "tiny": (64, 2, 4, 256)}


def _widths(cfg):
    if cfg.backbone_depth == "full" and cfg.feature_stride != PATCH:
        raise ValueError(f"ViT-B/16 has spatial stride {PATCH}, not {cfg.feature_stride}")
    return WIDTHS[cfg.backbone_depth]


def out_channels(cfg) -> int:
    return _widths(cfg)[0]


def parameter_shapes(cfg) -> dict:
    """The patch embedding is a linear map of each tubelet (kind `linear`);
    q_bias and v_bias are drawn as small values (the `ln_bias` range), so
    that their place in the qkv bias shows."""
    D, depth, _, H = _widths(cfg)
    p = cfg.feature_stride
    out = {f"{FEAT}.patch_embed.proj.weight": ((D, 3, TUBELET_FRAMES, p, p), "linear"),
           f"{FEAT}.patch_embed.proj.bias": ((D,), "bias")}
    for i in range(depth):
        b = f"{FEAT}.blocks.{i}"
        for norm in ("norm1", "norm2"):
            out[f"{b}.{norm}.weight"] = ((D,), "ln_weight")
            out[f"{b}.{norm}.bias"] = ((D,), "ln_bias")
        out[f"{b}.attn.qkv.weight"] = ((3 * D, D), "linear")
        out[f"{b}.attn.q_bias"] = ((D,), "ln_bias")
        out[f"{b}.attn.v_bias"] = ((D,), "ln_bias")
        out[f"{b}.attn.proj.weight"] = ((D, D), "linear")
        out[f"{b}.attn.proj.bias"] = ((D,), "bias")
        out[f"{b}.mlp.fc1.weight"] = ((H, D), "linear")
        out[f"{b}.mlp.fc1.bias"] = ((H,), "bias")
        out[f"{b}.mlp.fc2.weight"] = ((D, H), "linear")
        out[f"{b}.mlp.fc2.bias"] = ((D,), "bias")
    out[f"{FEAT}.norm.weight"] = ((D,), "ln_weight")
    out[f"{FEAT}.norm.bias"] = ((D,), "ln_bias")
    return out


def sinusoid_table(n, dim, device):
    """VideoMAE's `get_sinusoid_encoding_table`, in float64 as its numpy
    original, then float32."""
    pos = torch.arange(n, dtype=torch.float64, device=device)[:, None]
    i = torch.arange(dim, device=device)
    angle = pos / torch.pow(10000.0, (2 * (i // 2)).to(torch.float64) / dim)
    return torch.where(i % 2 == 0, torch.sin(angle), torch.cos(angle)).to(torch.float32)


def _norm(x, P, name, prec):
    return prec(F.layer_norm(x, x.shape[-1:], prec(P[f"{name}.weight"]),
                             prec(P[f"{name}.bias"]), LN_EPS))


def _linear(x, P, name, prec):
    return prec(F.linear(x, prec(P[f"{name}.weight"]), prec(P[f"{name}.bias"])))


def attention(x, P, b, heads, run):
    """One block's attention half on LN1(x) → its output after `proj`."""
    prec = run.prec
    B, N, D = x.shape
    q_bias, v_bias = P[f"{b}.attn.q_bias"], P[f"{b}.attn.v_bias"]
    bias = torch.cat([q_bias, torch.zeros_like(v_bias), v_bias])
    qkv = F.linear(x, prec(P[f"{b}.attn.qkv.weight"]), prec(bias))
    q, k, v = prec(qkv).reshape(B, N, 3, heads, D // heads).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(q, k.transpose(-2, -1)) * (D // heads) ** -0.5
    out = prec(torch.matmul(torch.softmax(scores, dim=-1), v))
    run.record("attention", 4 * B * N * D * run.width, 4 * B * N * N * D)
    return _linear(out.transpose(1, 2).reshape(B, N, D), P, f"{b}.attn.proj", prec)


def mlp(x, P, b, run):
    prec = run.prec
    B, N, D = x.shape
    h = _linear(x, P, f"{b}.mlp.fc1", prec)
    out = _linear(prec(F.gelu(h)), P, f"{b}.mlp.fc2", prec)
    H = h.shape[-1]
    run.record("mlp", (2 * B * N * D + 2 * D * H) * run.width, 2 * B * N * 2 * D * H)
    return out


def forward(P, cfg, x, run):
    prec = run.prec
    D, depth, heads, _ = _widths(cfg)
    p = cfg.feature_stride
    B, T, Hi, Wi = x.shape[:4]
    t, h, w = T // TUBELET_FRAMES, Hi // p, Wi // p
    emb = F.conv3d(x.permute(0, 4, 1, 2, 3), prec(P[f"{FEAT}.patch_embed.proj.weight"]),
                   prec(P[f"{FEAT}.patch_embed.proj.bias"]), stride=(TUBELET_FRAMES, p, p))
    tokens = prec(emb).flatten(2).transpose(1, 2)                    # [B, N, D], (t, h, w)
    x = prec(tokens + prec(sinusoid_table(t * h * w, D, x.device)))
    for i in range(depth):
        b = f"{FEAT}.blocks.{i}"
        x = prec(x + attention(_norm(x, P, f"{b}.norm1", prec), P, b, heads, run))
        x = prec(x + mlp(_norm(x, P, f"{b}.norm2", prec), P, b, run))
    return _norm(x, P, f"{FEAT}.norm", prec).reshape(B, t, h, w, D)
