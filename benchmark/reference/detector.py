"""The plain reference of the STEP detector, in float32 PyTorch.

A frozen copy of the detector's mathematics, written apart from the
program so that the benchmark can judge it: the input normalization, the
I3D stem to Mixed_4f and the I3D tail (TF-SAME padding, BatchNorm on its
running statistics or, in training, on the batch's), the scene context,
each refinement step's two-branch head, tube ROI-align, box decoding,
clipping and the linear-motion extension in time, the class scores and
the per-frame, per-class greedy NMS surface.

Weights are a dict of float32 tensors under the detector's state_dict names
(`parameter_shapes`), unfolded: BatchNorm stays a separate affine here,
whatever the served tree folds. Activations are NCDHW in the backbone and
channels-last around it. Nothing here imports the program.

Departures from the published description, each kept as the program has it:
ROI-align is Detectron's legacy form (no half-pixel offset, an ROI at least
one cell wide); a stride-1 max pool under autograd credits every tied
maximum (`_MaxPoolS1`); the regression branch resizes its T' deltas to T
frames by linear interpolation.

`Precision` rounds the activations and weights where the program rounds to
its compute dtype. The reference itself keeps float32 (`FLOAT32`); the
control of the check puts a lower precision there.
"""

from __future__ import annotations

import math
import types

import torch
import torch.nn.functional as F

INCEPTION_CHANNELS = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
TINY_A = (16, 16, 24, 8, 16, 8)
TINY_B = (32, 24, 48, 8, 24, 24)
STEM_BLOCKS = ("Mixed_3b", "Mixed_3c", "Mixed_4b", "Mixed_4c", "Mixed_4d",
               "Mixed_4e", "Mixed_4f")
BN_EPS = 1e-3
CONTEXT_DIM = 256
REG_CHANNELS = 64
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)
EPS = 1e-8
HEAD_EPS = 1e-6
NMS_NEG = -1e9
MAX_SCALE_DELTA = 4.0


def config(fields: dict) -> types.SimpleNamespace:
    """The configuration's fields as attributes, with the sizes derived
    from them."""
    c = types.SimpleNamespace(**fields)
    c.total_frames = c.frames_per_chunk * c.num_chunks
    c.num_cls_outputs = c.num_classes if c.multilabel else c.num_classes + 1
    for key in ("input_stream", "two_stream", "chunk_stem", "reg_head", "cuboid_layout"):
        default = {"input_stream": "rgb", "reg_head": "grid",
                   "cuboid_layout": "default"}.get(key, False)
        if getattr(c, key, default) != default:
            raise ValueError(f"the reference has no {key}={getattr(c, key)!r}")
    if c.sampling_ratio <= 0:
        raise ValueError("the reference samples a fixed grid (sampling_ratio > 0)")
    return c


class Precision:
    """Rounds a tensor to `fmt` and back, where the program holds its
    compute dtype; the gradient passes straight through. None keeps
    float32."""

    def __init__(self, fmt: str | None = None):
        self.fmt = fmt

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.fmt is None:
            return x
        dtype = getattr(torch, self.fmt)
        if dtype.is_floating_point and dtype.itemsize == 1:
            top = torch.finfo(dtype).max
            low = x.detach().clamp(-top, top).to(dtype).to(x.dtype)
        else:
            low = x.detach().to(dtype).to(x.dtype)
        return x + (low - x.detach()) if x.requires_grad else low


FLOAT32 = Precision()


# ---------------------------------------------------------------- parameters
def _unit_shapes(name, cin, cout, kernel):
    out = {f"{name}.conv.weight": ((cout, cin) + tuple(kernel), "conv")}
    for part, kind in (("weight", "bn_weight"), ("bias", "bn_bias"),
                       ("running_mean", "bn_mean"), ("running_var", "bn_var")):
        out[f"{name}.bn.{part}"] = ((cout,), kind)
    return out


def _block_shapes(name, cin, c):
    out = {}
    for branch, i, o, k in (("b0", cin, c[0], 1), ("b1a", cin, c[1], 1),
                            ("b1b", c[1], c[2], 3), ("b2a", cin, c[3], 1),
                            ("b2b", c[3], c[4], 3), ("b3b", cin, c[5], 1)):
        out.update(_unit_shapes(f"{name}.{branch}", i, o, (k, k, k)))
    return out, c[0] + c[2] + c[4] + c[5]


def stem_blocks(cfg):
    """(name, channels) of the stem's Inception blocks at the configured depth."""
    if cfg.backbone_depth == "tiny":
        return (("Mixed_3b", TINY_A), ("Mixed_4f", TINY_B))
    return tuple((n, INCEPTION_CHANNELS[n]) for n in STEM_BLOCKS)


def tail_blocks(cfg):
    if cfg.backbone_depth == "tiny":
        return (("Mixed_5c", TINY_B),)
    return (("Mixed_5b", INCEPTION_CHANNELS["Mixed_5b"]),
            ("Mixed_5c", INCEPTION_CHANNELS["Mixed_5c"]))


def parameter_shapes(cfg) -> dict:
    """name → (shape, kind) of every weight and BatchNorm statistic, under
    the detector's state_dict names. Kinds: conv, linear, reg (the box
    regression's Dense), bias, bn_weight, bn_bias, bn_mean, bn_var."""
    out = {}
    stem = "features.stem_rgb"
    first = 16 if cfg.backbone_depth == "tiny" else 64
    out.update(_unit_shapes(f"{stem}.Conv3d_1a_7x7", 3, first,
                            (3, 7, 7) if cfg.backbone_depth == "tiny" else (7, 7, 7)))
    cin = first
    if cfg.backbone_depth != "tiny":
        out.update(_unit_shapes(f"{stem}.Conv3d_2b_1x1", 64, 64, (1, 1, 1)))
        out.update(_unit_shapes(f"{stem}.Conv3d_2c_3x3", 64, 192, (3, 3, 3)))
        cin = 192
    for name, c in stem_blocks(cfg):
        shapes, cin = _block_shapes(f"{stem}.{name}", cin, c)
        out.update(shapes)
    feat = cin
    if cfg.use_context:
        out["context.proj.weight"] = ((CONTEXT_DIM, feat), "linear")
        out["context.proj.bias"] = ((CONTEXT_DIM,), "bias")
    ctx = CONTEXT_DIM if cfg.use_context else 0
    for s in range(cfg.num_steps):
        cin = feat
        for name, c in tail_blocks(cfg):
            shapes, cin = _block_shapes(f"steps.{s}.tail.{name}", cin, c)
            out.update(shapes)
        grid = cfg.pooled_size * cfg.pooled_size * REG_CHANNELS
        out[f"steps.{s}.cls.weight"] = ((cfg.num_cls_outputs, cin + ctx), "linear")
        out[f"steps.{s}.cls.bias"] = ((cfg.num_cls_outputs,), "bias")
        out[f"steps.{s}.reg_reduce.weight"] = ((REG_CHANNELS, cin, 1, 1, 1), "conv")
        out[f"steps.{s}.reg_reduce.bias"] = ((REG_CHANNELS,), "bias")
        out[f"steps.{s}.reg.weight"] = ((4, grid), "reg")
        out[f"steps.{s}.reg.bias"] = ((4,), "bias")
    return out


def is_statistic(name: str) -> bool:
    return name.endswith(".running_mean") or name.endswith(".running_var")


# ---------------------------------------------------------------- I3D
def same_pads(n: int, k: int, s: int):
    pad = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return pad // 2, pad - pad // 2


def _pad_list(x, kernel, stride):
    pads = [same_pads(x.shape[2 + i], kernel[i], stride[i]) for i in range(3)]
    return [p for lo_hi in reversed(pads) for p in lo_hi]


def conv3d_same(x, w, b, stride, prec):
    return F.conv3d(F.pad(x, _pad_list(x, w.shape[2:], stride)), prec(w),
                    None if b is None else prec(b), stride)


def _pool1d(x, dim, k):
    lo = (k - 1) // 2
    y = x.clone()
    for o in range(k):
        t = o - lo
        a, b = max(0, -t), min(x.shape[dim], x.shape[dim] - t)
        if t and b > a:
            view = y.narrow(dim, a, b - a)
            torch.maximum(view, x.narrow(dim, a + t, b - a), out=view)
    return y


def _pool1d_grad(x, y, g, dim, k):
    lo = (k - 1) // 2
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    grad = torch.zeros_like(x)
    for o in range(k):
        t = lo - o
        a, b = max(0, -t), min(x.shape[dim], x.shape[dim] - t)
        if b <= a:
            continue
        n = b - a
        grad.narrow(dim, a, n).add_(torch.where(
            x.narrow(dim, a, n) == y.narrow(dim, a + t, n), g.narrow(dim, a + t, n), zero))
    return grad


class _MaxPoolS1(torch.autograd.Function):
    """Stride-1 SAME max pool whose backward credits every tied maximum,
    stage by stage over T, H and W."""

    @staticmethod
    def forward(ctx, x, window):
        ctx.window = window
        ctx.save_for_backward(x)
        pad = [p for k in reversed(window) for p in ((k - 1) // 2, k - 1 - (k - 1) // 2)]
        return F.max_pool3d(F.pad(x, pad, value=float("-inf")), window, 1)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        stages, cur = [], x
        for dim, k in zip((2, 3, 4), ctx.window):
            if k > 1:
                y = _pool1d(cur, dim, k)
                stages.append((cur, y, dim, k))
                cur = y
        for cur, y, dim, k in reversed(stages):
            g = _pool1d_grad(cur, y, g, dim, k)
        return g, None


def max_pool(x, window, stride, rec=None):
    window, stride = tuple(window), tuple(stride)
    if rec is not None:
        rec.append(("max_pool", tuple(x.shape), window, stride))
    if stride == (1, 1, 1) and torch.is_grad_enabled() and x.requires_grad:
        return _MaxPoolS1.apply(x, window)
    pad = _pad_list(x, window, stride)
    return F.max_pool3d(F.pad(x, pad, value=float("-inf")), window, stride)


def batch_norm(x, P, name, train, stats):
    """flax's BatchNorm in float32: running statistics, or in training the
    batch's (mean and the clamped E[x^2] - mean^2, kept in `stats`)."""
    shape = (1, -1, 1, 1, 1)
    if train:
        dims = (0, 2, 3, 4)
        mean = x.mean(dim=dims)
        var = torch.clamp((x * x).mean(dim=dims) - mean * mean, min=0.0)
        stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    mul = torch.rsqrt(var.reshape(shape) + BN_EPS) * P[f"{name}.weight"].reshape(shape)
    return (x - mean.reshape(shape)) * mul + P[f"{name}.bias"].reshape(shape)


def unit(x, P, name, stride, run):
    x = conv3d_same(x, P[f"{name}.conv.weight"], None, stride, run.prec)
    return run.prec(F.relu(batch_norm(x, P, f"{name}.bn", run.train, run.stats)))


def inception(x, P, name, run):
    b3 = unit(max_pool(x, (3, 3, 3), (1, 1, 1), run.rec), P, f"{name}.b3b", (1, 1, 1), run)
    b0 = unit(x, P, f"{name}.b0", (1, 1, 1), run)
    b1 = unit(unit(x, P, f"{name}.b1a", (1, 1, 1), run), P, f"{name}.b1b", (1, 1, 1), run)
    b2 = unit(unit(x, P, f"{name}.b2a", (1, 1, 1), run), P, f"{name}.b2b", (1, 1, 1), run)
    return torch.cat([b0, b1, b2, b3], dim=1)


def i3d_stem(x, P, cfg, run):
    """NCDHW clip → the Mixed_4f map."""
    s = "features.stem_rgb"
    x = unit(x, P, f"{s}.Conv3d_1a_7x7", (2, 2, 2), run)
    x = max_pool(x, (1, 3, 3), (1, 2, 2), run.rec)
    if cfg.backbone_depth == "tiny":
        x = inception(x, P, f"{s}.Mixed_3b", run)
        x = max_pool(x, (3, 3, 3), (2, 2, 2), run.rec)
        return inception(x, P, f"{s}.Mixed_4f", run)
    x = unit(x, P, f"{s}.Conv3d_2b_1x1", (1, 1, 1), run)
    x = unit(x, P, f"{s}.Conv3d_2c_3x3", (1, 1, 1), run)
    x = max_pool(x, (1, 3, 3), (1, 2, 2), run.rec)
    x = inception(inception(x, P, f"{s}.Mixed_3b", run), P, f"{s}.Mixed_3c", run)
    x = max_pool(x, (3, 3, 3), (2, 2, 2), run.rec)
    for name in STEM_BLOCKS[2:]:
        x = inception(x, P, f"{s}.{name}", run)
    return x


# ---------------------------------------------------------------- boxes and tubes
def _cxcywh(b):
    cx = (b[..., 0] + b[..., 2]) * 0.5
    cy = (b[..., 1] + b[..., 3]) * 0.5
    w = torch.clamp(b[..., 2] - b[..., 0], min=EPS)
    h = torch.clamp(b[..., 3] - b[..., 1], min=EPS)
    return cx, cy, w, h


def decode_boxes(deltas, anchors, variances):
    acx, acy, aw, ah = _cxcywh(anchors)
    cx = deltas[..., 0] * variances[0] * aw + acx
    cy = deltas[..., 1] * variances[0] * ah + acy
    scale = torch.clamp(deltas[..., 2:4] * variances[1], -MAX_SCALE_DELTA, MAX_SCALE_DELTA)
    w = torch.exp(scale[..., 0]) * aw
    h = torch.exp(scale[..., 1]) * ah
    return torch.stack([cx - w * 0.5, cy - h * 0.5, cx + w * 0.5, cy + h * 0.5], dim=-1)


def encode_boxes(boxes, anchors, variances):
    bcx, bcy, bw, bh = _cxcywh(boxes)
    acx, acy, aw, ah = _cxcywh(anchors)
    aw, ah = torch.clamp(aw, min=1.0), torch.clamp(ah, min=1.0)
    return torch.stack([(bcx - acx) / (aw * variances[0]), (bcy - acy) / (ah * variances[0]),
                        torch.log(bw / aw) / variances[1], torch.log(bh / ah) / variances[1]],
                       dim=-1)


def clip_boxes(b, size):
    return torch.stack([torch.clamp(b[..., i], 0.0, size) for i in range(4)], dim=-1)


def chunk_frame_mask(step, cfg, device):
    center = cfg.num_chunks // 2
    reach = min(step, center) if cfg.temporal_extension else 0
    ids = torch.arange(cfg.num_chunks, device=device)
    active = ((ids - center).abs() <= reach).to(torch.float32)
    return torch.repeat_interleave(active, cfg.frames_per_chunk)


def extrapolate_tubes(tubes, known, size):
    """Unknown frames take a per-coordinate least-squares line fitted over
    the known frames, clipped to the image; known frames stay."""
    T = tubes.shape[-2]
    t = torch.arange(T, dtype=tubes.dtype, device=tubes.device)
    w = torch.broadcast_to(known.to(tubes.dtype), tubes.shape[:-1])
    sw = torch.clamp(w.sum(dim=-1, keepdim=True), min=EPS)
    mean_t = (w * t).sum(dim=-1, keepdim=True) / sw
    mean_c = (w[..., None] * tubes).sum(dim=-2) / sw
    dt = t - mean_t
    var_t = (w * dt * dt).sum(dim=-1)[..., None]
    cov = ((w * dt)[..., None] * (tubes - mean_c[..., None, :])).sum(dim=-2)
    fitted = mean_c[..., None, :] + (cov / torch.clamp(var_t, min=EPS))[..., None, :] * dt[..., None]
    return torch.where(w[..., None] > 0, tubes, clip_boxes(fitted, size))


def initial_cuboids(cfg, device):
    """The 11 hand-placed cuboids, constant in time, padded to
    `max_proposals` slots with a small centred box and mask 0 →
    (tubes `[P, T, 4]`, mask `[P]`)."""
    boxes = [(0.0, 0.0, 1.0, 1.0)]
    for cx in (0.25, 0.75):
        for cy in (0.25, 0.75):
            boxes.append((cx - 0.25, cy - 0.25, cx + 0.25, cy + 0.25))
    for cx, cy in ((0.5, 0.25), (0.5, 0.75), (0.25, 0.5), (0.75, 0.5)):
        boxes.append((cx - 0.25, cy - 0.25, cx + 0.25, cy + 0.25))
    for half in (0.375, 0.25):
        boxes.append((0.5 - half, 0.5 - half, 0.5 + half, 0.5 + half))
    s = float(cfg.image_size)
    n = len(boxes)
    tubes = torch.tensor([0.49, 0.49, 0.51, 0.51], dtype=torch.float32).repeat(cfg.max_proposals, 1)
    tubes[:n] = torch.tensor(boxes, dtype=torch.float32)
    tubes = (tubes * s).to(device)
    mask = torch.zeros(cfg.max_proposals, device=device)
    mask[:n] = 1.0
    return tubes[:, None].expand(cfg.max_proposals, cfg.total_frames, 4).contiguous(), mask


def feature_time_indices(T, Tp, device):
    if T == Tp:
        return torch.arange(Tp, device=device)
    return ((torch.arange(Tp, dtype=torch.float32, device=device) + 0.5) * (T / Tp)).to(torch.int64)


def _taps(c, limit):
    """Bilinear taps along one axis: (low index, high index, their weights);
    a sample outside [-1, limit] weighs 0, one inside is clamped to
    [0, limit - 1]."""
    ok = ((c >= -1.0) & (c <= limit)).to(c.dtype)
    c = torch.clamp(c, 0.0, limit - 1.0)
    lo = torch.floor(c)
    frac = c - lo
    lo = lo.to(torch.int64)
    return lo, torch.clamp(lo + 1, max=limit - 1), (1.0 - frac) * ok, frac * ok


def roi_align(feat, tubes, cfg, prec, rec=None):
    """Tube ROI-align by bilinear taps: feat `[B, T', H, W, C]`, tubes `[B,
    N, T, 4]` → `[B, N, T', S, S, C]`; slice t' pools the boxes of frame
    `feature_time_indices(T, T')[t']`, each bin the mean of its
    `sampling_ratio`² samples."""
    B, Tp, H, W, C = feat.shape
    N, T = tubes.shape[1:3]
    S, r = cfg.pooled_size, cfg.sampling_ratio
    if rec is not None:
        rec.append(("roi_align", tuple(feat.shape), tuple(tubes.shape), (B, N, Tp, S, S, C)))
    boxes = tubes[:, :, feature_time_indices(T, Tp, feat.device)] / cfg.feature_stride
    x1, y1 = boxes[..., 0], boxes[..., 1]
    roi_w = torch.clamp(boxes[..., 2] - x1, min=1.0)
    roi_h = torch.clamp(boxes[..., 3] - y1, min=1.0)
    off = (torch.arange(S, dtype=torch.float32, device=feat.device)[:, None]
           + (torch.arange(r, dtype=torch.float32, device=feat.device) + 0.5) / r).reshape(-1)
    ys = y1[..., None] + off * (roi_h / S)[..., None]               # [B, N, T', S*r]
    xs = x1[..., None] + off * (roi_w / S)[..., None]
    bi = torch.arange(B, device=feat.device)[:, None, None, None]
    ti = torch.arange(Tp, device=feat.device)[None, None, :, None]
    lo, hi, wl, wh = _taps(ys, H)
    rows = feat[bi, ti, lo] * wl[..., None, None] + feat[bi, ti, hi] * wh[..., None, None]
    rows = rows.reshape(B, N, Tp, S, r, W, C).sum(dim=4)            # [B, N, T', S, W, C]
    lo, hi, wl, wh = _taps(xs, W)                                   # [B, N, T', S*r]
    pick = lambda idx: torch.gather(  # noqa: E731
        rows, 4, idx[:, :, :, None, :, None].expand(B, N, Tp, S, S * r, C))
    out = pick(lo) * wl[:, :, :, None, :, None] + pick(hi) * wh[:, :, :, None, :, None]
    out = out.reshape(B, N, Tp, S, S, r, C).sum(dim=5) / float(r * r)
    return prec(out)


# ---------------------------------------------------------------- the detector
class Run:
    """What one forward carries: the precision, train mode, the BatchNorm
    batch statistics it made, and an optional recorder of the pools and
    ROI-aligns it ran (their shapes)."""

    def __init__(self, prec=FLOAT32, train=False, rec=None):
        self.prec, self.train, self.stats, self.rec = prec, train, {}, rec


def _linear(x, P, name, prec):
    return F.linear(prec(x), prec(P[f"{name}.weight"]), prec(P[f"{name}.bias"]))


def _dropout(x, keep, rate):
    if keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def head(P, s, cfg, pooled, ctx, tmask, run, keep):
    """Step s's head: pooled `[N, T', S, S, C]` → (logits `[N, ncls]`,
    deltas `[N, T, 4]`)."""
    prec = run.prec
    x = pooled.permute(0, 4, 1, 2, 3)
    for name, _ in tail_blocks(cfg):
        x = inception(x, P, f"steps.{s}.tail.{name}", run)
    N, Tp = x.shape[0], x.shape[2]
    spatial = prec(x.mean(dim=(3, 4)))
    w = tmask / torch.clamp(tmask.sum(), min=HEAD_EPS)
    cls_feat = prec(torch.einsum("nct,t->nc", spatial, w))
    if ctx is not None:
        cls_feat = torch.cat([cls_feat, ctx], dim=-1)
    keep_cls, keep_reg = keep if keep is not None else (None, None)
    logits = prec(_linear(_dropout(cls_feat, keep_cls, cfg.dropout_rate), P, f"steps.{s}.cls", prec))
    r = F.relu(F.conv3d(prec(x), prec(P[f"steps.{s}.reg_reduce.weight"]),
                        prec(P[f"steps.{s}.reg_reduce.bias"])))
    r = prec(r).permute(0, 2, 3, 4, 1).reshape(N, Tp, -1)
    r = _dropout(r, keep_reg, cfg.dropout_rate)
    deltas = prec(_linear(r, P, f"steps.{s}.reg", prec))            # [N, T', 4]
    deltas = F.interpolate(deltas.transpose(1, 2), size=cfg.total_frames, mode="linear",
                           align_corners=False).transpose(1, 2)
    return logits, deltas


def dropout_masks(cfg, B, generator, device, Tp):
    """The keep-masks of one training forward, drawn from `generator` in
    the program's order: per step, the classification then the regression
    mask."""
    N = B * cfg.max_proposals
    ctx = CONTEXT_DIM if cfg.use_context else 0
    c_out = tail_blocks(cfg)[-1][1]
    feat = c_out[0] + c_out[2] + c_out[4] + c_out[5]
    grid = cfg.pooled_size * cfg.pooled_size * REG_CHANNELS
    keep = 1.0 - cfg.dropout_rate
    return [(torch.rand((N, feat + ctx), generator=generator, device=device) < keep,
             torch.rand((N, Tp, grid), generator=generator, device=device) < keep)
            for _ in range(cfg.num_steps)]


def preprocess(rgb, prec):
    """uint8 `[..., 3]` → normalized float32."""
    mean = torch.tensor(RGB_MEAN, device=rgb.device)
    std = torch.tensor(RGB_STD, device=rgb.device)
    return prec((rgb.to(torch.float32) / 255.0 - mean) / std)


def forward(P, cfg, rgb, proposals, run=None, masks=None):
    """The detector's forward on uint8 clips `[B, T, H, W, 3]` and
    proposals `[B, P, T, 4]` → per-step outputs stacked on a leading S
    axis: cls_logits, deltas, proposals, tubes, frame_mask."""
    run = run or Run()
    x = preprocess(rgb, run.prec).permute(0, 4, 1, 2, 3)
    feat = i3d_stem(x, P, cfg, run).permute(0, 2, 3, 4, 1)           # [B, T', H', W', C]
    ctx = None
    if cfg.use_context:
        ctx = run.prec(F.relu(_linear(feat.mean(dim=(1, 2, 3)), P, "context.proj", run.prec)))
    tubes = proposals.to(torch.float32)
    B, NP, T = tubes.shape[:3]
    t_idx = feature_time_indices(T, feat.shape[1], tubes.device)
    ctx_flat = None if ctx is None else ctx[:, None].expand(B, NP, ctx.shape[-1]).reshape(B * NP, -1)
    out = {k: [] for k in ("cls_logits", "deltas", "proposals", "tubes", "frame_mask")}
    for s in range(cfg.num_steps):
        fmask = chunk_frame_mask(s, cfg, tubes.device)
        pooled = roi_align(feat, tubes, cfg, run.prec, run.rec)
        pooled = pooled.reshape(B * NP, *pooled.shape[2:])
        logits, deltas = head(P, s, cfg, pooled, ctx_flat, fmask[t_idx], run,
                              None if masks is None else masks[s])
        deltas = deltas.reshape(B, NP, T, 4)
        decoded = clip_boxes(decode_boxes(deltas, tubes, cfg.box_variances), float(cfg.image_size))
        filled = extrapolate_tubes(decoded * fmask[:, None], fmask, float(cfg.image_size))
        for key, value in (("cls_logits", logits.reshape(B, NP, -1)), ("deltas", deltas),
                           ("proposals", tubes), ("tubes", filled), ("frame_mask", fmask)):
            out[key].append(value)
        tubes = filled.detach()
    return {k: torch.stack(v) for k, v in out.items()}


# ---------------------------------------------------------------- scores and NMS
def class_scores(logits, cfg):
    if cfg.multilabel:
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)[..., 1:]


def _f32(x):
    return torch.tensor(x, dtype=torch.float32).item()


def nms(boxes, live, iou_threshold, max_keep):
    """Greedy NMS of N problems, boxes `[N, P, 4]`, pre-masked live scores
    `[N, P]` → (keep_idx `[N, K]` int64, keep_mask float32): each round
    picks the highest live score (ties to the lowest index), drops every
    box above the IoU threshold against it and the pick itself; a problem
    with nothing live left keeps the lowest index of its maximum, masked."""
    N, P = live.shape
    x1, y1, x2, y2 = boxes.unbind(-1)
    area = (x2 - x1) * (y2 - y1)
    iota = torch.arange(P, device=live.device).expand(N, P)
    thr = _f32(iou_threshold)
    idxs, oks = [], []
    for _ in range(max_keep):
        best = live.max(dim=1, keepdim=True).values
        idx = torch.where(live == best, iota, P).min(dim=1, keepdim=True).values
        ok = best > NMS_NEG / 2
        sel = lambda a: torch.gather(a, 1, idx)  # noqa: E731
        cx1, cy1, cx2, cy2 = sel(x1), sel(y1), sel(x2), sel(y2)
        w = torch.clamp(torch.minimum(cx2, x2) - torch.maximum(cx1, x1), min=0.0)
        h = torch.clamp(torch.minimum(cy2, y2) - torch.maximum(cy1, y1), min=0.0)
        inter = w * h
        iou = inter / torch.clamp((cx2 - cx1) * (cy2 - cy1) + area - inter, min=EPS)
        drop = (iou > thr) | (iota == idx)
        live = torch.where(ok & drop, torch.full_like(live, NMS_NEG), live)
        idxs.append(idx[:, 0])
        oks.append(ok[:, 0])
    return torch.stack(idxs, dim=1), torch.stack(oks, dim=1).to(torch.float32)


def nms_surface(tubes, scores, prop_mask, cfg):
    """Per-frame, per-class NMS over tubes `[B, P, T, 4]` and scores `[B, P,
    C]` → frame_boxes `[B, T, C, K, 4]`, frame_scores and frame_mask `[B,
    T, C, K]`, K = min(max_detections, P)."""
    B, P, T = tubes.shape[:3]
    C = scores.shape[-1]
    K = min(cfg.max_detections, P)
    boxes = tubes.to(torch.float32).transpose(1, 2)[:, :, None].expand(B, T, C, P, 4)
    sc = scores.to(torch.float32).transpose(1, 2)[:, None].expand(B, T, C, P)
    valid = prop_mask[:, None, None].expand(B, T, C, P)
    neg = torch.full_like(sc, NMS_NEG)
    live = torch.where(valid > 0, sc, neg)
    live = torch.where(live > _f32(cfg.score_thresh), live, neg)
    idx, mask = nms(boxes.reshape(-1, P, 4), live.reshape(-1, P), cfg.nms_thresh, K)
    idx = idx.reshape(B, T, C, K)
    mask = mask.reshape(B, T, C, K)
    frame_boxes = torch.gather(boxes, 3, idx[..., None].expand(B, T, C, K, 4))
    frame_scores = torch.gather(sc, 3, idx) * mask
    return {"frame_boxes": frame_boxes, "frame_scores": frame_scores, "frame_mask": mask}


def detect(P, cfg, rgb, proposals, prop_mask, prec=FLOAT32):
    """What the served request answers: tubes `[B, P, T, 4]`, tube_scores
    `[B, P, C]` (0 on padding slots) and the NMS surface."""
    with torch.no_grad():
        out = forward(P, cfg, rgb, proposals, Run(prec))
        tubes = out["tubes"][-1]
        scores = class_scores(out["cls_logits"][-1], cfg) * prop_mask[..., None]
        return dict(tubes=tubes, tube_scores=scores, **nms_surface(tubes, scores, prop_mask, cfg))
