"""The plain reference of the STEP detector, in float32 PyTorch.

A frozen copy of the detector's mathematics, written apart from the
program so that the benchmark can judge it: the input normalization, the
backbone that `cfg.backbone` names, the scene context, each refinement
step's I3D tail (`inception.py`: TF-SAME padding, BatchNorm on its running
statistics or, in training, on the batch's) and two-branch head, tube
ROI-align, box decoding, clipping and the linear-motion extension in time,
the class scores and the per-frame, per-class greedy NMS surface.

A backbone is the file `backbones/<cfg.backbone>.py` (under `BACKBONES`),
loaded by its path; `config` refuses a name with no file. It holds:
  parameter_shapes(cfg)    name → (shape, kind) of its weights, every name
                           under `features.`, of kinds that
                           `work.make_weights` draws
  out_channels(cfg)        the channels C of the map it returns
  forward(P, cfg, x, run)  the normalized clip `[B, T, H, W, 3]` float32 →
                           the channels-last map `[B, T', H', W', C]` at
                           spatial stride `cfg.feature_stride`, rounded where
                           the program rounds (`run.prec`), each kernel it
                           runs noted with `run.record`

Weights are a dict of float32 tensors under the detector's state_dict names
(`parameter_shapes`), unfolded: BatchNorm stays a separate affine here,
whatever the served tree folds. Activations are channels-last around the
backbone and NCDHW in the heads' tail. Nothing here imports the program.

Departures from the published description, each kept as the program has it:
ROI-align is Detectron's legacy form (no half-pixel offset, an ROI at least
one cell wide); the regression branch resizes its T' deltas to T frames by
linear interpolation.

`Precision` rounds the activations and weights where the program rounds to
its compute dtype. The reference itself keeps float32 (`FLOAT32`); the
control of the check puts a lower precision there.
"""

from __future__ import annotations

import importlib.resources
import importlib.util
import types

import torch
import torch.nn.functional as F

from benchmark.reference import inception as units

BACKBONES = importlib.resources.files(__package__) / "backbones"
CONTEXT_DIM = 256
REG_CHANNELS = 64
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)
EPS = 1e-8
HEAD_EPS = 1e-6
NMS_NEG = -1e9
MAX_SCALE_DELTA = 4.0


def load_backbone(name: str):
    """The module of `BACKBONES/<name>.py`; a name with no file is refused,
    naming the path looked for."""
    path = BACKBONES / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no backbone {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"benchmark_backbone_{name}", str(path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config(fields: dict) -> types.SimpleNamespace:
    """The configuration's fields as attributes, with the sizes derived
    from them and its backbone's module (`net`)."""
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
    c.net = load_backbone(c.backbone)
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
def tail_blocks(cfg):
    if cfg.backbone_depth == "tiny":
        return (("Mixed_5c", units.TINY_B),)
    return (("Mixed_5b", units.INCEPTION_CHANNELS["Mixed_5b"]),
            ("Mixed_5c", units.INCEPTION_CHANNELS["Mixed_5c"]))


def parameter_shapes(cfg) -> dict:
    """name → (shape, kind) of every weight and BatchNorm statistic, under
    the detector's state_dict names: the backbone's, the context's, each
    step's. Kinds here: conv, linear, reg (the box regression's Dense),
    bias, bn_weight, bn_bias, bn_mean, bn_var."""
    out = dict(cfg.net.parameter_shapes(cfg))
    stray = [n for n in out if not n.startswith("features.")]
    if stray:
        raise ValueError(f"backbone {cfg.backbone!r} names weights outside features.: {stray}")
    feat = cfg.net.out_channels(cfg)
    if cfg.use_context:
        out["context.proj.weight"] = ((CONTEXT_DIM, feat), "linear")
        out["context.proj.bias"] = ((CONTEXT_DIM,), "bias")
    ctx = CONTEXT_DIM if cfg.use_context else 0
    for s in range(cfg.num_steps):
        cin = feat
        for name, c in tail_blocks(cfg):
            shapes, cin = units.block_shapes(f"steps.{s}.tail.{name}", cin, c)
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


def roi_align(feat, tubes, cfg, run):
    """Tube ROI-align by bilinear taps: feat `[B, T', H, W, C]`, tubes `[B,
    N, T, 4]` → `[B, N, T', S, S, C]`; slice t' pools the boxes of frame
    `feature_time_indices(T, T')[t']`, each bin the mean of its
    `sampling_ratio`² samples. Recorded as a `roi_align` kernel: the map and
    its output read and written once, the float32 tubes read once, 4
    corners x 2 operations a sample of each output element."""
    B, Tp, H, W, C = feat.shape
    N, T = tubes.shape[1:3]
    S, r = cfg.pooled_size, cfg.sampling_ratio
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
    run.record("roi_align", (feat.numel() + out.numel()) * run.width + tubes.numel() * 4,
               out.numel() * r * r * 8)
    return run.prec(out)


# ---------------------------------------------------------------- the detector
class Run:
    """What one forward carries: the precision, train mode, the BatchNorm
    batch statistics it made, and an optional record `rec` of the kernels
    it ran, each `(kind, bytes, operations or None)` with its bytes at
    `width` bytes an element of the compute dtype."""

    def __init__(self, prec=FLOAT32, train=False, rec=None, width=4):
        self.prec, self.train, self.stats, self.rec, self.width = prec, train, {}, rec, width

    def record(self, kind: str, nbytes: int, ops: int | None = None):
        """Note one kernel of `kind` that moves `nbytes` (and does `ops`
        operations, where a roofline reads them)."""
        if self.rec is not None:
            self.rec.append((kind, nbytes, ops))


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
        x = units.inception(x, P, f"steps.{s}.tail.{name}", run)
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
    feat = units.block_out(tail_blocks(cfg)[-1][1])
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
    feat = cfg.net.forward(P, cfg, preprocess(rgb, run.prec), run)    # [B, T', H', W', C]
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
        pooled = roi_align(feat, tubes, cfg, run)
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
