"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card. Skipped without a CUDA device. The card's machine has no JAX, so
run these without the JAX test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

NMS and the 3x3x3 max pool must be exactly equal. ROI-align: 1e-4 in
float32 (the kernel sums the bilinear samples in another order than the
plain contraction); in bfloat16 one bf16 rounding step (both accumulate in
float32 and round once at the end, so they differ only where the two
float32 sums straddle a bf16 rounding boundary), at the fixed and the
adaptive sampling grid. BN + ReLU: 1e-6 in float32, one bf16 step in
bfloat16. Conv + BN + ReLU: 1e-4 in float32 (summation order over 27 * C
products), one bf16 step in bfloat16 (the tensor cores multiply bf16
exactly and accumulate in float32, in another order than the plain conv).
The stem conv: one bf16 step plus 2^-15 and 2^-20 of the sum of |x * w|
an output adds up (`stem_close`: 1,029 float32 products summed in other
orders). MViTv2's attention pools: one bf16 step plus 1e-4
(`attn_pool_close`: the conv's and the norm's float32 sums in another
order than the plain version's, each rounded once).
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from step_tpu_torch.config import PRESETS
from step_tpu_torch.inference import (detect_clip, detect_video_stream,
                                      detect_video_stream_batched, nms_surface,
                                      nms_surface_plain)
from step_tpu_torch.kernels import NMS_MAX_BOXES
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.ops.conv3d import conv3x3x3_bn_relu, conv3x3x3_bn_relu_plain
from step_tpu_torch.ops.fused_bn_relu import (fused_scale_bias_relu,
                                              fused_scale_bias_relu_plain)
from step_tpu_torch.ops.kernel_op import LAUNCHES
from step_tpu_torch.ops.nms import EPS, NEG, _f32, nms_many, nms_many_plain, premask_scores
from step_tpu_torch.ops.pool import (max_pool3d_same, max_pool3x3_same,
                                    max_pool3x3_same_plain, same_padding)
from step_tpu_torch.ops.roi_align import tube_roi_align, tube_roi_align_plain
from step_tpu_torch.tubes.linking import link_tubes_multiclass_k
from step_tpu_torch.utils import spans
from step_tpu_torch.utils.init import init_detector_

pytestmark = pytest.mark.gpu

# The kernel configuration's backbone operators: K3, K4, K5.
KERNEL_CONFIG_OPS = ("conv3x3x3_bn_relu", "scale_bias_relu", "max_pool3x3_same")
BF16_RTOL = 2.0 ** -7


# Models of the 3x3x3 / stride 1 / SAME max pool on NCDHW tensors, written
# with torch.where so that each keeps the winning value's bits. The CPU tests
# (test_torch_port_backbone_kernels.py) use them too.
def _take_later(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """m takes v where v > m or v is NaN: PyTorch's max_pool3d rule."""
    return torch.where((v.float() > m.float()) | v.isnan(), v, m)


def pool_scan_model(x: torch.Tensor) -> torch.Tensor:
    """PyTorch's max_pool3d as it is written: from -inf, the 27 taps in
    (t, h, w) order, taps past the border skipped (here: padded with -inf,
    which never wins)."""
    T, H, W = x.shape[2:]
    xp = F.pad(x, (1, 1, 1, 1, 1, 1), value=float("-inf"))
    m = torch.full_like(x, float("-inf"))
    for dt in range(3):
        for dh in range(3):
            for dw in range(3):
                m = _take_later(m, xp[:, :, dt:dt + T, dh:dh + H, dw:dw + W])
    return m


def pool_separable_model(x: torch.Tensor) -> torch.Tensor:
    """K5's order (csrc/pool3d.cu): three taps along w, then h, then t, each
    in ascending order with the index clamped to the tensor."""
    def along(t: torch.Tensor, dim: int) -> torch.Tensor:
        idx = torch.arange(t.shape[dim], device=t.device)
        a, b, c = (t.index_select(dim, (idx + d).clamp(0, t.shape[dim] - 1))
                   for d in (-1, 0, 1))
        return _take_later(_take_later(a, b), c)
    return along(along(along(x, 4), 3), 2)


def special_values(seed: int, shape, dtype: torch.dtype) -> torch.Tensor:
    """An NCDHW tensor drawn from +-0, +-1, +-inf and NaNs of both signs
    with varied payloads, as raw bits."""
    if dtype == torch.float32:
        bits = np.array([0x00000000, 0x80000000, 0x3F800000, 0xBF800000, 0x7F800000,
                         0xFF800000, 0x7FC00001, 0xFFC00123, 0x7FC0ABCD], np.uint32)
        ints = np.int32
    else:
        bits = np.array([0x0000, 0x8000, 0x3F80, 0xBF80, 0x7F80, 0xFF80, 0x7FC1,
                         0xFFC3, 0x7FD5], np.uint16)
        ints = np.int16
    drawn = bits[np.random.RandomState(seed).randint(0, len(bits), shape)].view(ints)
    return torch.from_numpy(drawn).view(dtype)


def raw_bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16)


def pad_then_pool(x: torch.Tensor, window, stride) -> torch.Tensor:
    """A TF-SAME max pool as written out: -inf pads on each axis (the odd
    cell on the high side), then PyTorch's pool. The strided pool kernel
    must give its bits; the CPU tests use it too."""
    pads = []
    for n, k, s in reversed(list(zip(x.shape[2:], window, stride))):
        pad = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [pad // 2, pad - pad // 2]
    return F.max_pool3d(F.pad(x, pads, value=float("-inf")), window, stride)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# A model of K1's algorithm (csrc/nms.cu), which the CPU tests hold bit for
# bit against nms_many_plain and the Pallas kernel.
def nms_suppression(boxes: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """The suppression matrix of each group of boxes `[G, P, 4]`:
    `sup[g, i, j] = iou(i, j) > thr`, i the chosen box, in the Pallas
    kernel's order, with a NaN coordinate giving a NaN IoU (no suppression).
    The kernel packs each row into ceil(P / 32) words."""
    x1, y1, x2, y2 = boxes.to(torch.float32).unbind(-1)        # [G, P]
    area = (x2 - x1) * (y2 - y1)
    c, o = (lambda t: t[:, :, None]), (lambda t: t[:, None, :])
    w = torch.clamp(torch.minimum(c(x2), o(x2)) - torch.maximum(c(x1), o(x1)), min=0.0)
    h = torch.clamp(torch.minimum(c(y2), o(y2)) - torch.maximum(c(y1), o(y1)), min=0.0)
    inter = w * h
    iou = inter / torch.clamp(c(area) + o(area) - inter, min=EPS)
    return iou > _f32(iou_threshold)


def nms_rank_model(boxes: torch.Tensor, live: torch.Tensor, iou_threshold: float,
                   max_keep: int):
    """Greedy NMS as K1 runs it: groups of boxes `[G, P, 4]` shared by the
    C problems of pre-masked live scores `[G, C, P]` → keep_idx
    `[G, C, K]` int32, keep_mask f32.

    The suppression matrix is computed once per group. Each box's key is
    its rank in the greedy order (score descending, ties to the lower
    index) times 1024 plus its index; a step keeps the alive box with the
    least key and removes it and its row of the matrix from the alive set.
    When that box's rank is not below the count of scores above NEG/2, the
    problem freezes: mask 0 and the lowest index of the maximum of the live
    scores as they stand (alive boxes at their score, removed ones at NEG).
    A frozen step changes nothing, so every later slot repeats it."""
    G, C, P = live.shape
    sup = nms_suppression(boxes, iou_threshold)[:, None].expand(G, C, P, P)
    iota = torch.arange(P)
    mine, other = live[..., :, None], live[..., None, :]
    ahead = (other > mine) | ((other == mine) & (iota[None, :] < iota[:, None]))
    key = ahead.sum(-1) * 1024 + iota                            # [G, C, P]
    nsel = (live > NEG / 2).sum(-1, keepdim=True)
    alive = torch.ones((G, C, P), dtype=torch.bool)
    idxs, oks = [], []
    for _ in range(max_keep):
        least = torch.where(alive, key, 2 ** 31 - 1).min(-1, keepdim=True).values
        ok = least // 1024 < nsel
        now = torch.where(alive, live, torch.full_like(live, NEG))
        top = now.max(-1, keepdim=True).values
        frozen = torch.where(now == top, iota, P).min(-1, keepdim=True).values
        idx = torch.where(ok, least % 1024, frozen)              # [G, C, 1]
        row = torch.gather(sup, 2, idx[..., None].expand(G, C, 1, P))[:, :, 0]
        alive = alive & ~(ok & (row | (iota == idx)))
        idxs.append(idx[..., 0])
        oks.append(ok[..., 0])
    return (torch.stack(idxs, -1).to(torch.int32), torch.stack(oks, -1).to(torch.float32))


def nms_inputs(seed: int, N: int, P: int, case: str = "ties"):
    """Boxes `[N, P, 4]`, scores and valid `[N, P]` as numpy float32 arrays,
    and the score threshold. Every case has exact score ties, zero-area
    boxes, duplicates, invalid slots and an all-invalid problem (row 1);
    "nonfinite" adds boxes with NaN and +-inf coordinates; "low" draws
    scores from -2e9 up to 0.5, exact NEG and NEG/2 among them, under a
    threshold of -1e10, so that problems freeze on live scores at or below
    NEG/2 and on removed boxes above them."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-10, 100, (N, P, 2))
    wh = rng.uniform(0, 50, (N, P, 2))
    wh[rng.rand(N, P) < 0.15] = 0.0                              # zero-area
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    dup = rng.rand(N, P) < 0.1
    boxes[dup] = np.repeat(boxes[:, :1], P, axis=1)[dup]         # duplicates
    scores = (rng.randint(0, 6, (N, P)) / 5.0).astype(np.float32)  # ties
    scores[N // 2:] = rng.rand(N - N // 2, P).astype(np.float32)
    scores[0, :2] = 0.05                                         # == threshold
    valid = (rng.rand(N, P) > 0.25).astype(np.float32)
    valid[1 % N] = 0.0                                           # all invalid
    score_threshold = 0.05
    if case == "nonfinite":
        odd = rng.rand(N, P, 4) < 0.04
        boxes[odd] = rng.choice(np.float32([np.nan, np.inf, -np.inf]), int(odd.sum()))
    elif case == "low":
        levels = np.float32([-2e9, -1.5e9, NEG, -7e8, NEG / 2, -4e8, 0.1, 0.5])
        scores = levels[rng.randint(0, len(levels), (N, P))]
        score_threshold = -1e10
    return boxes, scores, valid, score_threshold


@pytest.mark.parametrize("case", ["ties", "nonfinite", "low"])
@pytest.mark.parametrize("N,P,K,thr", [(3456, 16, 16, 0.5), (100, 32, 40, 0.3),
                                       (7, 1, 4, 0.5), (513, 11, 5, 0.7)])
def test_nms_kernel_equals_plain(cuda, N, P, K, thr, case):
    b, s, v, sthr = nms_inputs(N, N, P, case)
    boxes, scores, valid = (torch.from_numpy(a).to(cuda) for a in (b, s, v))
    before = LAUNCHES["nms_many"]
    idx, mask = nms_many(boxes, scores, thr, K, sthr, valid)
    assert LAUNCHES["nms_many"] == before + 1
    ridx, rmask = nms_many_plain(boxes, premask_scores(scores, sthr, valid), thr, K)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx) and torch.equal(mask, rmask)


@pytest.mark.parametrize("P", [33, 64, 200, 1024])
def test_nms_kernel_equals_plain_past_32_boxes(cuda, P):
    b, s, v, sthr = nms_inputs(P, 24, P, "nonfinite")
    boxes, scores, valid = (torch.from_numpy(a).to(cuda) for a in (b, s, v))
    idx, mask = nms_many(boxes, scores, 0.5, 40, sthr, valid)
    ridx, rmask = nms_many_plain(boxes, premask_scores(scores, sthr, valid), 0.5, 40)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx) and torch.equal(mask, rmask)
    assert float(mask.sum()) > 24                          # not a trivial answer


def test_nms_kernel_refuses_more_boxes_than_its_limit(cuda):
    b, s, _, _ = nms_inputs(0, 2, NMS_MAX_BOXES + 1)
    with pytest.raises(ValueError, match=f"NMS_MAX_BOXES = {NMS_MAX_BOXES}"):
        nms_many(torch.from_numpy(b).to(cuda), torch.from_numpy(s).to(cuda), 0.5, 4)


def test_nms_kernel_keeps_a_nan_box(cuda):
    """A box with a NaN coordinate has a NaN IoU with every box, which
    suppresses nothing, as in the JAX package."""
    boxes = torch.tensor([[[0, 0, 10, 10], [1, 1, float("nan"), 11],
                           [0, 0, 10, 10.5]]], device=cuda)
    idx, mask = nms_many(boxes, torch.tensor([[0.9, 0.8, 0.7]], device=cuda), 0.5, 3, 0.0)
    assert idx.tolist() == [[0, 1, 0]] and mask.tolist() == [[1.0, 1.0, 0.0]]


def surface_inputs(seed: int, B: int, P: int, T: int, C: int, dtype=torch.float32):
    """tubes `[B, P, T, 4]` with a few NaN and infinite coordinates, scores
    `[B, P, C]` in `dtype` with ties, zero on padding slots, and the
    proposal mask `[B, P]` (the last quarter of the slots padding)."""
    rng = np.random.RandomState(seed)
    boxes, _, _, _ = nms_inputs(seed, B * T, P, "nonfinite")
    tubes = torch.from_numpy(boxes.reshape(B, T, P, 4)).transpose(1, 2).contiguous()
    mask = torch.ones(B, P)
    mask[:, P - P // 4:] = 0.0
    scores = torch.from_numpy((rng.randint(0, 9, (B, P, C)) / 8.0).astype(np.float32))
    return tubes, (scores * mask[..., None]).to(dtype), mask


@pytest.mark.parametrize("B,P", [(1, 16), (8, 16), (2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nms_surface_kernel_equals_plain(cuda, B, P, dtype):
    cfg = PRESETS["ucf_3step"].replace(max_proposals=max(P, 16))
    tubes, scores, mask = (t.to(cuda) for t in surface_inputs(B + P, B, P, 18, 24, dtype))
    got = nms_surface(tubes, scores, mask, cfg)
    want = nms_surface_plain(tubes, scores, mask, cfg)
    torch.cuda.synchronize()
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
        assert torch.equal(raw_bits(got[key]), raw_bits(want[key])), key
    assert float(want["frame_mask"].sum()) > 0


def test_nms_surface_is_one_launch(cuda):
    cfg = PRESETS["ucf_3step"]
    tubes, scores, mask = (t.to(cuda) for t in surface_inputs(1, 2, 16, 18, 24))
    surface, many = LAUNCHES["nms_surface"], LAUNCHES["nms_many"]
    for _ in range(3):
        nms_surface(tubes, scores, mask, cfg)
    assert LAUNCHES["nms_surface"] == surface + 3 and LAUNCHES["nms_many"] == many


def _roi_inputs(seed, B, Tp, H, C, N, T, dtype):
    rng = np.random.RandomState(seed)
    feat = torch.from_numpy(rng.randn(B, Tp, H, H, C).astype(np.float32))
    lo = rng.uniform(-0.3, 1.0, (B, N, 1, 2)) * H * 16
    size = rng.uniform(0, 0.8, (B, N, 1, 2)) * H * 16
    tubes = np.concatenate([lo, lo + size], -1) + rng.randn(B, N, T, 4) * 3
    return feat.to(dtype), torch.from_numpy(tubes.astype(np.float32))


@pytest.mark.parametrize("pooled,ratio,C", [(7, 2, 832), (3, 1, 5), (7, 3, 1100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_kernel_matches_plain(cuda, pooled, ratio, C, dtype):
    feat, tubes = (t.to(cuda) for t in _roi_inputs(1, 2, 5, 14, C, 16, 18, dtype))
    before = LAUNCHES["tube_roi_align"]
    got = tube_roi_align(feat, tubes, pooled, 1 / 16, ratio)
    assert LAUNCHES["tube_roi_align"] == before + 1
    want = tube_roi_align_plain(feat, tubes, pooled, 1 / 16, ratio)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=1e-5)


@pytest.mark.parametrize("C", [832, 13])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_kernel_adaptive_matches_plain(cuda, C, dtype):
    """sampling_ratio=0: per ROI ceil(extent / pooled) samples per axis,
    capped at adaptive_max_ratio; the boxes here reach far past the 14x14
    map, so the cap bites."""
    feat, tubes = _roi_inputs(3, 2, 5, 14, C, 16, 18, dtype)
    tubes[:, :4] = torch.tensor([-300.0, -200.0, 500.0, 450.0])
    tubes[:, 4] = torch.tensor([10.0, 20.0, 30.0, 25.0])
    feat, tubes = feat.to(cuda), tubes.to(cuda)
    before = LAUNCHES["tube_roi_align"]
    got = tube_roi_align(feat, tubes, 7, 1 / 16, 0)
    assert LAUNCHES["tube_roi_align"] == before + 1
    want = tube_roi_align_plain(feat, tubes, 7, 1 / 16, 0)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_roi_kernel_scalar_tail_on_unaligned_features(cuda, dtype):
    """Features whose pointer is not 16-byte aligned take the one-channel
    variant of the kernel; the result is the plain version's."""
    feat, tubes = _roi_inputs(4, 2, 5, 14, 64, 8, 18, dtype)
    flat = torch.empty(feat.numel() + 1, dtype=dtype, device=cuda)
    unaligned = flat[1:].view(feat.shape)
    unaligned.copy_(feat.to(cuda))
    assert unaligned.data_ptr() % 16 != 0 and unaligned.is_contiguous()
    tubes = tubes.to(cuda)
    got = tube_roi_align(unaligned, tubes, 7, 1 / 16, 2)
    want = tube_roi_align_plain(unaligned, tubes, 7, 1 / 16, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(),
                               rtol=1e-4 if dtype == torch.float32 else BF16_RTOL,
                               atol=1e-4 if dtype == torch.float32 else 1e-5)


def test_roi_kernel_refuses_what_it_does_not_take(cuda):
    feat, tubes = (t.to(cuda)
                   for t in _roi_inputs(2, 1, 5, 14, 8, 4, 18, torch.float32))
    with pytest.raises(ValueError, match="dtype"):
        tube_roi_align(feat.half(), tubes)
    with pytest.raises(ValueError, match="contiguous"):
        tube_roi_align(feat.transpose(2, 3), tubes)


def test_tiny_detector_on_card_matches_cpu(cuda):
    cfg = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8,
                                       image_size=64, compute_dtype="float32")
    model = init_detector_(STEPDetector(cfg).eval(), seed=3)
    props, pmask = STEPDetector.initial_proposals(cfg, 2, device="cpu")
    rgb = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (2, cfg.total_frames, 64, 64, 3)).astype(np.uint8))
    ref = detect_clip(model, rgb, props, pmask)
    got = detect_clip(model.to(cuda), rgb.to(cuda), props.to(cuda), pmask.to(cuda))
    torch.testing.assert_close(got["tubes"].cpu(), ref["tubes"], rtol=0, atol=1e-3)
    torch.testing.assert_close(got["tube_scores"].cpu(), ref["tube_scores"],
                               rtol=0, atol=1e-4)
    surface = nms_surface(ref["tubes"].to(cuda), ref["tube_scores"].to(cuda),
                          pmask.to(cuda), cfg)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        assert torch.equal(surface[key].cpu(), ref[key]), key


def test_program_spans_split_a_main_path_request(cuda):
    """A B=2 main-path request under the whole profiler: the device time
    launched under `model.preprocess`, `model.backbone`, `model.refine` and
    `detect.nms` sums to that launched under a span around the call, within
    2%, and each of them launched work."""
    from step_tpu_torch.profile_request import build, chrome_trace, span_ms

    cfg, model = build("main", cuda)
    props, pmask = STEPDetector.initial_proposals(cfg, 2, device=cuda)
    rgb = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (2, cfg.total_frames, cfg.image_size, cfg.image_size, 3))
        .astype(np.uint8)).to(cuda)
    detect_clip(model, rgb, props, pmask)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("request"):
            detect_clip(model, rgb, props, pmask)
        torch.cuda.synchronize()
    stages = ("model.preprocess", "model.backbone", "model.refine", "detect.nms")
    ms = span_ms(chrome_trace(prof)[0], stages + ("request", "model.stem"))
    assert all(ms[s][0] > 0 and ms[s][2] == 1 for s in stages + ("model.stem",)), ms
    assert sum(ms[s][0] for s in stages) == pytest.approx(ms["request"][0], rel=0.02), ms


def test_a_recorded_request_puts_its_idle_down_to_the_program_spans(cuda):
    """A B=2 main-path request under the profiler of the device alone with
    the spans recorded (`profile_request.recorded_idle`): its idle time,
    split by the innermost span, lies inside the window, and the request's
    stages are among the spans it names."""
    from step_tpu_torch.profile_request import build, recorded_idle, request_fn

    cfg, model = build("main", cuda)
    run, make = request_fn("main", cfg, model, 2, cuda)
    x = make()
    run(x)
    out = recorded_idle(run, x, cuda)
    idle = out["idle_gaps_untraced"]
    print("recorded main-path B=2 request:", out)
    assert 0 < sum(idle.values()) < out["window_ms"]
    assert {"detect.clip", "model.backbone", "model.refine"} & set(idle), idle


def test_recorded_spans_share_the_device_traces_clock(cuda):
    """The host's `time.time_ns()`, on which `spans.recording()` keeps its
    spans, against the chrome trace's clock (`baseTimeNanoseconds + ts *
    1000`) under the profiler of the device alone. The offset is measured
    from launches bracketed by two readings of `time_ns()` with nothing
    else between them: each runtime launch call lies inside its bracket, so
    the trace's clock runs ahead of the host's by no less than the largest
    `launch end - bracket end` and no more than the least `launch start -
    bracket start`; both bounds lie within 20 µs. Then spans recorded
    around one launch each: no kernel starts on the device before its span
    opened, and each launch call lies inside its span, beyond that offset.
    Prints (with -s) the offset and a span's cost, off, recording, and
    recording under the device's profiler, in ns."""
    from step_tpu_torch.profile_request import chrome_trace

    x = torch.zeros(1 << 16, device=cuda)
    n = 200
    x.add_(1)
    torch.cuda.synchronize()
    brackets = []
    with spans.recording() as kept:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                t0 = time.time_ns()
                x.add_(1)
                brackets.append((t0, time.time_ns()))
                time.sleep(1e-4)
            for _ in range(n):
                with spans.span("detect.clip"):
                    x.add_(1)
                time.sleep(1e-4)
            torch.cuda.synchronize()
    events, base = chrome_trace(prof)
    kernels = sorted((e for e in events if e.get("cat") == "kernel"), key=lambda e: e["ts"])
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    us = lambda t: (t - base) / 1e3  # noqa: E731
    opened = sorted((us(a), us(b)) for _, a, b, _ in kept)
    assert base > 0 and len(kernels) == 2 * n and len(opened) == n
    bare, inside = kernels[:n], kernels[n:]
    report = {"kernel_before_span_us": max(a - k["ts"] for (a, _), k in zip(opened, inside))}
    pairs = [((us(a), us(b)), launches.get(k.get("args", {}).get("correlation")))
             for (a, b), k in zip(brackets, bare)]
    if all(e is not None for _, e in pairs):
        lo = max(e["ts"] + e["dur"] - b for (_, b), e in pairs)
        hi = min(e["ts"] - a for (a, _), e in pairs)
        spanned = [(ab, launches[k["args"]["correlation"]]) for ab, k in zip(opened, inside)]
        outside = max(max(a + lo - e["ts"], e["ts"] + e["dur"] - b - hi) for (a, b), e in spanned)
        report.update(offset_us=(lo, hi), launch_outside_span_us=outside)
        assert -20.0 <= lo <= hi <= 20.0, report
        assert outside <= 1.0, report
        assert report["kernel_before_span_us"] <= max(0.0, -lo), report
    else:       # no runtime events: a kernel starts after its launch, so after its bracket opened
        report["offset_us"] = (None, min(k["ts"] - us(a) for (a, _), k in zip(brackets, bare)))
        assert report["offset_us"][1] >= -20.0, report
        assert report["kernel_before_span_us"] <= 20.0, report

    def cost(k=100_000):
        t0 = time.perf_counter_ns()
        for _ in range(k):
            with spans.span("detect.clip"):
                pass
        return (time.perf_counter_ns() - t0) / k

    off = cost()
    with spans.recording():
        recording = cost()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
            profiled = cost(20_000)
    report.update(span_ns_off=off, span_ns_recording=recording, span_ns_recording_profiled=profiled)
    print("recorded spans against the device trace:", report)


def _ncdhw(seed, shape, dtype, channels_last=True):
    """A random NCDHW tensor on the card, channels_last_3d unless asked."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32))
    x = x.to("cuda", dtype)
    return x.contiguous(memory_format=torch.channels_last_3d) if channels_last else x


def _close(got, want, dtype, f32_tol):
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=f32_tol, atol=f32_tol)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=1e-5)


# The Mixed_3 and tail pools, C = 13 (one-element vectors), degenerate
# frames, and shapes whose H, W and C do not divide the kernel's tiles
# (17 rows → 3 row tiles, 37 and 70 columns → 2 and 3 column tiles, 40 and
# 520 channels → a partial slab).
@pytest.mark.parametrize("shape", [(2, 192, 9, 28, 28), (2, 256, 9, 28, 28),
                                   (3, 13, 5, 7, 7), (1, 1, 1, 1, 1), (1, 8, 1, 1, 5),
                                   (1, 40, 3, 17, 37), (2, 520, 2, 9, 70)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernel_equals_plain(cuda, shape, dtype):
    x = _ncdhw(5, shape, dtype)
    before = LAUNCHES["max_pool3x3_same"]
    got = max_pool3x3_same(x)
    assert LAUNCHES["max_pool3x3_same"] == before + 1
    want = max_pool3x3_same_plain(x)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernel_propagates_nan_and_inf(cuda, dtype):
    x = _ncdhw(6, (2, 16, 4, 6, 6), dtype)
    x[0, 3, 1, 2, 2] = float("nan")
    x[1, :, :, :, :] = float("-inf")
    x[1, 5, 0, 0, 0] = float("inf")
    got, want = max_pool3x3_same(x), max_pool3x3_same_plain(x)
    torch.cuda.synchronize()
    nan = want.isnan()
    assert int(nan.sum()) == 27 and torch.equal(got.isnan(), nan)
    assert torch.equal(got[~nan], want[~nan])
    assert bool((got[1] == float("-inf")).any()) and bool((got[1] == float("inf")).any())


@pytest.mark.parametrize("shape", [(2, 64, 5, 7, 7), (1, 40, 3, 17, 37), (3, 13, 4, 5, 6)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernel_keeps_nan_payloads_and_signed_zeros(cuda, shape, dtype):
    """On +-0, +-inf and NaNs with payloads, the kernel's bits are those of
    PyTorch's 27-tap scan: the first maximum in (t, h, w) order, or the last
    NaN."""
    x = special_values(15, shape, dtype).to(cuda)
    x = x.contiguous(memory_format=torch.channels_last_3d)
    got = max_pool3x3_same(x)
    torch.cuda.synchronize()
    assert torch.equal(raw_bits(got), raw_bits(pool_scan_model(x)))
    want = max_pool3x3_same_plain(x)
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan) and torch.equal(raw_bits(got[~nan]),
                                                         raw_bits(want[~nan]))


# The strided pool kernel (csrc/pool3d_same.cu): the stem's MaxPool_2a, 3a
# and 4a at B=2, the classifier's MaxPool_5a at B=1, MaxPool_2a at a chunk
# stem's T = 3, then odd H and W, C = 13 (one-element vectors) and a window
# of three sizes.
STRIDED_POOL_CASES = [((2, 64, 9, 112, 112), (1, 3, 3), (1, 2, 2)),
                      ((2, 192, 9, 56, 56), (1, 3, 3), (1, 2, 2)),
                      ((2, 480, 9, 28, 28), (3, 3, 3), (2, 2, 2)),
                      ((1, 832, 8, 7, 7), (2, 2, 2), (2, 2, 2)),
                      ((2, 64, 3, 112, 112), (1, 3, 3), (1, 2, 2)),
                      ((1, 40, 5, 17, 23), (3, 3, 3), (2, 2, 2)),
                      ((2, 13, 5, 9, 11), (1, 3, 3), (1, 2, 2)),
                      ((1, 24, 4, 7, 9), (3, 2, 1), (1, 2, 2))]


@pytest.mark.parametrize("shape,window,stride", STRIDED_POOL_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_pool_kernel_equals_pad_then_pool(cuda, shape, window, stride, dtype):
    x = _ncdhw(8, shape, dtype)
    before = LAUNCHES["max_pool3d_same"]
    got = max_pool3d_same(x, window, stride)
    assert LAUNCHES["max_pool3d_same"] == before + 1
    want = pad_then_pool(x, window, stride)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(raw_bits(got), raw_bits(want))


@pytest.mark.parametrize("shape,window,stride", STRIDED_POOL_CASES[3:])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_pool_kernel_keeps_nan_payloads_signed_zeros_and_inf(cuda, shape, window,
                                                                     stride, dtype):
    """On +-0, +-inf and NaNs with payloads the kernel gives the bits of
    the -inf pad and PyTorch's scan on the card. The CPU's pool gives the
    same bits but for NaN payloads in bfloat16, which it computes in float32
    and returns as the canonical NaN: there the NaNs fall where the
    kernel's do."""
    x = special_values(16, shape, dtype).contiguous(memory_format=torch.channels_last_3d)
    got = max_pool3d_same(x.to(cuda), window, stride)
    torch.cuda.synchronize()
    assert torch.equal(raw_bits(got), raw_bits(pad_then_pool(x.to(cuda), window, stride)))
    on_cpu, got = pad_then_pool(x, window, stride), got.cpu()
    nan = on_cpu.isnan()
    assert torch.equal(got.isnan(), nan)
    assert torch.equal(raw_bits(got[~nan]), raw_bits(on_cpu[~nan]))
    if dtype == torch.float32:
        assert torch.equal(raw_bits(got), raw_bits(on_cpu))


def test_strided_pool_kernel_copies_an_input_that_is_not_channels_last(cuda):
    from step_tpu_torch import kernels

    x = _ncdhw(9, (2, 40, 9, 15, 17), torch.bfloat16, channels_last=False)
    before = kernels.ndhwc.copies
    got = max_pool3d_same(x, (3, 3, 3), (2, 2, 2))
    assert kernels.ndhwc.copies == before + 1
    assert torch.equal(raw_bits(got), raw_bits(pad_then_pool(x, (3, 3, 3), (2, 2, 2))))


# K5 at B=32 main-path shapes: Mixed_3c's 116 MB input is more than the
# 50 MB L2; the tails' 209 MB too.
@pytest.mark.parametrize("shape", [(32, 256, 9, 28, 28), (512, 832, 5, 7, 7)])
def test_pool_kernel_equals_plain_above_l2(cuda, shape):
    x = _ncdhw(10, shape, torch.bfloat16)
    got, want = max_pool3x3_same(x), max_pool3x3_same_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(raw_bits(got), raw_bits(want))


@pytest.mark.parametrize("window,stride,op", [((3, 3, 3), (1, 1, 1), "max_pool3x3_same"),
                                              ((1, 3, 3), (1, 2, 2), "max_pool3d_same"),
                                              ((2, 2, 2), (2, 2, 2), "max_pool3d_same")])
def test_eager_pools_launch_without_the_operator_and_exports_keep_it(cuda, window, stride,
                                                                     op):
    """An eager no-grad pool of a CUDA tensor launches its kernel without
    the custom operator's dispatch (the profiler records no `step::` call,
    where a call of the operator itself shows one); `torch.export` on the
    card still records the operator as one node, and the program gives the
    same bits."""
    from step_tpu_torch.models.i3d import max_pool_3d

    class Pool(torch.nn.Module):
        def forward(self, x):
            return max_pool_3d(x, window, stride)

    x = _ncdhw(4, (2, 24, 5, 9, 11), torch.bfloat16)
    def step_calls(fn):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
            out = fn()
        return out, [e.key for e in p.key_averages() if e.key.startswith("step::")]

    before = LAUNCHES[op]
    with torch.no_grad():
        got, seen = step_calls(lambda: Pool()(x))
        assert seen == [] and LAUNCHES[op] == before + 1
        _, control = step_calls(lambda: torch.ops.step.max_pool3x3_same(x))
    assert control == ["step::max_pool3x3_same"]
    with torch.no_grad():
        program = torch.export.export(Pool(), (x,))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count(f"step.{op}.default") == 1 and not any(
        "max_pool3d" in t and not t.startswith("step.") for t in targets), targets
    with torch.no_grad():
        again = program.module()(x)
    torch.cuda.synchronize()
    assert torch.equal(raw_bits(got), raw_bits(again))
    assert torch.equal(raw_bits(got), raw_bits(pad_then_pool(x, window, stride)))


def test_main_path_pools_run_on_the_hand_written_kernels(cuda, monkeypatch):
    """A no-grad B=2 `ucf_3step` main-path request (bf16, BN folded): its
    profile holds no PyTorch pool, K5 launches 13 times and the strided
    kernel 3 (MaxPool_2a, 3a, 4a), no pool input is copied into
    channels_last_3d, and its five outputs equal those of the same request
    with PyTorch's pools (the plain versions swapped in) bit for bit."""
    from step_tpu_torch import kernels
    from step_tpu_torch.ops import pool
    from step_tpu_torch.ops.pool import max_pool3d_same_plain
    from step_tpu_torch.profile_request import build

    cfg, model = build("main", cuda)
    props, pmask = STEPDetector.initial_proposals(cfg, 2, device=cuda)
    rgb = torch.from_numpy(np.random.RandomState(6).randint(
        0, 256, (2, cfg.total_frames, cfg.image_size, cfg.image_size, 3))
        .astype(np.uint8)).to(cuda)
    with torch.no_grad():
        detect_clip(model, rgb, props, pmask)
        counts = (LAUNCHES["max_pool3x3_same"], LAUNCHES["max_pool3d_same"], kernels.ndhwc.copies)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            got = detect_clip(model, rgb, props, pmask)
            torch.cuda.synchronize()
        after = (LAUNCHES["max_pool3x3_same"], LAUNCHES["max_pool3d_same"], kernels.ndhwc.copies)
        monkeypatch.setattr(pool, "max_pool3x3_same", max_pool3x3_same_plain)
        monkeypatch.setattr(pool, "max_pool3d_same", max_pool3d_same_plain)
        want = detect_clip(model, rgb, props, pmask)
    names = {e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert not [n for n in names if "max_pool3d_with_indices" in n], names
    assert any("max_pool3x3_kernel" in n for n in names)
    assert any("max_pool3d_same_kernel" in n for n in names)
    assert [a - b for a, b in zip(after, counts)] == [13, 3, 0]
    assert got.keys() == want.keys() and len(got) == 5
    for key in got:
        assert torch.equal(raw_bits(got[key]) if got[key].is_floating_point() else got[key],
                           raw_bits(want[key]) if want[key].is_floating_point()
                           else want[key]), key


@pytest.mark.parametrize("shape", [(2, 64, 9, 28, 28), (3, 13, 5, 7, 7), (1, 5, 1, 1, 1),
                                   (16, 48, 5, 7, 7), (2, 37, 3, 5, 7)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_relu_kernel_matches_plain(cuda, shape, dtype):
    C = shape[1]
    x = _ncdhw(7, shape, dtype)
    rng = np.random.RandomState(8)
    scale = torch.from_numpy((rng.rand(C) * 2 + 0.1).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.randn(C).astype(np.float32)).cuda()
    before = LAUNCHES["scale_bias_relu"]
    got = fused_scale_bias_relu(x, scale, bias)
    assert LAUNCHES["scale_bias_relu"] == before + 1
    want = fused_scale_bias_relu_plain(x, scale, bias)
    torch.cuda.synchronize()
    _close(got, want, dtype, 1e-6)


@pytest.mark.parametrize("N,C,T,H,W,K", [(2, 64, 5, 14, 14, 192), (3, 13, 3, 5, 7, 70),
                                         (1, 1, 1, 1, 1, 1), (1, 17, 2, 3, 1, 65)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_bn_relu_kernel_matches_plain(cuda, N, C, T, H, W, K, dtype):
    x = _ncdhw(9, (N, C, T, H, W), dtype)
    rng = np.random.RandomState(10)
    w = torch.from_numpy((rng.randn(K, C, 3, 3, 3) / np.sqrt(27 * C)).astype(np.float32))
    scale = torch.from_numpy((rng.rand(K) + 0.5).astype(np.float32))
    bias = torch.from_numpy((rng.randn(K) * 0.1).astype(np.float32))
    w, scale, bias = w.cuda(), scale.cuda(), bias.cuda()
    before = LAUNCHES["conv3x3x3_bn_relu"]
    got = conv3x3x3_bn_relu(x, w, scale, bias)
    assert LAUNCHES["conv3x3x3_bn_relu"] == before + 1
    want = conv3x3x3_bn_relu_plain(x, w, scale, bias)
    torch.cuda.synchronize()
    _close(got, want, dtype, 1e-4)


# Every (C, K) of the 3x3x3 units of one request (models/i3d.py
# INCEPTION_CHANNELS): Conv3d_2c, Mixed_3b/3c, Mixed_4b-4f, Mixed_5b/5c.
INCEPTION_CONV_CK = [(64, 192), (96, 128), (16, 32), (128, 192), (32, 96),
                     (96, 208), (16, 48), (112, 224), (24, 64), (128, 256),
                     (144, 288), (32, 64), (160, 320), (32, 128), (192, 384),
                     (48, 128)]


@pytest.mark.parametrize("C,K", INCEPTION_CONV_CK)
def test_conv_bf16_tensor_core_kernel_at_every_inception_width(cuda, C, K):
    """M = 1*3*7*9 = 189 positions: one full 128-row tile and a ragged one."""
    x = _ncdhw(12, (1, C, 3, 7, 9), torch.bfloat16)
    rng = np.random.RandomState(C + K)
    w = torch.from_numpy((rng.randn(K, C, 3, 3, 3) / np.sqrt(27 * C)).astype(np.float32))
    scale = torch.from_numpy((rng.rand(K) + 0.5).astype(np.float32))
    bias = torch.from_numpy((rng.randn(K) * 0.1).astype(np.float32))
    w, scale, bias = w.cuda(), scale.cuda(), bias.cuda()
    before = LAUNCHES["conv3x3x3_bn_relu"]
    got = conv3x3x3_bn_relu(x, w, scale, bias)
    assert LAUNCHES["conv3x3x3_bn_relu"] == before + 1
    want = conv3x3x3_bn_relu_plain(x, w, scale, bias)
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16, None)
    assert float(want.float().abs().max()) > 0.1          # not a trivial output


def test_conv_bf16_kernel_copies_inputs_that_are_not_channels_last(cuda):
    x = _ncdhw(13, (2, 24, 3, 5, 6), torch.bfloat16, channels_last=False)
    assert not x.is_contiguous(memory_format=torch.channels_last_3d)
    w = torch.randn(40, 24, 3, 3, 3, device="cuda") * 0.05
    s, b = torch.rand(40, device="cuda") + 0.5, torch.randn(40, device="cuda") * 0.1
    _close(conv3x3x3_bn_relu(x, w, s, b), conv3x3x3_bn_relu_plain(x, w, s, b),
           torch.bfloat16, None)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_unit_weight_cache_follows_load_state_dict(cuda, dtype):
    """A fused Unit3D keeps its kernel's weight layout between calls; after
    load_state_dict the kernel gives the new weights' result."""
    from step_tpu_torch.models.i3d import Unit3D

    unit = Unit3D(16, 48, (3, 3, 3), fused_bn_relu=True).eval().to(cuda)
    x = _ncdhw(14, (2, 16, 3, 6, 5), dtype)
    with torch.no_grad():
        unit(x)
        state = {k: v.clone() for k, v in unit.state_dict().items()}
        state["conv.weight"] = torch.randn_like(state["conv.weight"]) * 0.05
        unit.load_state_dict(state)
        got = unit(x)
        want = conv3x3x3_bn_relu_plain(x, state["conv.weight"], *unit.bn.scale_bias())
    torch.cuda.synchronize()
    _close(got, want, dtype, 1e-4)


# ---- the stem unit's convolution (csrc/stem_conv.cu) ----------------------

def stem_close(got, want, x, weight, scale) -> bool:
    """The stem kernel against its plain version on the same inputs: one
    bf16 rounding step, 2^-15, and 2^-20 of the sum of |x * w| * |scale|
    that each output adds up. Both multiply bf16 values exactly and sum
    the 1,029 (343 C) products in float32, in other orders; the sums'
    difference, ~1e-5 at these shapes, moves an output across a rounding
    boundary or off a ReLU's zero."""
    w = weight.to(torch.bfloat16).float().abs()
    sym, pad = same_padding(x, (7, 7, 7), (2, 2, 2))
    xa = x.float().abs()
    terms = (F.conv3d(xa, w, None, 2, sym) if sym is not None
             else F.conv3d(F.pad(xa, pad), w, None, 2))
    if scale is not None:
        terms = terms * scale.abs().view(1, -1, 1, 1, 1)
    err = (got.float() - want.float()).abs()
    return bool((err <= BF16_RTOL * want.float().abs() + 2.0 ** -15
                 + 2.0 ** -20 * terms).all())


# The served stem [32, 18, 224, 224, 3], B=1, the chunk stems of a B=2
# request (3 chunks of 6 frames each), the flow stem (C = 2), and a ragged
# shape whose T, H and W are odd and fill no 8 x 16 tile.
STEM_SHAPES = [(32, 18, 224, 224, 3), (1, 18, 224, 224, 3), (6, 6, 224, 224, 3),
               (2, 18, 224, 224, 2), (2, 7, 33, 45, 3)]
STEM_EPILOGUES = {"bias_relu": (False, True, True), "scale_bias_relu": (True, True, True),
                  "none": (False, False, False)}


@pytest.mark.parametrize("shape", STEM_SHAPES)
@pytest.mark.parametrize("epilogue", sorted(STEM_EPILOGUES))
def test_stem_kernel_matches_plain(cuda, shape, epilogue):
    from step_tpu_torch.ops.stem_conv import stem_conv, stem_conv_plain

    N, T, H, W, C = shape
    x = torch.from_numpy(np.random.RandomState(21).randn(*shape).astype(np.float32))
    x = x.to(cuda, torch.bfloat16).permute(0, 4, 1, 2, 3)      # the detector's view
    rng = np.random.RandomState(22)
    w = torch.from_numpy((rng.randn(64, C, 7, 7, 7) / np.sqrt(343 * C)).astype(np.float32))
    use_scale, use_bias, relu = STEM_EPILOGUES[epilogue]
    scale = torch.from_numpy((rng.rand(64) + 0.5).astype(np.float32)).cuda() if use_scale else None
    bias = torch.from_numpy((rng.randn(64) * 0.1).astype(np.float32)).cuda() if use_bias else None
    w = w.cuda()
    before = LAUNCHES["stem_conv"]
    got = stem_conv(x, w, scale, bias, relu)
    assert LAUNCHES["stem_conv"] == before + 1
    want = stem_conv_plain(x, w, scale, bias, relu)
    torch.cuda.synchronize()
    assert got.shape == want.shape == (N, 64, -(-T // 2), -(-H // 2), -(-W // 2))
    assert got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert stem_close(got, want, x, w, scale)
    assert float(want.float().abs().max()) > 0.5            # not a trivial output


def test_stem_unit_routes_by_what_the_call_shows(cuda):
    """Each variant of the stem unit in bf16 with autograd off runs the
    kernel once and gives the unit's result; with autograd, in float32 and
    in training it keeps cuDNN (no launch) and its gradients."""
    from step_tpu_torch.models.i3d import Unit3D, conv3d_same

    x = _ncdhw(23, (2, 3, 6, 32, 48), torch.bfloat16)
    for folded, fused in ((True, False), (False, True), (False, False)):
        unit = Unit3D(3, 64, (7, 7, 7), (2, 2, 2), bn_folded=folded,
                      fused_bn_relu=fused).eval().to(cuda)
        with torch.no_grad():
            for p in unit.parameters():
                p.uniform_(-0.05, 0.05)
            before = LAUNCHES["stem_conv"]
            got = unit(x)
            assert LAUNCHES["stem_conv"] == before + 1
            y = conv3d_same(x.float(), unit.conv.weight.to(torch.bfloat16).float(),
                            unit.conv.bias, (2, 2, 2))
            want = (fused_scale_bias_relu_plain(y, *unit.bn.scale_bias()) if fused
                    else F.relu(y if unit.bn is None else unit.bn(y.to(torch.bfloat16))))
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL, atol=2e-3)
    before = LAUNCHES["stem_conv"]
    out = unit(x)                                         # autograd on: cuDNN
    assert out.requires_grad and LAUNCHES["stem_conv"] == before
    out.float().sum().backward()
    assert unit.conv.weight.grad is not None
    with torch.no_grad():
        unit(x.float())
        unit(x, train=True)
    assert LAUNCHES["stem_conv"] == before


def test_stem_kernel_launches_once_a_ucf_request_and_never_in_vit_or_training(cuda):
    """One launch a B=32 main-path `ucf_3step` request (bf16, BN folded),
    none in a B=32 request of the ViT cell's detector and none in a
    full-depth training step."""
    import json
    import os

    from benchmark import work
    from benchmark.program import Server
    from benchmark.reference import detector as reference
    from step_tpu_torch.data.pipeline import build_model_batch
    from step_tpu_torch.data.synthetic import SyntheticConfig, make_batch
    from step_tpu_torch.profile_request import build
    from step_tpu_torch.train.trainer import batch_to_device, create_train_state, train_step

    rgb = torch.from_numpy(np.random.RandomState(24).randint(
        0, 256, (32, 18, 224, 224, 3)).astype(np.uint8)).to(cuda)
    cfg, model = build("main", cuda)
    props, pmask = STEPDetector.initial_proposals(cfg, 32, device=cuda)
    with torch.no_grad():
        before = LAUNCHES["stem_conv"]
        out = detect_clip(model, rgb, props, pmask)
        torch.cuda.synchronize()
    assert LAUNCHES["stem_conv"] == before + 1 and torch.isfinite(out["tubes"]).all()
    del model, out
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmark")
    with open(os.path.join(root, "configs", "ava_videomae_b16.json")) as f:
        fields = json.load(f)["config"]
    server = Server(fields, work.make_weights(reference.config(fields), 5, cuda), cuda)
    props, pmask = server.proposals(32)
    before = LAUNCHES["stem_conv"]
    server.detect(rgb, props, pmask)
    torch.cuda.synchronize()
    assert LAUNCHES["stem_conv"] == before
    del server
    tcfg = PRESETS["ucf_3step"].replace(image_size=96, batch_size=1, dropout_rate=0.0,
                                        warmup_steps=2, max_gt_tubes=2)
    syn = SyntheticConfig(image_size=96, num_frames=tcfg.total_frames,
                          num_classes=tcfg.num_classes, max_boxes=2)
    state = create_train_state(tcfg, seed=3, device=cuda)
    batch = batch_to_device(build_model_batch(make_batch(4, 1, syn), tcfg, train=True), cuda)
    before = LAUNCHES["stem_conv"]
    _, metrics = train_step(state, batch, tcfg)
    assert LAUNCHES["stem_conv"] == before and torch.isfinite(metrics["loss"])


# ---- the heads' served Inception block (ops/inception.py) -----------------
# The operator against a float32 model of its own arithmetic (each conv's
# sum, bias and ReLU in float32, rounded once; b1 and b2 read b012's
# rounded output): one bf16 step of the output, 2^-15, and one bf16 step of
# each term |y| * |w| that a b1/b2 output adds up, where b012's own rounding
# of a y may fall the other way (its float32 sum taken in another order).
# The served shapes: Mixed_5b and 5c of a B=32 I3D request's heads (512
# tubes, T' = 5), the ViT cell's Mixed_5b (C = 768, T' = 9), the
# classifier's tail after MaxPool_5a, a B=1 request's chunk-stem heads
# (T' = 6), live B=1 (16 tubes) and a ragged N.
INCEPTION_SHAPES = {"5b_b32": (512, 832, 5, "Mixed_5b"), "5c_b32": (512, 832, 5, "Mixed_5c"),
                    "vit_b32": (512, 768, 9, "Mixed_5b"),
                    "classifier": (1, 832, 8, "Mixed_5b"),
                    "chunk_stem": (16, 832, 6, "Mixed_5b"), "live": (16, 832, 5, "Mixed_5c"),
                    "ragged": (3, 832, 7, "Mixed_5c")}


def _served_block(cin, name, seed, device):
    from step_tpu_torch.models.i3d import INCEPTION_CHANNELS, InceptionBlock

    torch.manual_seed(seed)
    block = InceptionBlock(cin, INCEPTION_CHANNELS[name], bn_folded=True,
                           fused_inception=True).eval()
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0, 1.0 / max(p[0].numel(), 1) ** 0.5)
    return block.to(device, torch.bfloat16).requires_grad_(False)


def _block_model(block, x):
    """The operator's arithmetic in float32 from bf16 x and weights: each
    unit's sum, bias and ReLU, rounded once; and the terms |y| * |w| of
    the b1 and b2 outputs, zero elsewhere."""
    c0, c1, c2, c3, c4, c5 = block.channels
    f = lambda t: t.float()  # noqa: E731
    unit = lambda t, u: torch.relu(F.conv3d(t, f(u.conv.weight), f(u.conv.bias), 1,  # noqa: E731
                                            u.conv.weight.shape[2] // 2))
    xf = f(x)
    y = unit(xf, block.b012).to(torch.bfloat16).float()
    b1, b2 = y[:, c0: c0 + c1], y[:, c0 + c1:]
    out = torch.cat([y[:, :c0], unit(b1, block.b1b), unit(b2, block.b2b),
                     unit(F.max_pool3d(xf, 3, 1, 1), block.b3b)], dim=1)
    terms = torch.zeros_like(out)
    terms[:, c0: c0 + c2] = F.conv3d(b1.abs(), f(block.b1b.conv.weight).abs(), None, 1, 1)
    terms[:, c0 + c2: c0 + c2 + c4] = F.conv3d(b2.abs(), f(block.b2b.conv.weight).abs(),
                                               None, 1, 1)
    return out, terms


def block_close(got, want, terms) -> bool:
    err = (got.float() - want).abs()
    return bool((err <= BF16_RTOL * (want.abs() + terms) + 2.0 ** -15).all())


@pytest.mark.parametrize("label", list(INCEPTION_SHAPES))
def test_inception_block_kernels_match_their_arithmetic_at_served_shapes(cuda, label):
    N, cin, T, name = INCEPTION_SHAPES[label]
    block = _served_block(cin, name, 31, cuda)
    x = torch.relu(_ncdhw(32, (N, cin, T, 7, 7), torch.bfloat16))
    before = (LAUNCHES["inception_block"], LAUNCHES["max_pool3x3_same"])
    with torch.no_grad():
        got = block.forward_kernel(x)
        today = block(x)
    assert (LAUNCHES["inception_block"], LAUNCHES["max_pool3x3_same"]) == (
        before[0] + 1, before[1] + 2)                # the operator's pool and today's
    want, terms = _block_model(block, x)
    torch.cuda.synchronize()
    assert got.shape == today.shape and got.dtype == torch.bfloat16
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert block_close(got, want, terms)
    assert float(want.abs().max()) > 0.5


@pytest.mark.parametrize("kernel", ["gemm", "k3", "tube"])
def test_conv_kernels_read_a_channel_slice_and_write_two_places(cuda, kernel):
    """On the same bf16 inputs, against F.conv3d in float32 rounded once:
    the GEMM's split epilogue (columns below the split into a slice of a
    wider output, the rest into a dense scratch); K3's gather at 27 taps on
    the last 48 of 240 channels, read in place, with an affine and the same
    split; the tube conv on that slice into one slice of the output."""
    from step_tpu_torch import kernels
    from step_tpu_torch.ops.conv3d import pack_conv_weight, pack_tube_weight

    rng = np.random.RandomState(33 + len(kernel))
    wide = torch.relu(_ncdhw(34, (16, 240, 6, 7, 7), torch.bfloat16))
    taps = 1 if kernel == "gemm" else 27
    x = wide if kernel == "gemm" else wide[:, 192:]
    C = x.shape[1]
    K = 624 if kernel == "gemm" else 128
    w = torch.from_numpy((rng.randn(K, C, *(3,) * 3 if taps == 27 else (1, 1, 1))
                          / np.sqrt(taps * C)).astype(np.float32)).to(cuda, torch.bfloat16)
    scale = (torch.from_numpy((rng.rand(K) + 0.5).astype(np.float32)).cuda()
             if kernel == "k3" else None)
    bias = torch.from_numpy((rng.randn(K) * 0.1).astype(np.float32)).cuda()
    big = torch.full((16, 6, 7, 7, 1024), 3.0, device=cuda, dtype=torch.bfloat16)
    xr = x.permute(0, 2, 3, 4, 1)
    split = 384 if kernel == "gemm" else 64
    scratch = torch.empty((16, 6, 7, 7, K - split), device=cuda, dtype=torch.bfloat16)
    if kernel == "tube":
        kernels.tube_conv_forward(xr, pack_tube_weight(w, torch.bfloat16), bias,
                                  big[..., 384:512])
        got = big[..., 384:512]
        untouched = torch.cat([big[..., :384], big[..., 512:]], dim=-1)
    else:
        kernels.igemm_forward(xr, pack_conv_weight(w, torch.bfloat16), scale, bias,
                              (big[..., 384: 384 + split], scratch), taps)
        got = torch.cat([big[..., 384: 384 + split], scratch], dim=-1)
        untouched = torch.cat([big[..., :384], big[..., 384 + split:]], dim=-1)
    y = F.conv3d(x.float(), w.float(), None, 1, w.shape[2] // 2)
    if scale is not None:
        y = y * scale.view(1, -1, 1, 1, 1)
    want = torch.relu(y + bias.view(1, -1, 1, 1, 1))
    torch.cuda.synchronize()
    _close(got.permute(0, 4, 1, 2, 3), want.to(torch.bfloat16), torch.bfloat16, None)
    assert bool((untouched == 3.0).all())


# A B=32 request of each cell's configuration: six blocks on the operator
# (two a head, three heads) and three head reductions on the GEMM; the pools
# on K5 as before (13 I3D, 6 ViT), no K3 or K4.
CELL_LAUNCHES = {"ucf_3step": {"inception_block": 6, "conv1x1x1_bias_relu": 3,
                               "max_pool3x3_same": 13, "conv3x3x3_bn_relu": 0,
                               "scale_bias_relu": 0},
                 "ava_3step": {"inception_block": 6, "conv1x1x1_bias_relu": 3,
                               "max_pool3x3_same": 13, "conv3x3x3_bn_relu": 0,
                               "scale_bias_relu": 0},
                 "ava_videomae_b16": {"inception_block": 6, "conv1x1x1_bias_relu": 3,
                                      "max_pool3x3_same": 6, "conv3x3x3_bn_relu": 0,
                                      "scale_bias_relu": 0}}


@pytest.mark.parametrize("config", list(CELL_LAUNCHES))
def test_a_cells_b32_request_runs_six_blocks_on_the_operator(cuda, config):
    import json
    import os

    from benchmark import work
    from benchmark.program import Server
    from benchmark.reference import detector as reference

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmark")
    with open(os.path.join(root, "configs", f"{config}.json")) as f:
        fields = json.load(f)["config"]
    server = Server(fields, work.make_weights(reference.config(fields), 35, cuda), cuda)
    cfg = server.cfg
    props, pmask = server.proposals(32)
    rgb = torch.from_numpy(np.random.RandomState(36).randint(
        0, 256, (32, cfg.total_frames, cfg.image_size, cfg.image_size, 3))
        .astype(np.uint8)).to(cuda)
    server.detect(rgb, props, pmask)
    torch.cuda.synchronize()
    before = {k: LAUNCHES[k] for k in CELL_LAUNCHES[config]}
    out = server.detect(rgb, props, pmask)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in before} == CELL_LAUNCHES[config]
    assert bool(torch.isfinite(out["tubes"]).all())


def test_bn_affine_cache_on_the_card(cuda):
    """A fused Unit3D's BN affine is computed once on the card and made
    anew after load_state_dict; the kernels then give the new result."""
    from step_tpu_torch.models.i3d import Unit3D
    from step_tpu_torch.ops.fused_bn_relu import bn_scale_bias

    unit = Unit3D(16, 24, (1, 1, 1), fused_bn_relu=True).eval().to(cuda)
    x = _ncdhw(16, (2, 16, 3, 6, 5), torch.bfloat16)
    with torch.no_grad():
        unit(x)
        first = unit.bn.scale_bias()
        assert unit.bn.scale_bias() is first and first[0].device.type == "cuda"
        state = {k: v.clone() for k, v in unit.state_dict().items()}
        state["bn.running_var"] = torch.rand_like(state["bn.running_var"]) + 0.5
        state["bn.weight"] = torch.randn_like(state["bn.weight"])
        unit.load_state_dict(state)
        got = unit(x)
        assert unit.bn.scale_bias() is not first
        scale, bias = bn_scale_bias(state["bn.weight"], state["bn.bias"],
                                    state["bn.running_mean"], state["bn.running_var"])
        want = fused_scale_bias_relu_plain(
            F.conv3d(x, unit.conv.weight.to(x.dtype)), scale, bias)
    torch.cuda.synchronize()
    _close(got, want, torch.bfloat16, None)


def test_kernels_copy_inputs_that_are_not_channels_last(cuda):
    """The wrappers document an explicit channels_last_3d copy of an input
    in another memory order; the result is the plain version's."""
    x = _ncdhw(11, (2, 24, 3, 5, 6), torch.float32, channels_last=False)
    assert not x.is_contiguous(memory_format=torch.channels_last_3d)
    s, b = torch.rand(24, device="cuda") + 0.5, torch.randn(24, device="cuda")
    w = torch.randn(10, 24, 3, 3, 3, device="cuda") * 0.05
    assert torch.equal(max_pool3x3_same(x), max_pool3x3_same_plain(x))
    torch.testing.assert_close(fused_scale_bias_relu(x, s, b),
                               fused_scale_bias_relu_plain(x, s, b), rtol=1e-6, atol=1e-6)
    s, b = s[:10], b[:10]
    torch.testing.assert_close(conv3x3x3_bn_relu(x, w, s, b),
                               conv3x3x3_bn_relu_plain(x, w, s, b), rtol=1e-4, atol=1e-4)
    strided = x[:, ::2]                                 # neither memory order
    assert torch.equal(max_pool3x3_same(strided), max_pool3x3_same_plain(strided))


def test_kernel_path_detector_on_card_matches_cpu(cuda, monkeypatch):
    """The tiny detector with fused_bn_relu and the K5 pools, float32: the
    card (K3, K4, K5) against the CPU (their plain versions)."""
    cfg = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8,
                                       image_size=64, compute_dtype="float32",
                                       fused_bn_relu=True)
    model = init_detector_(STEPDetector(cfg).eval(), seed=3)
    props, pmask = STEPDetector.initial_proposals(cfg, 2, device="cpu")
    rgb = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (2, cfg.total_frames, 64, 64, 3)).astype(np.uint8))
    ref = detect_clip(model, rgb, props, pmask)
    counts = [LAUNCHES[n] for n in KERNEL_CONFIG_OPS]
    got = detect_clip(model.to(cuda), rgb.to(cuda), props.to(cuda), pmask.to(cuda))
    after = [LAUNCHES[n] for n in KERNEL_CONFIG_OPS]
    assert [a - b for a, b in zip(after, counts)] == [10, 21, 5]
    torch.testing.assert_close(got["tubes"].cpu(), ref["tubes"], rtol=0, atol=1e-3)
    torch.testing.assert_close(got["tube_scores"].cpu(), ref["tube_scores"],
                               rtol=0, atol=1e-4)


def _link_inputs(seed: int, L: int, P: int, T: int, C: int):
    """Tubes `[L, P, T, 4]` with duplicated proposals (exact IoU ties),
    scores `[L, P, C]` on a coarse grid (exact score ties) with padding
    slots, and the proposal mask."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 160, (L, P, 1, 2)) + np.arange(T)[:, None] * rng.randn(L, P, 1, 2)
    wh = rng.uniform(20, 60, (L, P, 1, 2))
    tubes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    tubes[:, 1] = tubes[:, 0]
    mask = np.ones((L, P), np.float32)
    mask[:, P - P // 4:] = 0.0
    scores = (rng.randint(0, 9, (L, P, C)) / 8.0).astype(np.float32) * mask[..., None]
    return (torch.from_numpy(a) for a in (tubes, scores, mask))


@pytest.mark.parametrize("stride", [None, 6])
def test_linking_on_card_equals_cpu(cuda, stride):
    """The streaming preset's linking (K=4, suppression 0.5) on the card
    against the same call on the CPU: the same paths and trims."""
    tubes, scores, mask = _link_inputs(5, 12, 16, 18, 24)
    clip_mask = torch.ones(12)
    clip_mask[-3:] = 0.0
    args = (1.0, 4, 0.05)
    kw = dict(stride=stride, suppress_iou=0.5)
    ref = link_tubes_multiclass_k(tubes, scores, mask, *args, clip_mask, **kw)
    got = link_tubes_multiclass_k(tubes.to(cuda), scores.to(cuda), mask.to(cuda),
                                  *args, clip_mask.to(cuda), **kw)
    assert got["paths"].device == tubes.to(cuda).device
    for key in ("paths", "trim"):
        assert torch.equal(got[key].cpu(), ref[key]), key
    for key in ("values", "tube_scores"):
        torch.testing.assert_close(got[key].cpu(), ref[key], rtol=0, atol=1e-5)


def _stream_setup(cuda, **fields):
    cfg = PRESETS["streaming"].replace(backbone_depth="tiny", feature_stride=8,
                                       image_size=64, compute_dtype="float32",
                                       chunk_stem=True, **fields)
    model = init_detector_(STEPDetector(cfg).eval(), seed=6).to(cuda)
    frames = torch.from_numpy(np.random.RandomState(7).randint(
        0, 256, (5 * cfg.frames_per_chunk, 64, 64, 3)).astype(np.uint8)).to(cuda)
    return cfg, model, frames


def test_stream_matches_detect_clip_on_card(cuda):
    """float32 with TF32 off: both streaming forms against `detect_clip` on
    the assembled window, at an interior window and both clamped edges."""
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg, model, frames = _stream_setup(cuda)
    c = cfg.frames_per_chunk
    stream = detect_video_stream(model, frames)
    batched = detect_video_stream_batched(model, frames, clip_batch=2)
    props, pmask = STEPDetector.initial_proposals(cfg, 1, device=cuda)
    for center, ids in ((2, [1, 2, 3]), (0, [0, 0, 1]), (4, [3, 4, 4])):
        clip = torch.cat([frames[i * c:(i + 1) * c] for i in ids])[None]
        ref = detect_clip(model, clip, props, pmask)
        for got in (stream[center], {k: v[center:center + 1] for k, v in batched.items()}):
            torch.testing.assert_close(got["tubes"], ref["tubes"], rtol=0, atol=1e-3)
            torch.testing.assert_close(got["tube_scores"], ref["tube_scores"],
                                       rtol=0, atol=1e-4)


def test_chunk_stem_kernel_path_on_card_matches_cpu(cuda, monkeypatch):
    """The kernel configuration with chunk stems: K3 and K5 at T = 3 and
    2 (a 3-tap temporal window over 2 frames), on the card against the CPU."""
    cfg, model, frames = _stream_setup(cuda, fused_bn_relu=True)
    clips = frames[:cfg.total_frames].reshape(1, cfg.total_frames, 64, 64, 3)
    props, pmask = STEPDetector.initial_proposals(cfg, 1, device=cuda)
    before = [LAUNCHES[n] for n in KERNEL_CONFIG_OPS]
    got = detect_clip(model, clips, props, pmask)
    assert all(LAUNCHES[k] > n for k, n in zip(KERNEL_CONFIG_OPS, before))
    ref = detect_clip(model.cpu(), clips.cpu(), props.cpu(), pmask.cpu())
    torch.testing.assert_close(got["tubes"].cpu(), ref["tubes"], rtol=0, atol=1e-3)
    torch.testing.assert_close(got["tube_scores"].cpu(), ref["tube_scores"],
                               rtol=0, atol=1e-4)


# ---- training: K2 and K5 under autograd ----------------------------------

@pytest.mark.parametrize("window,stride", [((3, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 2, 2)),
                                           ((3, 3, 3), (2, 2, 2))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_backward_on_card_equals_cpu_on_ties(cuda, window, stride, dtype):
    """Integer-valued inputs, so windows tie: the stride-1 pool's Function
    (K5 forward, shift-and-compare backward) and the strided pools
    (PyTorch's backward) give the CPU's bits, forward and backward."""
    from step_tpu_torch.models.i3d import max_pool_3d

    gen = torch.Generator().manual_seed(5)
    x = torch.randint(0, 3, (2, 40, 5, 9, 11), generator=gen).to(dtype)
    g = torch.randint(-3, 4, max_pool_3d(x, window, stride).shape, generator=gen).to(dtype)
    out = []
    for dev in (cuda, "cpu"):
        xd = x.to(dev).contiguous(memory_format=torch.channels_last_3d).requires_grad_()
        y = max_pool_3d(xd, window, stride)
        assert y.grad_fn is not None
        y.backward(g.to(dev))
        out.append((y.detach().cpu(), xd.grad.cpu()))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_roi_align_under_autograd_on_card_matches_plain(cuda):
    """K2's Function against autograd through the plain version on the
    card: the output within 1e-4, dfeatures and dtubes equal (the same
    plain backward)."""
    rng = np.random.RandomState(6)
    feat = torch.from_numpy(rng.randn(2, 3, 9, 9, 24).astype(np.float32)).to(cuda)
    tubes = torch.from_numpy(rng.uniform(-10, 140, (2, 5, 6, 4)).astype(np.float32))
    # corners sorted: [x1, y1] <= [x2, y2]
    tubes = torch.sort(tubes.view(2, 5, 6, 2, 2), dim=-2).values.reshape(2, 5, 6, 4)
    tubes = tubes.to(cuda)
    g = torch.from_numpy(rng.randn(2, 5, 3, 7, 7, 24).astype(np.float32)).to(cuda)
    grads = []
    for fn in (tube_roi_align, tube_roi_align_plain):
        f, t = feat.clone().requires_grad_(), tubes.clone().requires_grad_()
        out = fn(f, t, 7, 1 / 16, 2)
        out.backward(g)
        grads.append((out.detach(), f.grad, t.grad))
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=1e-4, atol=1e-4)
    for a, b in zip(grads[0][1:], grads[1][1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_tiny_train_step_on_card_matches_cpu(cuda):
    """Two float32 AdamW steps of the tiny detector (dropout 0) on the card
    against the CPU: losses within 1e-5, BatchNorm statistics within 1e-4,
    weights within 2 lr and at most 0.1% of them beyond 1e-5."""
    from step_tpu_torch.data.pipeline import build_model_batch
    from step_tpu_torch.data.synthetic import SyntheticConfig, make_batch
    from step_tpu_torch.train.trainer import (batch_to_device, create_train_state,
                                              make_schedule, train_step)

    cfg = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8,
                                       image_size=64, compute_dtype="float32",
                                       batch_size=2, dropout_rate=0.0, warmup_steps=2,
                                       max_gt_tubes=2)
    syn = SyntheticConfig(image_size=64, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=2)
    batch = build_model_batch(make_batch(3, 2, syn), cfg, train=True)
    runs = []
    for dev in (cuda, "cpu"):
        state = create_train_state(cfg, seed=2, device=dev)
        b = batch_to_device(batch, dev)
        losses = [float(train_step(state, b, cfg)[1]["loss"]) for _ in range(2)]
        runs.append((losses, {k: v.cpu() for k, v in state.model.state_dict().items()}))
    (l_gpu, sd_gpu), (l_cpu, sd_cpu) = runs
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    lr = make_schedule(cfg)(1)
    far = total = 0
    for k, v in sd_cpu.items():
        d = (sd_gpu[k] - v).abs()
        if "running_" in k:
            assert float(d.max()) <= 1e-4, k
            continue
        assert float(d.max()) <= 2 * lr * (1 + 1e-3), k
        far += int((d > 1e-5).sum())
        total += d.numel()
    assert far <= 1e-3 * total


# ---- the two-stream and AVA paths -----------------------------------------

@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_nms_surface_kernel_equals_plain_at_60_classes(cuda, B, dtype):
    """K1 on the `ava_3step` surface: 60 sigmoid scores a box, no
    background column, the frame's 60 problems split across warps."""
    cfg = PRESETS["ava_3step"]
    tubes, scores, mask = (t.to(cuda) for t in surface_inputs(60 + B, B, 16, 18, 60, dtype))
    got = nms_surface(tubes, scores, mask, cfg)
    want = nms_surface_plain(tubes, scores, mask, cfg)
    torch.cuda.synchronize()
    assert got["frame_mask"].shape == (B, 18, 60, 16)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        assert torch.equal(raw_bits(got[key]), raw_bits(want[key])), key
    assert float(want["frame_mask"].sum()) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_relu_kernel_at_the_fusion_shape(cuda, dtype):
    """K4 on the two-stream fusion unit's output, `[B, 832, T', 14, 14]`."""
    C = 832
    x = _ncdhw(9, (2, C, 5, 14, 14), dtype)
    rng = np.random.RandomState(10)
    scale = torch.from_numpy((rng.rand(C) * 2 + 0.1).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.randn(C).astype(np.float32)).cuda()
    before = LAUNCHES["scale_bias_relu"]
    got = fused_scale_bias_relu(x, scale, bias)
    assert LAUNCHES["scale_bias_relu"] == before + 1
    _close(got, fused_scale_bias_relu_plain(x, scale, bias), dtype, 1e-6)


@pytest.mark.parametrize("name,over", [("two_stream_train", {}), ("ava_3step", {}),
                                       ("two_stream_train", {"fused_bn_relu": True})])
def test_tiny_two_stream_and_ava_detectors_on_card_match_cpu(cuda, name, over):
    """The tiny float32 two-stream detector (with the fusion unit's K4 in
    the kernel configuration) and the AVA detector on the card against the
    CPU, and late fusion of the two streams."""
    from step_tpu_torch.inference import detect_clip_late_fusion

    cfg = PRESETS[name].replace(backbone_depth="tiny", feature_stride=8, image_size=64,
                                compute_dtype="float32", score_thresh=0.0, **over)
    model = init_detector_(STEPDetector(cfg).eval(), seed=5)
    props, pmask = STEPDetector.initial_proposals(cfg, 2, device="cpu")
    rng = np.random.RandomState(6)
    rgb = torch.from_numpy(rng.randint(0, 256, (2, 18, 64, 64, 3)).astype(np.uint8))
    flow = torch.from_numpy(rng.randint(-127, 128, (2, 18, 64, 64, 2)).astype(np.int8))
    second = flow if cfg.two_stream else None
    ref = detect_clip(model, rgb, props, pmask, second)
    k4 = LAUNCHES["scale_bias_relu"]
    got = detect_clip(model.to(cuda), rgb.to(cuda), props.to(cuda), pmask.to(cuda),
                      None if second is None else second.to(cuda))
    assert (LAUNCHES["scale_bias_relu"] > k4) == cfg.fused_bn_relu
    torch.testing.assert_close(got["tubes"].cpu(), ref["tubes"], rtol=0, atol=1e-3)
    torch.testing.assert_close(got["tube_scores"].cpu(), ref["tube_scores"],
                               rtol=0, atol=1e-4)
    surface = nms_surface(ref["tubes"].to(cuda), ref["tube_scores"].to(cuda),
                          pmask.to(cuda), cfg)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        assert torch.equal(surface[key].cpu(), ref[key]), key
    if name == "two_stream_train" and not over:
        single = cfg.replace(two_stream=False)
        m_rgb = init_detector_(STEPDetector(single).eval(), seed=7)
        m_flow = init_detector_(STEPDetector(single.replace(input_stream="flow")).eval(), 8)
        ref = detect_clip_late_fusion(m_rgb, m_flow, rgb, flow, props, pmask)
        got = detect_clip_late_fusion(m_rgb.to(cuda), m_flow.to(cuda), rgb.to(cuda),
                                      flow.to(cuda), props.to(cuda), pmask.to(cuda))
        torch.testing.assert_close(got["tube_scores"].cpu(), ref["tube_scores"],
                                   rtol=0, atol=1e-4)


def test_vit_detector_at_b32_meets_the_cells_limits_against_the_reference(cuda):
    """The benchmark's `ava_videomae_b16` detector at published widths
    (VideoMAE ViT-B/16, `models/vit.py`), built and served as the benchmark
    serves it (`benchmark/program.py::Server`: BN-folded heads, the tree in
    bfloat16, K1, K2 and the K5 tail pools at T' = 9, C = 768/832) on a
    B=32 request of 224 px clips; its first 2 clips judged by the float32
    reference (`benchmark/check.py`) under the cell's limits."""
    import json
    import os

    from benchmark import check, work
    from benchmark.program import Server
    from benchmark.reference import detector as reference

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmark")
    with open(os.path.join(root, "configs", "ava_videomae_b16.json")) as f:
        fields = json.load(f)["config"]
    with open(os.path.join(root, "workloads", "ava_videomae_b16.offline_b32.json")) as f:
        limits = json.load(f)["limits"]
    rc = reference.config(fields)
    weights = work.make_weights(rc, 2 ** 31 + 3, cuda)
    server = Server(fields, weights, cuda)
    props, pmask = server.proposals(32)
    rgb = torch.from_numpy(np.random.RandomState(8).randint(
        0, 256, (32, 18, 224, 224, 3)).astype(np.uint8)).to(cuda)
    out = server.detect(rgb, props, pmask)
    assert out["tube_scores"].shape == (32, 16, 60) and torch.isfinite(out["tubes"]).all()
    served = {k: v[:2].cpu() for k, v in out.items()}
    del server, out
    readings, _ = check.serve_readings(weights, rc, [(rgb[:2].cpu(), props[:2].cpu(),
                                                      pmask[:2].cpu(), served)], cuda)
    ok, checks = check.verdict(readings, limits)
    assert ok, checks


@pytest.mark.parametrize("heads,q_size,kv_size", [(1, (9, 56, 56), (9, 7, 7)),
                                                   (2, (9, 28, 28), (9, 14, 14)),
                                                   (4, (9, 14, 14), (9, 7, 7))])
def test_mvit_packed_attention_is_one_fused_kernel_and_the_biased_attention(
        cuda, heads, q_size, kv_size):
    """MViTv2-B's packed attention at B=32 in bfloat16, at stage 1, the
    first transition and stage 3: one fused attention kernel (cuDNN's or
    flash), no softmax of the math path, and within bfloat16's rounding of
    the masked attention on Rel(q) in float32."""
    import math

    from step_tpu_torch.models import mvit

    g = torch.Generator(device=cuda).manual_seed(61)
    d = 96
    q, k, v = (torch.nn.functional.layer_norm(
        torch.randn((32, heads, math.prod(s), d), device=cuda, generator=g), (d,))
        for s in (q_size, kv_size, kv_size))
    side = 2 * max(q_size[1], kv_size[1]) - 1
    tables = [0.1 * torch.randn((n, d), device=cuda, generator=g) for n in (17, side, side)]
    index = [mvit.rel_index(a, b).to(cuda) for a, b in zip(q_size, kv_size)]
    extra = mvit.packed_width(d, kv_size) - d
    rows = [r.to(cuda) for r in mvit.term_rows(index, [len(t) for t in tables], kv_size, extra)]
    onehots = mvit.key_onehots(kv_size, extra).to(cuda)
    args = ([t.bfloat16() for t in (q, k, v)], q_size,
            [t.bfloat16() for t in tables], rows, onehots.bfloat16())
    mvit.packed_attention(*args[0], *args[1:])
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        got = mvit.packed_attention(*args[0], *args[1:])
        torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    fused = [n for n in names if "sdpa" in n or "flash" in n or "fmha" in n]
    assert len(fused) == 1 and not any("softmax" in n for n in names), names
    bias = mvit.rel_pos_bias(q, q_size, kv_size, tables, index)
    want = torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias) + q
    # outputs of order one: bfloat16's step at 4 is 2^-5
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2.0 ** -4)
    del bias


def test_mvit_detector_at_b32_meets_the_cells_limits_against_the_reference(cuda):
    """The benchmark's `ava_mvitv2_b` detector at published widths
    (MViTv2-B blocks 0-20, `models/mvit.py`), built and served as the
    benchmark serves it (`benchmark/program.py::Server`: BN-folded heads,
    the tree in bfloat16, K1, K2, K5 and `step::inception_block` on the
    C = 384 tails at T' = 9) on a B=32 request of 224 px clips; the heads'
    six tail blocks of a request run on the operator, its 21 blocks'
    attention on the packed query and keys (no bias tensor), and its first
    2 clips are judged by the float32 reference (`benchmark/check.py`)
    under the cell's limits; its 63 attention pools (3 a block) run on
    `csrc/attn_pool.cu`."""
    import json
    import os

    from benchmark import check, work
    from benchmark.program import Server
    from benchmark.reference import detector as reference

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmark")
    with open(os.path.join(root, "configs", "ava_mvitv2_b.json")) as f:
        fields = json.load(f)["config"]
    with open(os.path.join(root, "workloads", "ava_mvitv2_b.offline_b32.json")) as f:
        limits = json.load(f)["limits"]
    rc = reference.config(fields)
    weights = work.make_weights(rc, 2 ** 31 + 5, cuda)
    server = Server(fields, weights, cuda)
    props, pmask = server.proposals(32)
    rgb = torch.from_numpy(np.random.RandomState(9).randint(
        0, 256, (32, 18, 224, 224, 3)).astype(np.uint8)).to(cuda)
    server.detect(rgb, props, pmask)
    torch.cuda.synchronize()
    before = LAUNCHES["inception_block"], LAUNCHES["packed_attention"], LAUNCHES["attn_pool"]
    out = server.detect(rgb, props, pmask)
    torch.cuda.synchronize()
    assert LAUNCHES["inception_block"] - before[0] == 6
    assert LAUNCHES["packed_attention"] - before[1] == 21
    assert LAUNCHES["attn_pool"] - before[2] == 63
    assert out["tube_scores"].shape == (32, 16, 60) and torch.isfinite(out["tubes"]).all()
    served = {k: v[:2].cpu() for k, v in out.items()}
    del server, out
    readings, _ = check.serve_readings(weights, rc, [(rgb[:2].cpu(), props[:2].cpu(),
                                                      pmask[:2].cpu(), served)], cuda)
    ok, checks = check.verdict(readings, limits)
    assert ok, checks


# MViTv2-B's attention pools at full depth, 224 px, 18 frames: (input grid,
# dim_out, heads, q stride, K/V stride, blocks of a request), in block order.
MVIT_POOL_BLOCKS = [((9, 56, 56), 96, 1, (1, 1, 1), (1, 8, 8), 2),
                    ((9, 56, 56), 192, 2, (1, 2, 2), (1, 4, 4), 1),
                    ((9, 28, 28), 192, 2, (1, 1, 1), (1, 4, 4), 2),
                    ((9, 28, 28), 384, 4, (1, 2, 2), (1, 2, 2), 1),
                    ((9, 14, 14), 384, 4, (1, 1, 1), (1, 2, 2), 15)]


def mvit_pool_inputs(B, grid, dim_out, d, generator, device, dtype=torch.bfloat16):
    """qkv `[B, T·H·W, 3·dim_out]` in bfloat16 as a GEMM makes it (unit
    normal plus a per-channel offset, its bias) and a part's weights in
    `dtype`: the conv weight `[d, 1, 3, 3, 3]`, the norm's weight (not 1)
    and bias (not 0)."""
    import math

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device)

    qkv = (randn(B, math.prod(grid), 3 * dim_out) + randn(3 * dim_out)).bfloat16()
    return qkv, ((0.2 * randn(d, 1, 3, 3, 3)).to(dtype), (1 + 0.2 * randn(d)).to(dtype),
                 (0.1 * randn(d)).to(dtype))


def attn_pool_close(got, want):
    """Two roundings to bfloat16 of float32 results that differ only by the
    order of their sums: one bf16 step apart at most, with 1e-4 absolute
    where an output near 0 has steps finer than the sums' error."""
    err = (got.float() - want.float()).abs()
    return bool((err <= 2.0 ** -7 * want.float().abs() + 1e-4).all()), float(err.max())


@pytest.mark.parametrize("case", [(row, 2, torch.bfloat16) for row in range(5)]
                         + [(0, 32, torch.bfloat16), (4, 2, torch.float32)])
@pytest.mark.parametrize("part", range(3))
def test_attn_pool_kernel_is_its_plain_version_at_each_block_shape(cuda, case, part):
    """`csrc/attn_pool.cu` through `step::attn_pool` at each block shape of
    the full-depth plan, q at the block's q stride and k, v at its K/V
    stride (1, 2, 4 and 8 among them), at B=2, at stage 1's B=32, and with
    float32 weights (which the kernel rounds to bfloat16 itself): one launch,
    within one bf16 step (and 1e-4) of the plain version, whose float32 conv
    and norm run with TF32 off."""
    from step_tpu_torch.ops.attn_pool import attn_pool, attn_pool_plain

    row, B, dtype = case
    grid, dim_out, heads, q_stride, kv_stride, _ = MVIT_POOL_BLOCKS[row]
    stride = q_stride if part == 0 else kv_stride
    g = torch.Generator(device=cuda).manual_seed(71 + 3 * row + part)
    qkv, weights = mvit_pool_inputs(B, grid, dim_out, 96, g, cuda, dtype)
    before = LAUNCHES["attn_pool"]
    got = attn_pool(qkv, part, heads, grid, stride, *weights, 1e-6)
    torch.cuda.synchronize()
    assert LAUNCHES["attn_pool"] - before == 1
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = attn_pool_plain(qkv, part, heads, grid, stride, *weights, 1e-6)
    assert got.shape == want.shape and got.is_contiguous() and got.dtype == torch.bfloat16
    ok, err = attn_pool_close(got, want)
    print(f"attn_pool B={B} {grid} D={dim_out} part {'qkv'[part]} stride {stride}: "
          f"max |err| {err:.3g}")
    assert ok, err


@pytest.mark.parametrize("stride", [1, 2, 4, 8])
def test_attn_pool_kernel_on_an_odd_grid(cuda, stride):
    """A 5x13x11 grid, whose sides no stride divides, at each spatial
    stride: the tiles' ragged rows and columns, against the plain version."""
    from step_tpu_torch.ops.attn_pool import attn_pool, attn_pool_plain

    g = torch.Generator(device=cuda).manual_seed(80 + stride)
    grid, strides = (5, 13, 11), (1, stride, stride)
    qkv, weights = mvit_pool_inputs(3, grid, 192, 96, g, cuda)
    got = attn_pool(qkv, 1, 2, grid, strides, *weights, 1e-6)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        want = attn_pool_plain(qkv, 1, 2, grid, strides, *weights, 1e-6)
    ok, err = attn_pool_close(got, want)
    assert ok, err


def test_a_blocks_pools_launch_the_kernel_alone(cuda):
    """The three pools of stage 1's first block at B=2, traced: three
    launches of the kernel and no other device work (no depthwise conv, no
    LayerNorm, no copy)."""
    from step_tpu_torch.models import mvit
    from step_tpu_torch.models.nets import _linear

    attn = mvit.MultiScaleAttention(96, 96, 1, (1, 1, 1), (1, 8, 8), (9, 56, 56))
    attn = attn.to(cuda, torch.bfloat16).eval()
    g = torch.Generator(device=cuda).manual_seed(90)
    x = torch.randn((2, 9 * 56 * 56, 96), device=cuda, generator=g).bfloat16()
    with torch.no_grad():
        qkv = _linear(attn.qkv, x)
        [attn._pool(qkv, part) for part in range(3)]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            [attn._pool(qkv, part) for part in range(3)]
            torch.cuda.synchronize()
    work = [e for e in prof.key_averages() if e.device_time_total > 0]
    assert [e.key for e in work if "attn_pool_kernel" not in e.key] == [], [e.key for e in work]
    assert sum(e.count for e in work) == 3


@pytest.mark.parametrize("what,match", [
    ("float32 activations", "bfloat16 activations"),
    ("d = 16", "d = 96"),
    ("stride (1, 3, 3)", "strides"),
    ("stride (2, 1, 1)", "strides"),
    ("mixed weight dtypes", "all float32 or all bfloat16"),
    ("a view of wider rows", "in place"),
])
def test_what_the_attn_pool_kernel_refuses(cuda, what, match):
    """The wrapper on a CUDA tensor raises on what the kernel does not take,
    launching nothing."""
    from step_tpu_torch.ops.attn_pool import attn_pool

    g = torch.Generator(device=cuda).manual_seed(91)
    grid, dim_out, heads, stride = (3, 8, 8), 192, 2, (1, 1, 1)
    qkv, (w, nw, nb) = mvit_pool_inputs(1, grid, dim_out, 96, g, cuda)
    if what == "float32 activations":
        qkv = qkv.float()
    elif what == "d = 16":
        qkv, (w, nw, nb) = mvit_pool_inputs(1, grid, 32, 16, g, cuda)
    elif what.startswith("stride"):
        stride = (1, 3, 3) if "3" in what else (2, 1, 1)
    elif what == "mixed weight dtypes":
        w = w.float()
    else:
        qkv = torch.cat([qkv, qkv[..., :8]], -1)[..., :3 * dim_out]
    before = LAUNCHES["attn_pool"]
    with pytest.raises(ValueError, match=match):
        attn_pool(qkv, 0, heads, grid, stride, w, nw, nb, 1e-6)
    assert LAUNCHES["attn_pool"] == before


@pytest.mark.parametrize("stage,heads,grid", [(0, 4, (9, 56, 56)), (2, 16, (9, 14, 14))])
def test_swin_window_attention_is_one_fused_kernel_and_the_biased_attention(
        cuda, stage, heads, grid):
    """A Video Swin-B SW-MSA block's attention at B=32 in bfloat16, at stage
    1 (128 windows, 4 heads) and stage 3 (8 windows, 16 heads): the window
    major call with the `[nW·h, 1, N, N]` bias and mask is one fused
    attention kernel, no softmax of the math path, within bfloat16's
    rounding of the same attention in float32 on the CPU's math path."""
    from step_tpu_torch.models import swin

    g = torch.Generator(device=cuda).manual_seed(63 + stage)
    d, N = 32, 392
    window, shift = swin.window_size(grid)
    labels = swin.region_labels(grid, window, shift).to(cuda)
    nW = labels.shape[0]
    attn = swin.WindowAttention3D(heads * d, heads).to(cuda)
    with torch.no_grad():
        attn.relative_position_bias_table.copy_(
            torch.randn(attn.relative_position_bias_table.shape, device=cuda, generator=g))
    index = swin.relative_index().to(cuda)
    q, k, v = (torch.nn.functional.layer_norm(
        torch.randn((nW * heads, 32, N, d), device=cuda, generator=g), (d,)) for _ in range(3))
    with torch.no_grad():
        bias = attn.bias(index, labels, torch.bfloat16)
        args = [t.bfloat16() for t in (q, k, v)]
        torch.nn.functional.scaled_dot_product_attention(*args, attn_mask=bias)
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = torch.nn.functional.scaled_dot_product_attention(*args, attn_mask=bias)
            torch.cuda.synchronize()
    names = [e.key for e in prof.key_averages() if e.device_time_total > 0]
    fused = [n for n in names if "sdpa" in n or "flash" in n or "fmha" in n or "attention" in n]
    assert len(fused) == 1 and not any("softmax" in n for n in names), names
    print(f"swin stage {stage + 1} attention kernels: {names}")
    assert bias.shape == (nW * heads, 1, N, N)
    scores = (q @ k.transpose(-1, -2)) * d ** -0.5 + bias.float()
    want = scores.softmax(-1) @ v
    # outputs of order one: bfloat16's step at 1 is 2^-7, the bias rounded
    # to bfloat16 moves a logit by up to 2^-8 of it
    torch.testing.assert_close(got.float(), want, rtol=0, atol=2.0 ** -5)


def test_swin_detector_at_b32_meets_the_cells_limits_against_the_reference(cuda):
    """The benchmark's `ava_swin3d_b` detector at published widths (Video
    Swin-B stages 1-3, `models/swin.py`), built and served as the
    benchmark serves it (`benchmark/program.py::Server`: BN-folded heads,
    the tree in bfloat16, K1, K2, K5 and `step::inception_block` on the
    C = 512 tails at T' = 9) on a B=32 request of 224 px clips: the heads'
    six tail blocks of a request run on the operator, the request's peak
    memory is printed (and no `[B·nW, h, N, N]` tensor fits under its
    bound), and its first 2 clips are judged by the float32 reference
    (`benchmark/check.py`) under the cell's limits."""
    import json
    import os

    from benchmark import check, work
    from benchmark.program import Server
    from benchmark.reference import detector as reference

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmark")
    with open(os.path.join(root, "configs", "ava_swin3d_b.json")) as f:
        fields = json.load(f)["config"]
    with open(os.path.join(root, "workloads", "ava_swin3d_b.offline_b32.json")) as f:
        limits = json.load(f)["limits"]
    rc = reference.config(fields)
    weights = work.make_weights(rc, 2 ** 31 + 7, cuda)
    server = Server(fields, weights, cuda)
    props, pmask = server.proposals(32)
    rgb = torch.from_numpy(np.random.RandomState(10).randint(
        0, 256, (32, 18, 224, 224, 3)).astype(np.uint8)).to(cuda)
    server.detect(rgb, props, pmask)
    torch.cuda.synchronize()
    before = LAUNCHES["inception_block"]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = server.detect(rgb, props, pmask)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"swin B=32 request: peak {peak / 1e9:.3f} GB allocated, "
          f"{(peak - base) / 1e9:.3f} GB above the weights, bias caches and input")
    assert LAUNCHES["inception_block"] - before == 6
    # stage 1's bias broadcast over the batch would be 32 x 128 x 4 x 392^2
    # bfloat16 elements, 5.0 GB, on top of the request's own
    assert peak - base < 6e9
    assert out["tube_scores"].shape == (32, 16, 60) and torch.isfinite(out["tubes"]).all()
    served = {k: v[:2].cpu() for k, v in out.items()}
    del server, out
    readings, _ = check.serve_readings(weights, rc, [(rgb[:2].cpu(), props[:2].cpu(),
                                                      pmask[:2].cpu(), served)], cuda)
    ok, checks = check.verdict(readings, limits)
    print(f"swin B=32 checks: {checks}")
    assert ok, checks


# ---- the I3D classifier's shapes and the int8 optimizer --------------------

# `I3DClassifier` on 64 frames at 224 px (B=1): the stem at T = 32 and 16,
# the tail after MaxPool_5a at T = 8 (7x7).
CLASSIFIER_POOLS = [(1, 192, 32, 28, 28), (1, 480, 16, 14, 14), (1, 832, 8, 7, 7)]
CLASSIFIER_BN = [(1, 64, 32, 112, 112), (1, 64, 32, 56, 56), (1, 160, 16, 14, 14),
                 (1, 384, 8, 7, 7)]
CLASSIFIER_CONV = [((1, 64, 32, 56, 56), 192), ((1, 96, 32, 28, 28), 128),
                   ((1, 112, 16, 14, 14), 224), ((1, 160, 8, 7, 7), 320)]


@pytest.mark.parametrize("shape", CLASSIFIER_POOLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernel_at_the_classifier_shapes(cuda, shape, dtype):
    x = _ncdhw(21, shape, dtype)
    got, want = max_pool3x3_same(x), max_pool3x3_same_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(raw_bits(got), raw_bits(want))


@pytest.mark.parametrize("shape", CLASSIFIER_BN)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_relu_kernel_at_the_classifier_shapes(cuda, shape, dtype):
    C = shape[1]
    x = _ncdhw(22, shape, dtype)
    rng = np.random.RandomState(23)
    scale = torch.from_numpy((rng.rand(C) * 2 + 0.1).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.randn(C).astype(np.float32)).cuda()
    _close(fused_scale_bias_relu(x, scale, bias),
           fused_scale_bias_relu_plain(x, scale, bias), dtype, 1e-6)


@pytest.mark.parametrize("shape,K", CLASSIFIER_CONV)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_kernel_at_the_classifier_shapes(cuda, shape, K, dtype):
    """bf16 within one rounding step and 2^-15: over 27 * C products the
    tensor cores' float32 accumulation drifts ~1e-5 from the plain sum
    where BN and ReLU bring an output near 0 (chip_smoke.py K3_BF16_ATOL)."""
    C = shape[1]
    x = _ncdhw(24, shape, dtype)
    rng = np.random.RandomState(25)
    w = torch.from_numpy((rng.randn(K, C, 3, 3, 3) / np.sqrt(27 * C)).astype(np.float32))
    scale = torch.from_numpy((rng.rand(K) + 0.5).astype(np.float32))
    bias = torch.from_numpy((rng.randn(K) * 0.1).astype(np.float32))
    w, scale, bias = w.cuda(), scale.cuda(), bias.cuda()
    got = conv3x3x3_bn_relu(x, w, scale, bias)
    want = conv3x3x3_bn_relu_plain(x, w, scale, bias)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=BF16_RTOL,
                                   atol=2.0 ** -15)


def test_classifier_kernel_configuration_on_card_matches_cpu(cuda, monkeypatch):
    """`I3DClassifier` in float32 with `fused_bn_relu` and K5 pools on the
    card (K3, K4, K5 launched) against the main configuration on the CPU:
    logits within 1e-4 of their scale."""
    from step_tpu_torch.models.i3d import I3DClassifier

    torch.manual_seed(0)
    model = I3DClassifier(num_classes=11).eval()
    sd = init_detector_(model, seed=3).state_dict()
    x = torch.from_numpy(np.random.RandomState(26).randn(2, 16, 64, 64, 3)
                         .astype(np.float32))
    with torch.no_grad():
        want = model(x)
        kmodel = I3DClassifier(num_classes=11, fused_bn_relu=True).eval()
        kmodel.load_state_dict(sd)
        before = [LAUNCHES[n] for n in KERNEL_CONFIG_OPS]
        got = kmodel.to(cuda)(x.to(cuda)).cpu()
    after = [LAUNCHES[n] for n in KERNEL_CONFIG_OPS]
    assert all(a > b for a, b in zip(after, before))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("signed", [True, False])
def test_int8_quantize_on_card_equals_cpu(cuda, signed):
    """The same codes (CUDA's and the CPU's float32 log may differ by an ulp
    at a rounding boundary: one level, at most 0.1% of the elements), the
    same scales, and the same codes dequantized within 2e-6 relative: CUDA
    divides by a scalar as a product with its reciprocal, an ulp of exp's
    argument (|x| <= 13.8, ulp 9.5e-7), which exp turns into ~1e-6 relative."""
    from step_tpu_torch.train.optim_int8 import dequantize_blockwise, quantize_blockwise

    rng = np.random.RandomState(27)
    mag = 10.0 ** rng.uniform(-9, 1, size=256 * 4000)
    x = (mag * rng.choice([-1.0, 1.0], size=mag.size) if signed else mag).astype(np.float32)
    x[rng.rand(x.size) < 0.05] = 0.0
    blocks = torch.from_numpy(x).view(-1, 256)
    q_cpu, s_cpu = quantize_blockwise(blocks, signed)
    q_gpu, s_gpu = quantize_blockwise(blocks.to(cuda), signed)
    assert torch.equal(s_gpu.cpu(), s_cpu) and q_gpu.dtype == q_cpu.dtype
    d = (q_gpu.cpu().to(torch.int32) - q_cpu.to(torch.int32)).abs()
    assert int(d.max()) <= 1 and float((d > 0).float().mean()) <= 1e-3
    back = dequantize_blockwise(q_cpu.to(cuda), s_cpu.to(cuda)).cpu()
    torch.testing.assert_close(back, dequantize_blockwise(q_cpu, s_cpu), rtol=2e-6, atol=0)


def test_int8_optimizer_on_card_equals_cpu(cuda):
    """Three int8 AdamW updates (lr 1e-3) of the tiny detector's parameters
    on the same gradients on the card and the CPU: the codes within one
    level on at most 0.1% of the elements (the log's and the scalar
    division's ulp); the block scales within 4e-6 relative (each step
    requantizes moments whose dequantized values differ by ~1e-6, as
    `test_int8_quantize_on_card_equals_cpu` says); where a code differs
    the next step differs by up to a level (~8% of lr), so the weights are
    within 0.3 lr after three steps and all but 0.3% within 1e-6."""
    from step_tpu_torch.train.trainer import Optimizer

    cfg = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8,
                                       adam_moments="int8", warmup_steps=0)
    named = list(init_detector_(STEPDetector(cfg), seed=4).named_parameters())
    names, params = [n for n, _ in named], [p.detach().clone() for _, p in named]
    rng = np.random.RandomState(28)
    grads = [[torch.from_numpy((rng.randn(*p.shape) * 10.0 ** rng.uniform(-5, -1))
                               .astype(np.float32)) for p in params] for _ in range(3)]
    runs = []
    for dev in (cuda, "cpu"):
        ps = [p.to(dev) for p in params]
        opt = Optimizer(cfg)
        state = opt.init(ps, names)
        for g in grads:
            opt.update(ps, [t.to(dev) for t in g], state)
        runs.append(([p.cpu() for p in ps], {k: state[k].cpu() for k in
                                             ("mu", "nu", "mu_scale", "nu_scale")}))
    (p_gpu, s_gpu), (p_cpu, s_cpu) = runs
    d = torch.cat([(a - b).abs().reshape(-1) for a, b in zip(p_gpu, p_cpu)])
    codes = {k: (s_gpu[k].to(torch.int32) - s_cpu[k].to(torch.int32)).abs()
             for k in ("mu", "nu")}
    scales = {k: float(((s_gpu[k] - s_cpu[k]).abs() / s_cpu[k].clamp(min=1e-30)).max())
              for k in ("mu_scale", "nu_scale")}
    stats = dict(w_max=float(d.max()), w_far=float((d > 1e-6).float().mean()), scales=scales,
                 codes={k: (int(c.max()), float((c > 0).float().mean()))
                        for k, c in codes.items()})
    lr = 1e-3
    assert stats["w_max"] <= 0.3 * lr and stats["w_far"] <= 3e-3, stats
    assert max(scales.values()) <= 4e-6, stats
    for c in codes.values():
        assert int(c.max()) <= 1 and float((c > 0).float().mean()) <= 1e-3, stats


def test_int8_blocking_on_card_equals_cpu(cuda):
    """The JAX package's blocking of the tiny detector's parameters (conv
    kernels DHWIO, Dense weights [in, out], the heads stacked by step),
    built on the card: the same leaves and gather index as on the CPU, and
    one update's gather into the blocks and scatter back puts each
    gradient's step where it belongs: Adam's step at t = 1 from zero
    moments is g / (|g| + eps) within the bias corrections' float32
    rounding (1e-4), and the card's within 2e-6 of the CPU's (CUDA divides
    by a scalar through its reciprocal)."""
    from step_tpu_torch.train import optim_int8

    cfg = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8)
    named = list(STEPDetector(cfg).named_parameters())
    names, params = [n for n, _ in named], [p.detach() for _, p in named]
    index, leaves = optim_int8.blocking([p.to(cuda) for p in params], names)
    want_index, want_leaves = optim_int8.blocking(params, names)
    assert leaves == want_leaves and any(leaf.startswith("steps.*.") for leaf, *_ in leaves)
    assert index.dtype == torch.int32 and torch.equal(index.cpu(), want_index)
    rng = np.random.RandomState(29)
    grads = [torch.from_numpy(rng.randn(*p.shape).astype(np.float32)) for p in params]
    steps = []
    for dev in (cuda, "cpu"):
        index, leaves = optim_int8.blocking([p.to(dev) for p in params], names)
        state = optim_int8.init_state(leaves, dev)
        steps.append([s.cpu() for s in optim_int8.adam_step(
            [g.to(dev) for g in grads], state, index, 1, 0.9, 0.999, 1e-8)])
    for a, b, g in zip(*steps, grads):
        assert a.shape == g.shape
        torch.testing.assert_close(a, b, rtol=2e-6, atol=0)
        torch.testing.assert_close(a, g / (g.abs() + 1e-8), rtol=0, atol=1e-4)


def int8_moments_close(q_a, s_a, q_b, s_b) -> bool:
    """Two int8 states' moments within one code level (8% relative: the
    levels are 7.6% apart for mu and 5.6% for nu) or within 1% of their
    block's largest value, where a gradient at the level of float noise
    differs between two devices."""
    from step_tpu_torch.train.optim_int8 import dequantize_blockwise

    a, b = dequantize_blockwise(q_a, s_a), dequantize_blockwise(q_b, s_b)
    absmax = torch.maximum(s_a, s_b)[:, None]
    return bool(((a - b).abs() <= 0.08 * b.abs() + 0.01 * absmax).all())


def test_int8_train_step_on_card_matches_cpu(cuda):
    """One float32 step of the tiny detector with int8 moments (warmup 0, so
    the step moves the weights) on the card against the CPU: the loss
    within 1e-5, the weights as the float32 AdamW test above holds them
    (within 2 lr, at most 0.1% beyond 1e-5: the first step's update comes
    from the float32 moments), and the stored moments within one level or
    1% of their block's largest value (`int8_moments_close`)."""
    from step_tpu_torch.data.pipeline import build_model_batch
    from step_tpu_torch.data.synthetic import SyntheticConfig, make_batch
    from step_tpu_torch.train.trainer import (batch_to_device, create_train_state,
                                              make_schedule, train_step)

    cfg = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8,
                                       image_size=64, compute_dtype="float32",
                                       batch_size=2, dropout_rate=0.0, warmup_steps=0,
                                       max_gt_tubes=2, adam_moments="int8")
    syn = SyntheticConfig(image_size=64, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=2)
    batch = build_model_batch(make_batch(3, 2, syn), cfg, train=True)
    runs = []
    for dev in (cuda, "cpu"):
        state = create_train_state(cfg, seed=2, device=dev)
        loss = float(train_step(state, batch_to_device(batch, dev), cfg)[1]["loss"])
        runs.append((loss, {k: v.detach().cpu().clone()
                            for k, v in state.model.state_dict().items()},
                     {k: v.cpu() for k, v in state.opt_state.items() if torch.is_tensor(v)}))
    (l_gpu, sd_gpu, m_gpu), (l_cpu, sd_cpu, m_cpu) = runs
    np.testing.assert_allclose(l_gpu, l_cpu, rtol=1e-5)
    lr = make_schedule(cfg)(0)
    far = total = 0
    for k, v in sd_cpu.items():
        if "running_" in k:
            continue
        d = (sd_gpu[k] - v).abs()
        assert float(d.max()) <= 2 * lr * (1 + 1e-3), k
        far += int((d > 1e-5).sum())
        total += d.numel()
    assert far <= 1e-3 * total
    for k in ("mu", "nu"):
        assert int8_moments_close(m_gpu[k], m_gpu[k + "_scale"], m_cpu[k],
                                  m_cpu[k + "_scale"]), k


# ---- data parallelism on one rank (NCCL) -----------------------------------

@pytest.fixture(scope="module")
def nccl_mesh():
    """A one-rank process group (NCCL for CUDA tensors, gloo for host ones)
    and its "data" mesh, torn down after the module's tests."""
    import socket

    import torch.distributed as dist

    from step_tpu_torch.parallel import create_mesh, init_distributed

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    init_distributed(f"127.0.0.1:{port}", 1, 0)
    yield create_mesh()
    dist.destroy_process_group()


def test_one_rank_parallel_train_step_on_card_matches_train_step(nccl_mesh):
    """Two float32 AdamW steps of the tiny detector (dropout 0.3, remat
    "dots") through `make_parallel_train_step` on a one-rank NCCL mesh
    against `train_step` on the card: BatchNorm's sums over the group
    against its means, so losses within 1e-5, BatchNorm statistics within
    1e-5, weights within 2 lr and at most 0.1% of them beyond 1e-5."""
    from step_tpu_torch.data.pipeline import build_model_batch
    from step_tpu_torch.data.synthetic import SyntheticConfig, make_batch
    from step_tpu_torch.train.trainer import (batch_to_device, create_train_state,
                                              make_parallel_train_step, make_schedule,
                                              train_step)

    cfg = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8,
                                       image_size=64, compute_dtype="float32",
                                       batch_size=2, dropout_rate=0.3, warmup_steps=2,
                                       max_gt_tubes=2)
    syn = SyntheticConfig(image_size=64, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=2)
    batch = batch_to_device(build_model_batch(make_batch(3, 2, syn), cfg, train=True),
                            "cuda")
    runs = []
    for parallel in (True, False):
        state = create_train_state(cfg, seed=2, device="cuda")
        step = (make_parallel_train_step(cfg, state.model, nccl_mesh) if parallel
                else lambda s, b: train_step(s, b, cfg))
        losses = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
        runs.append((losses, {k: v.cpu() for k, v in state.model.state_dict().items()}))
    (l_par, sd_par), (l_one, sd_one) = runs
    np.testing.assert_allclose(l_par, l_one, rtol=1e-5)
    lr = make_schedule(cfg)(1)
    far = total = 0
    for k, v in sd_one.items():
        d = (sd_par[k] - v).abs()
        if "running_" in k:
            assert float(d.max()) <= 1e-5, k
            continue
        assert float(d.max()) <= 2 * lr * (1 + 1e-3), k
        far += int((d > 1e-5).sum())
        total += d.numel()
    assert far <= 1e-3 * total


def test_one_rank_sharded_collect_detections_on_card_equals_unsharded(nccl_mesh):
    """`collect_detections` over the one-rank mesh (a batch of 8 and one of
    7) is the unsharded collection: on one rank the shard is the batch."""
    from step_tpu_torch.config import StepConfig
    from step_tpu_torch.data.memory import MemoryUCF
    from step_tpu_torch.evaluate import collect_detections

    cfg = StepConfig(dataset="ucf101_24", num_classes=3, frames_per_chunk=2, num_chunks=3,
                     num_steps=2, iou_thresholds=(0.4, 0.5), step_loss_weights=(1.0, 1.0),
                     image_size=32, backbone_depth="tiny", feature_stride=8,
                     pooled_size=4, max_proposals=12, max_detections=4,
                     compute_dtype="float32", max_gt_tubes=2, score_thresh=0.0)
    model = init_detector_(STEPDetector(cfg), 3).eval().to("cuda")
    data = MemoryUCF(cfg, 3, 10, (48, 64), 7)
    want = collect_detections(model, data)
    got = collect_detections(model, data, mesh=nccl_mesh)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:3] == w[:3]
        np.testing.assert_array_equal(g[3], w[3])
