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
"""

import numpy as np
import pytest
import torch

from step_tpu_torch.config import PRESETS
from step_tpu_torch.inference import detect_clip, nms_surface
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.ops.conv3d import conv3x3x3_bn_relu, conv3x3x3_bn_relu_plain
from step_tpu_torch.ops.fused_bn_relu import (fused_scale_bias_relu,
                                              fused_scale_bias_relu_plain)
from step_tpu_torch.ops.nms import nms_many, nms_many_plain, premask_scores
from step_tpu_torch.ops.pool import max_pool3x3_same, max_pool3x3_same_plain
from step_tpu_torch.ops.roi_align import tube_roi_align, tube_roi_align_plain
from step_tpu_torch.utils.init import init_detector_

pytestmark = pytest.mark.gpu
BF16_RTOL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _nms_inputs(seed, N, P):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 100, (N, P, 2))
    wh = rng.uniform(0, 40, (N, P, 2))
    wh[rng.rand(N, P) < 0.15] = 0.0
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = (rng.randint(0, 5, (N, P)) / 4.0).astype(np.float32)
    valid = (rng.rand(N, P) > 0.2).astype(np.float32)
    valid[::5] = 0.0
    return (torch.from_numpy(a) for a in (boxes, scores, valid))


@pytest.mark.parametrize("N,P,K,thr", [(3456, 16, 16, 0.5), (100, 32, 40, 0.3),
                                       (7, 1, 4, 0.5), (513, 11, 5, 0.7)])
def test_nms_kernel_equals_plain(cuda, N, P, K, thr):
    boxes, scores, valid = (t.to(cuda) for t in _nms_inputs(N, N, P))
    before = nms_many.launches
    idx, mask = nms_many(boxes, scores, thr, K, 0.05, valid)
    assert nms_many.launches == before + 1
    ridx, rmask = nms_many_plain(boxes, premask_scores(scores, 0.05, valid), thr, K)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx) and torch.equal(mask, rmask)


def test_nms_kernel_rejects_more_than_32_boxes(cuda):
    boxes, scores, _ = (t.to(cuda) for t in _nms_inputs(0, 4, 33))
    with pytest.raises(ValueError, match="1..32"):
        nms_many(boxes, scores, 0.5, 4)


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
    before = tube_roi_align.launches
    got = tube_roi_align(feat, tubes, pooled, 1 / 16, ratio)
    assert tube_roi_align.launches == before + 1
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
    before = tube_roi_align.launches
    got = tube_roi_align(feat, tubes, 7, 1 / 16, 0)
    assert tube_roi_align.launches == before + 1
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


@pytest.mark.parametrize("shape", [(2, 192, 9, 28, 28), (3, 13, 5, 7, 7),
                                   (1, 1, 1, 1, 1), (1, 8, 1, 1, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernel_equals_plain(cuda, shape, dtype):
    x = _ncdhw(5, shape, dtype)
    before = max_pool3x3_same.launches
    got = max_pool3x3_same(x)
    assert max_pool3x3_same.launches == before + 1
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


@pytest.mark.parametrize("shape", [(2, 64, 9, 28, 28), (3, 13, 5, 7, 7), (1, 5, 1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bn_relu_kernel_matches_plain(cuda, shape, dtype):
    C = shape[1]
    x = _ncdhw(7, shape, dtype)
    rng = np.random.RandomState(8)
    scale = torch.from_numpy((rng.rand(C) * 2 + 0.1).astype(np.float32)).cuda()
    bias = torch.from_numpy(rng.randn(C).astype(np.float32)).cuda()
    before = fused_scale_bias_relu.launches
    got = fused_scale_bias_relu(x, scale, bias)
    assert fused_scale_bias_relu.launches == before + 1
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
    before = conv3x3x3_bn_relu.launches
    got = conv3x3x3_bn_relu(x, w, scale, bias)
    assert conv3x3x3_bn_relu.launches == before + 1
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
    before = conv3x3x3_bn_relu.launches
    got = conv3x3x3_bn_relu(x, w, scale, bias)
    assert conv3x3x3_bn_relu.launches == before + 1
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
    monkeypatch.setenv("STEP_TPU_POOL3D", "pallas")
    cfg = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8,
                                       image_size=64, compute_dtype="float32",
                                       fused_bn_relu=True)
    model = init_detector_(STEPDetector(cfg).eval(), seed=3)
    props, pmask = STEPDetector.initial_proposals(cfg, 2, device="cpu")
    rgb = torch.from_numpy(np.random.RandomState(4).randint(
        0, 256, (2, cfg.total_frames, 64, 64, 3)).astype(np.uint8))
    ref = detect_clip(model, rgb, props, pmask)
    counts = [f.launches for f in (conv3x3x3_bn_relu, fused_scale_bias_relu,
                                   max_pool3x3_same)]
    got = detect_clip(model.to(cuda), rgb.to(cuda), props.to(cuda), pmask.to(cuda))
    after = [f.launches for f in (conv3x3x3_bn_relu, fused_scale_bias_relu,
                                  max_pool3x3_same)]
    assert [a - b for a, b in zip(after, counts)] == [10, 21, 5]
    torch.testing.assert_close(got["tubes"].cpu(), ref["tubes"], rtol=0, atol=1e-3)
    torch.testing.assert_close(got["tube_scores"].cpu(), ref["tube_scores"],
                               rtol=0, atol=1e-4)
