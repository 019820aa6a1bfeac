"""The PyTorch port's CUDA kernels against their plain PyTorch versions, on
the card. Skipped without a CUDA device. The card's machine has no JAX, so
run these without the JAX test configuration:

    python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py

NMS must be exactly equal. ROI-align: 1e-4 in float32 (the kernel sums
the bilinear samples in another order than the plain contraction); in
bfloat16 one bf16 rounding step (both accumulate in float32 and round
once at the end, so they differ only where the two float32 sums straddle a
bf16 rounding boundary).
"""

import numpy as np
import pytest
import torch

from step_tpu.config import PRESETS
from step_tpu_torch.inference import detect_clip, nms_surface
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.ops.nms import nms_many, nms_many_plain, premask_scores
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


def test_roi_kernel_refuses_what_it_does_not_take(cuda):
    feat, tubes = (t.to(cuda)
                   for t in _roi_inputs(2, 1, 5, 14, 8, 4, 18, torch.float32))
    with pytest.raises(ValueError, match="adaptive"):
        tube_roi_align(feat, tubes, 7, 1 / 16, 0)
    with pytest.raises(ValueError, match="dtype"):
        tube_roi_align(feat.half(), tubes)
    with pytest.raises(ValueError, match="contiguous"):
        tube_roi_align(feat.transpose(2, 3), tubes)


def test_tiny_detector_on_card_matches_cpu(cuda):
    cfg = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8,
                                       image_size=64, compute_dtype="float32")
    model = init_detector_(STEPDetector(cfg).eval(), seed=3)
    props, pmask = STEPDetector.initial_proposals(cfg, 2)
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
