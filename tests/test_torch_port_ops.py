"""The PyTorch port's ops and box/tube math against the JAX package.

Same inputs (numpy, from a seed) through both. Tolerances: 1e-6 where the
two compute the same float32 expression, 1e-4 for ROI-align (the port
contracts H then W, the reference one fused (h, w) sum, or a per-sample
gather — float reassociation), and exact equality for NMS, whose keep
lists are discrete and whose IoU the port writes as the Pallas kernel does.
Pallas kernels run in interpret mode, as the JAX package's own tests run
them on the CPU.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from step_tpu import preprocess as jpre
from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.inference import nms_surface as jax_nms_surface
from step_tpu.ops.roi_align import (batched_tube_roi_align_kron,
                                    feature_time_indices as jax_time_indices,
                                    tube_roi_align as jax_tube_roi_align)
from step_tpu.ops import roi_align_pallas as jrap
from step_tpu.ops.nms_pallas import nms_many as jax_nms_many
from step_tpu.tubes import boxes as jboxes
from step_tpu.tubes import proposals as jprop
from step_tpu.tubes import tube_ops as jtube
from step_tpu_torch import kernels
from step_tpu_torch.config import PRESETS
from step_tpu_torch.inference import nms_surface
from step_tpu_torch.ops import nms, roi_align
from step_tpu_torch.ops.kernel_op import LAUNCHES
from step_tpu_torch.preprocess import device_preprocess
from step_tpu_torch.tubes import boxes, proposals, tube_ops
from tests.test_torch_port_gpu import nms_inputs, nms_rank_model, surface_inputs


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Force interpret=True in pallas_call on the CPU."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(jrap.pl, "pallas_call", patched)


def _random_boxes(rng, shape, size=100.0):
    xy = rng.uniform(-10, size, shape + (2,))
    wh = rng.uniform(0, size / 2, shape + (2,))
    wh[rng.rand(*shape) < 0.15] = 0.0                  # zero-area boxes
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---------------------------------------------------------------- preprocess
@pytest.mark.parametrize("dtype", ["uint8", "float32"])
def test_preprocess_matches_jax(dtype):
    rng = np.random.RandomState(0)
    if dtype == "uint8":
        x = rng.randint(0, 256, (2, 3, 5, 4, 3)).astype(np.uint8)
    else:
        x = rng.rand(2, 3, 5, 4, 3).astype(np.float32)
    np.testing.assert_allclose(device_preprocess(_t(x)).numpy(),
                               _np(jpre.device_preprocess(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------- boxes, tubes
def test_box_math_matches_jax():
    rng = np.random.RandomState(1)
    a = _random_boxes(rng, (3, 7))
    b = _random_boxes(rng, (3, 5))
    a[0, 0] = [30, 30, 20, 20]                         # inverted box
    np.testing.assert_allclose(boxes.box_area(_t(a)).numpy(),
                               _np(jboxes.box_area(a)), rtol=1e-6)
    np.testing.assert_allclose(boxes.pairwise_iou(_t(a), _t(b)).numpy(),
                               _np(jboxes.pairwise_iou(a, b)), rtol=1e-6, atol=1e-7)
    deltas = rng.randn(3, 7, 4).astype(np.float32) * 5  # reaches the scale clamp
    np.testing.assert_allclose(boxes.decode_boxes(_t(deltas), _t(a)).numpy(),
                               _np(jboxes.decode_boxes(deltas, a)),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(boxes.clip_boxes(_t(a), 60.0, 80.0).numpy(),
                                  _np(jboxes.clip_boxes(a, 60.0, 80.0)))


@pytest.mark.parametrize("extend", [True, False])
def test_chunk_frame_mask_matches_jax(extend):
    for step in range(4):
        np.testing.assert_array_equal(
            tube_ops.chunk_frame_mask(step, 3, 6, extend).numpy(),
            _np(jtube.chunk_frame_mask(step, 3, 6, extend)))


def test_extrapolate_and_valid_tubes_match_jax():
    rng = np.random.RandomState(2)
    tubes = _random_boxes(rng, (2, 4, 18), size=200.0)
    tubes[1, 0] = [50, 50, 50.5, 90]                   # thin box
    for step in range(3):
        fmask = _np(jtube.chunk_frame_mask(step, 3, 6))
        np.testing.assert_allclose(
            tube_ops.extrapolate_tubes(_t(tubes * fmask[:, None]), _t(fmask),
                                       224.0).numpy(),
            _np(jtube.extrapolate_tubes(tubes * fmask[:, None], fmask, 224.0)),
            rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(tube_ops.valid_tube_mask(_t(tubes)).numpy(),
                                  _np(jtube.valid_tube_mask(tubes)))


@pytest.mark.parametrize("layout", ["default", "grid3"])
def test_initial_cuboids_match_jax(layout):
    t, m = proposals.initial_cuboids(224, 18, 16, layout)
    jt, jm = jprop.initial_cuboids(224, 18, 16, layout)
    np.testing.assert_array_equal(t.numpy(), _np(jt))
    np.testing.assert_array_equal(m.numpy(), _np(jm))
    assert int(m.sum()) == 11


@pytest.mark.parametrize("T,Tp", [(18, 5), (18, 18), (6, 2), (12, 3), (7, 3)])
def test_feature_time_indices_match_jax(T, Tp):
    np.testing.assert_array_equal(roi_align.feature_time_indices(T, Tp).numpy(),
                                  _np(jax_time_indices(T, Tp)))


def test_feature_time_indices_serving_shape():
    assert roi_align.feature_time_indices(18, 5).tolist() == [1, 5, 9, 12, 16]


# ---------------------------------------------------------------- ROI-align
# The boxes of tests/test_torch_step.py: interior, tiny (floors to one
# cell), partly outside, outside the image (its one-cell floor reaches
# back to within a cell of the map), zero-area.
ROI_BOXES = np.asarray([
    [8.0, 8.0, 120.0, 100.0],
    [0.0, 0.0, 16.0, 16.0],
    [100.0, 90.0, 180.0, 150.0],
    [-40.0, -40.0, -8.0, -8.0],
    [50.0, 50.0, 50.0, 50.0],
], np.float32)


def _roi_inputs(seed, B=2, Tp=3, H=9, W=11, C=5, T=6):
    rng = np.random.RandomState(seed)
    feat = rng.randn(B, Tp, H, W, C).astype(np.float32)
    tubes = np.tile(ROI_BOXES[None, :, None, :], (B, 1, T, 1))
    tubes[:, :3] += rng.randn(B, 3, T, 4).astype(np.float32) * 3
    return feat, tubes


@pytest.mark.parametrize("pooled,ratio", [(7, 2), (3, 1), (3, 0)])
def test_roi_align_matches_jax_kron(pooled, ratio):
    feat, tubes = _roi_inputs(3)
    got = roi_align.tube_roi_align_plain(_t(feat), _t(tubes), pooled, 1 / 16, ratio)
    want = batched_tube_roi_align_kron(jnp.asarray(feat), jnp.asarray(tubes),
                                       pooled, 1 / 16, ratio)
    assert got.shape == (2, 5, 3, pooled, pooled, 5)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pooled,ratio", [(7, 2), (3, 1)])
def test_roi_align_matches_jax_pallas_interpret(interpret_pallas, pooled, ratio):
    feat, tubes = _roi_inputs(4)
    got = roi_align.tube_roi_align(_t(feat), _t(tubes), pooled, 1 / 16, ratio)
    want = jrap.tube_roi_align_pallas(jnp.asarray(feat), jnp.asarray(tubes),
                                      pooled, 1 / 16, ratio)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4, atol=1e-4)


def test_roi_align_matches_jax_gather_reference():
    """Against the scalar-semantics gather reference, slice by slice."""
    feat, tubes = _roi_inputs(5, B=1, Tp=6, T=6)
    got = roi_align.tube_roi_align_plain(_t(feat), _t(tubes), 7, 1 / 16, 2)
    want = jax_tube_roi_align(jnp.asarray(feat[0]), jnp.asarray(tubes[0]),
                              7, 1 / 16, 2, impl="gather")
    np.testing.assert_allclose(got[0].numpy(), _np(want), rtol=1e-4, atol=1e-4)


def test_roi_align_bf16_matches_jax_kron():
    """bfloat16: the reference rounds its interpolation weights to bf16
    before the contraction (roi_align.py:299), the port keeps them in
    float32 and rounds only the output; 2e-2 covers both roundings."""
    feat, tubes = _roi_inputs(6)
    got = roi_align.tube_roi_align_plain(_t(feat).to(torch.bfloat16), _t(tubes))
    want = batched_tube_roi_align_kron(
        jnp.asarray(feat, jnp.bfloat16), jnp.asarray(tubes))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want).astype(np.float32),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------- NMS
def _nms_inputs(seed, N, P):
    """Exact score ties, zero-area boxes, duplicates, invalid slots,
    all-invalid problems and scores at the threshold."""
    rng = np.random.RandomState(seed)
    b = _random_boxes(rng, (N, P))
    dup = rng.rand(N, P) < 0.1
    b[dup] = np.repeat(b[:, :1], P, axis=1)[dup]
    scores = (rng.randint(0, 6, (N, P)) / 5.0).astype(np.float32)
    scores[N // 2:] = rng.rand(N - N // 2, P).astype(np.float32)
    scores[0, :2] = 0.05                                 # == score_threshold
    valid = (rng.rand(N, P) > 0.25).astype(np.float32)
    valid[1] = 0.0                                       # all invalid
    return b, scores, valid


@pytest.mark.parametrize("N,P,K,thr,nonfinite", [
    (64, 16, 16, 0.5, False), (40, 5, 8, 0.3, False), (33, 32, 12, 0.7, False),
    (16, 1, 3, 0.5, False), (20, 33, 16, 0.5, False), (12, 64, 16, 0.4, False),
    (24, 16, 16, 0.5, True)])
def test_nms_matches_jax_exactly(N, P, K, thr, nonfinite):
    b, scores, valid = _nms_inputs(N + P, N, P)
    if nonfinite:                       # NaN and +-inf coordinates
        odd = np.random.RandomState(N).rand(N, P, 4) < 0.05
        b[odd] = np.resize(np.float32([np.nan, np.inf, -np.inf]), int(odd.sum()))
    idx, mask = nms.nms_many(_t(b), _t(scores), thr, K, 0.05, _t(valid))
    jidx, jmask = jax_nms_many(jnp.asarray(b), jnp.asarray(scores), thr, K,
                               0.05, jnp.asarray(valid), interpret=True)
    assert idx.dtype == torch.int32 and mask.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), _np(jidx))
    np.testing.assert_array_equal(mask.numpy(), _np(jmask))
    assert float(mask[1].sum()) == 0.0 and int(idx[1].abs().sum()) == 0


def test_nms_zero_area_box_is_kept_once():
    b = np.asarray([[[5, 5, 5, 5], [0, 0, 10, 10], [1, 1, 9, 9]]], np.float32)
    s = np.asarray([[0.9, 0.8, 0.7]], np.float32)
    idx, mask = nms.nms_many(_t(b), _t(s), 0.5, 3, 0.0)
    assert idx.tolist() == [[0, 1, 0]] and mask.tolist() == [[1.0, 1.0, 0.0]]


def test_nms_keeps_a_nan_box_as_jax_does():
    """A NaN coordinate makes every IoU with the box NaN, and NaN > thr is
    false: the box suppresses nothing and nothing suppresses it."""
    b = np.asarray([[[0, 0, 10, 10], [1, 1, np.nan, 11], [0, 0, 10, 10.5]]], np.float32)
    s = np.asarray([[0.9, 0.8, 0.7]], np.float32)
    jidx, jmask = jax_nms_many(jnp.asarray(b), jnp.asarray(s), 0.5, 3, 0.0,
                               interpret=True)
    for idx, mask in ((_np(jidx), _np(jmask)), nms.nms_many(_t(b), _t(s), 0.5, 3, 0.0),
                      nms_rank_model(_t(b), _t(s)[:, None], 0.5, 3)):
        assert np.asarray(idx).reshape(-1).tolist() == [0, 1, 0]
        assert np.asarray(mask).reshape(-1).tolist() == [1.0, 1.0, 0.0]


# K1's algorithm (csrc/nms.cu: suppression bits once per group, keys by
# rank, an alive mask, the freeze rule), modelled in torch, against the
# plain version and the Pallas kernel on every edge case.
@pytest.mark.parametrize("case", ["ties", "nonfinite", "low"])
@pytest.mark.parametrize("P", [1, 5, 16, 33, 64])
def test_nms_rank_model_equals_plain_and_jax(P, case):
    b, s, v, sthr = nms_inputs(P + 7, 12, P, case)
    live = nms.premask_scores(_t(s), sthr, _t(v))
    K = 16                                               # K > P for P = 1, 5
    idx, mask = nms_rank_model(_t(b), live[:, None], 0.5, K)
    pidx, pmask = nms.nms_many_plain(_t(b), live, 0.5, K)
    jidx, jmask = jax_nms_many(jnp.asarray(b), jnp.asarray(s), 0.5, K, sthr,
                               jnp.asarray(v), interpret=True)
    for want_idx, want_mask in ((pidx.numpy(), pmask.numpy()), (_np(jidx), _np(jmask))):
        np.testing.assert_array_equal(idx[:, 0].numpy(), want_idx)
        np.testing.assert_array_equal(mask[:, 0].numpy(), want_mask)
    if case == "low":                     # some problems froze on a live index
        frozen = (pmask.numpy() == 0) & (pidx.numpy() != 0)
        assert P == 1 or frozen.any()


@pytest.mark.parametrize("P,C", [(16, 24), (33, 5)])
def test_nms_rank_model_shares_boxes_across_problems(P, C):
    """C problems over one group's boxes give what each gives alone."""
    G = 6
    b, _, v, _ = nms_inputs(P, G, P, "nonfinite")
    rng = np.random.RandomState(C)
    s = (rng.randint(0, 5, (G, C, P)) / 4.0).astype(np.float32)
    live = nms.premask_scores(_t(s), 0.05, _t(v)[:, None].expand(G, C, P))
    idx, mask = nms_rank_model(_t(b), live, 0.5, 12)
    pidx, pmask = nms.nms_many_plain(_t(b)[:, None].expand(G, C, P, 4).reshape(-1, P, 4),
                                     live.reshape(-1, P), 0.5, 12)
    np.testing.assert_array_equal(idx.reshape(-1, 12).numpy(), pidx.numpy())
    np.testing.assert_array_equal(mask.reshape(-1, 12).numpy(), pmask.numpy())


def test_nms_surface_matches_jax_past_32_boxes_with_a_nan_box():
    """The port's surface on the CPU against the JAX package's, whose
    Pallas branch runs in interpret mode off the TPU: P = 33 proposals,
    one of them with a NaN coordinate in some frames."""
    B, P, T, C = 2, 33, 3, 5
    tubes, scores, pmask = surface_inputs(3, B, P, T, C)
    tubes[0, 4, 1] = torch.tensor([20.0, 20.0, float("nan"), 60.0])
    tubes[1, 0, :, 3] = float("nan")
    port = PRESETS["ucf_3step"].replace(max_detections=16)
    got = nms_surface(tubes, scores, pmask, port)
    want = jax_nms_surface(jnp.asarray(tubes.numpy()), jnp.asarray(scores.numpy()),
                           jnp.asarray(pmask.numpy()),
                           JAX_PRESETS["ucf_3step"].replace(max_detections=16))
    assert got["frame_boxes"].shape == (B, T, C, 16, 4)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        np.testing.assert_array_equal(got[key].numpy(), _np(want[key]), err_msg=key)
    assert bool(got["frame_boxes"].isnan().any())       # the NaN box was kept


# ---------------------------------------------------------------- dispatch
def test_wrappers_take_plain_path_on_cpu_and_raise_elsewhere():
    feat, tubes = _roi_inputs(7)
    before = dict(LAUNCHES)
    torch.testing.assert_close(
        roi_align.tube_roi_align(_t(feat), _t(tubes), 3, 1 / 16, 2),
        roi_align.tube_roi_align_plain(_t(feat), _t(tubes), 3, 1 / 16, 2),
        rtol=0, atol=0)
    b, s, v = _nms_inputs(0, 8, 4)
    nms.nms_many(_t(b), _t(s), 0.5, 4, 0.05, _t(v))
    assert dict(LAUNCHES) == before
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel"):
        roi_align.tube_roi_align(_t(feat).to(meta), _t(tubes).to(meta))
    with pytest.raises(ValueError, match="no kernel"):
        nms.nms_many(_t(b).to(meta), _t(s).to(meta), 0.5, 4)


def test_kernel_launchers_refuse_cpu_tensors():
    b, s, _ = _nms_inputs(0, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.nms_many_forward(_t(b)[:, None], _t(s)[:, None, :, None], None,
                                 torch.empty(8, 1, 1, 4), 0.5, 0.05,
                                 keep_idx=torch.empty(8, 1, 1, 4, dtype=torch.int32))
    feat, tubes = _roi_inputs(0)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.tube_roi_align_forward(_t(feat), _t(tubes[:, :, :3]),
                                       torch.empty(2, 5, 3, 7, 7, 5), 1 / 16, 2)


def test_kernel_library_is_named_by_its_sources():
    path = kernels.library_path()
    assert path.parent == kernels.BUILD_DIR
    assert path == kernels.library_path()
    assert all((kernels.CSRC / name).is_file() for name in kernels.SOURCES)
    assert "sm_90a" in " ".join(kernels.NVCC_FLAGS)
    assert "-fmad=false" in kernels.NVCC_FLAGS
