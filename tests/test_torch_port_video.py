"""The port's video path against the JAX package's, on the CPU: the
chunk-stem detector, `detect_video`, the two streaming forms,
`collect_video_tubes`, and the host-side copies (`eval/detection_metrics`,
`eval/calibration`, `data/synthetic`, the uint8 wire).

A tiny configuration modelled on `tests/test_streaming.py` (32 px, 2-frame
chunks, tiny depth, float32), weights bridged by `from_jax_variables`,
inputs from a numpy seed. Tolerances: 1e-3 px on tubes and 1e-4 on scores
(float reassociation between XLA's and PyTorch's CPU convolutions); link
outputs exactly equal when linking reads the JAX package's own detections,
so that no near-tie of the detector can flip a path; copies exactly equal.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from step_tpu import inference as jinf
from step_tpu.config import StepConfig as JaxStepConfig
from step_tpu.data import pipeline as jpipe
from step_tpu.data import synthetic as jsyn
from step_tpu.eval import calibration as jcal
from step_tpu.eval import detection_metrics as jdm
from step_tpu.evaluate import collect_video_tubes as jax_collect_video_tubes
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch import inference as tinf
from step_tpu_torch.config import StepConfig
from step_tpu_torch.convert import from_jax_variables
from step_tpu_torch.data import pipeline as tpipe
from step_tpu_torch.data import synthetic as tsyn
from step_tpu_torch.eval import calibration as tcal
from step_tpu_torch.eval import detection_metrics as tdm
from step_tpu_torch.evaluate import collect_video_tubes
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.models.optimize import optimize_for_inference
from step_tpu_torch.parallel import create_mesh
from step_tpu_torch.tubes.linking import link_tubes_multiclass_k
from tests.test_torch_port_detect import _randomize

FIELDS = dict(
    dataset="synthetic", num_classes=4, frames_per_chunk=2, num_chunks=3,
    num_steps=2, iou_thresholds=(0.4, 0.5), step_loss_weights=(1.0, 1.0),
    temporal_extension=True, image_size=32, backbone_depth="tiny",
    feature_stride=8, pooled_size=4, max_proposals=12, max_detections=4,
    compute_dtype="float32", chunk_stem=True,
)
JCFG, CFG = JaxStepConfig(**FIELDS), StepConfig(**FIELDS)
N_CHUNKS = 5
TUBE_TOL, SCORE_TOL = 1e-3, 1e-4
SURFACE = ("tubes", "tube_scores", "frame_boxes", "frame_scores", "frame_mask")
LINK = ("link_paths", "link_scores", "link_trim", "link_tube_scores")


@pytest.fixture(scope="module")
def pair():
    """(JAX variables, the port's model on the same weights, a video of
    N_CHUNKS chunks as float frames in [0, 1])."""
    variables = _randomize(init_detector_cpu(JCFG, jax.random.PRNGKey(0)), 1)
    model = STEPDetector(CFG).eval()
    model.load_state_dict(from_jax_variables(variables, CFG))
    rng = np.random.RandomState(0)
    frames = rng.rand(N_CHUNKS * CFG.frames_per_chunk, 32, 32, 3).astype(np.float32)
    return variables, model, frames


def _close(got, want, keys=SURFACE, err=""):
    for key in keys:
        tol = TUBE_TOL if key in ("tubes", "frame_boxes") else SCORE_TOL
        if key == "frame_mask":
            continue        # survivors compared through their scores and boxes
        np.testing.assert_allclose(np.asarray(got[key]), np.asarray(want[key]),
                                   rtol=0, atol=tol, err_msg=f"{err} {key}")


def _window(frames, ids):
    c = CFG.frames_per_chunk
    return np.concatenate([frames[i * c:(i + 1) * c] for i in ids])[None]


def _detect_clip(model, clip):
    props, pmask = STEPDetector.initial_proposals(CFG, clip.shape[0], device="cpu")
    return tinf.detect_clip(model, torch.from_numpy(clip), props, pmask)


def test_chunk_stem_detector_matches_jax(pair):
    variables, model, frames = pair
    rgb = np.stack([_window(frames, [0, 1, 2])[0], _window(frames, [2, 3, 4])[0]])
    props, _ = JaxDetector.initial_proposals(JCFG, 2)
    want = jax.jit(JaxDetector(JCFG).apply)(variables, jnp.asarray(rgb), props)
    seen = []
    hook = model.features.stem_rgb.register_forward_pre_hook(
        lambda _, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            got = model(torch.from_numpy(rgb), torch.from_numpy(np.array(props)))
    finally:
        hook.remove()
    # The chunks fold into the batch as a view of NDHWC memory: the stem
    # sees B * K chunks in channels_last_3d order.
    assert seen[0].shape[:3] == (2 * CFG.num_chunks, 3, CFG.frames_per_chunk)
    assert seen[0].is_contiguous(memory_format=torch.channels_last_3d)
    for key, tol in (("cls_logits", SCORE_TOL), ("deltas", SCORE_TOL),
                     ("tubes", TUBE_TOL)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=tol, err_msg=key)
    # per-chunk stems concatenate into the clip's feature map
    with torch.no_grad():
        feat = model.stem(torch.from_numpy(rgb[:1]))
        parts = [model.stem(torch.from_numpy(_window(frames, [i])), chunks=1)
                 for i in range(3)]
    assert feat.is_contiguous()
    np.testing.assert_allclose(feat.numpy(), torch.cat(parts, dim=1).numpy(),
                               rtol=0, atol=1e-5)


def test_streaming_preset_with_chunk_stems_builds():
    from step_tpu_torch.config import PRESETS

    model = STEPDetector(PRESETS["streaming"].replace(chunk_stem=True))
    assert model.features.chunks == 3 and model.features.out_channels == 832


def test_optimize_for_inference_keeps_chunk_stem(pair):
    _, model, frames = pair
    cfg_opt, sd = optimize_for_inference(CFG, model.state_dict())
    assert cfg_opt.chunk_stem and cfg_opt.num_chunks == CFG.num_chunks
    served = STEPDetector(cfg_opt).eval()
    served.load_state_dict(sd)
    assert served.features.chunks == CFG.num_chunks
    clip = _window(frames, [1, 2, 3])
    got, want = _detect_clip(served, clip), _detect_clip(model, clip)
    _close(got, want, ("tubes", "tube_scores"))
    # the chunk fold is on: 3 chunks of 2 frames give one slice each, the
    # clip as one chunk 6 → 3 → 2 slices
    with torch.no_grad():
        assert served.stem(torch.from_numpy(clip)).shape[1] == CFG.num_chunks
        assert served.stem(torch.from_numpy(clip), chunks=1).shape[1] == 2


@pytest.mark.parametrize("stride, padded", [(None, 0), (2, 1)])
def test_detect_video_matches_jax(pair, stride, padded):
    variables, model, frames = pair
    L = 3
    if stride:      # sliding windows one chunk apart
        clips = np.concatenate([_window(frames, [i, i + 1, i + 2]) for i in range(L)])
        clips = (clips * 255).astype(np.uint8)
    else:           # independent clips
        shape = (L, CFG.total_frames, 32, 32, 3)
        clips = np.random.RandomState(3).randint(0, 256, shape).astype(np.uint8)
    cmask = np.ones(L, np.float32)
    cmask[L - padded:] = 0.0
    fn = jinf.make_detect_video_fn(JCFG)
    want = fn(variables, jnp.asarray(clips), clip_mask=jnp.asarray(cmask),
              tiling_stride=stride)
    got = tinf.detect_video(model, torch.from_numpy(clips),
                            clip_mask=torch.from_numpy(cmask), tiling_stride=stride)
    C, K = CFG.num_classes, CFG.link_tubes_per_class
    assert got["link_paths"].shape == (C, K, L) and got["link_paths"].dtype == torch.int32
    assert got["link_trim"].shape == (C, K, L)
    _close(got, want)
    if padded:
        assert float(got["link_trim"][..., L - padded:].sum()) == 0.0
    # linking on the JAX package's own detections: exactly its links
    _, pmask = JaxDetector.initial_proposals(JCFG, L)
    link = link_tubes_multiclass_k(
        torch.from_numpy(np.array(want["tubes"])),
        torch.from_numpy(np.array(want["tube_scores"])),
        torch.from_numpy(np.array(pmask)), CFG.link_iou_weight,
        CFG.link_tubes_per_class, CFG.link_trim_thresh, torch.from_numpy(cmask),
        stride=stride, suppress_iou=CFG.link_suppress_iou)
    for key, mine in zip(LINK, ("paths", "values", "trim", "tube_scores")):
        if key in ("link_paths", "link_trim"):
            np.testing.assert_array_equal(link[mine].numpy(), np.asarray(want[key]),
                                          err_msg=key)
        else:
            np.testing.assert_allclose(link[mine].numpy(), np.asarray(want[key]),
                                       rtol=0, atol=1e-5, err_msg=key)


def test_detect_video_stream_matches_jax_and_detect_clip(pair):
    variables, model, frames = pair
    got = tinf.detect_video_stream(model, torch.from_numpy(frames))
    want = jinf.detect_video_stream(variables, jnp.asarray(frames), JCFG)
    assert len(got) == len(want) == N_CHUNKS
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, err=f"clip {i}")
    # an interior window and both clamped edges against detect_clip
    for center, ids in ((2, [1, 2, 3]), (0, [0, 0, 1]), (4, [3, 4, 4])):
        _close(got[center], _detect_clip(model, _window(frames, ids)),
               err=f"window {ids}")


def test_detect_video_stream_batched_matches_jax_and_detect_clip(pair):
    variables, model, frames = pair
    got = tinf.detect_video_stream_batched(model, torch.from_numpy(frames), clip_batch=2)
    want = jinf.detect_video_stream_batched(variables, jnp.asarray(frames), JCFG,
                                            clip_batch=2)
    assert got["tubes"].shape[0] == N_CHUNKS      # batches of 2, 2 and 1
    _close(got, want)
    for center, ids in ((3, [2, 3, 4]), (0, [0, 0, 1]), (4, [3, 4, 4])):
        ref = _detect_clip(model, _window(frames, ids))
        _close({k: v[center:center + 1] for k, v in got.items()}, ref,
               err=f"window {ids}")


@pytest.mark.parametrize("fn", [tinf.detect_video_stream,
                                tinf.detect_video_stream_batched])
def test_streaming_errors(pair, fn):
    _, model, frames = pair
    unchunked = STEPDetector(CFG.replace(chunk_stem=False)).eval()
    with pytest.raises(ValueError, match="chunk_stem"):
        fn(unchunked, torch.from_numpy(frames))
    with pytest.raises(ValueError, match="not a multiple of chunk size"):
        fn(model, torch.from_numpy(frames[:-1]))


@pytest.mark.parametrize("calibrated", [False, True])
def test_collect_video_tubes_matches_jax(pair, calibrated):
    variables, _, _ = pair
    cfg_j, cfg = JCFG.replace(score_thresh=0.0), CFG.replace(score_thresh=0.0)
    model = STEPDetector(cfg).eval()
    model.load_state_dict(from_jax_variables(variables, cfg))
    T, fpc, W = cfg.total_frames, cfg.frames_per_chunk, 3
    kw = dict(image_size=32, num_frames=(W - 1) * fpc + T,
              num_classes=cfg.num_classes, max_boxes=2)
    vds_j = jsyn.SyntheticVideoDataset(jsyn.SyntheticConfig(**kw), 2, W, T, fpc, seed=7)
    vds = tsyn.SyntheticVideoDataset(tsyn.SyntheticConfig(**kw), 2, W, T, fpc, seed=7)
    calib = None
    if calibrated:
        calib = {"a": np.float32([4.0, 1.0, 2.0, 0.5]), "b": np.float32([-1, 0, 0.5, 0])}
    want = jax_collect_video_tubes(variables, vds_j, cfg_j, image_scale_to_gt=False,
                                   clip_batch=2, calibration=calib)
    got = collect_video_tubes(model, vds, image_scale_to_gt=False, clip_batch=2,
                              calibration=calib)
    assert len(want) > 0
    assert [(v, c, sorted(f)) for v, c, _, f in got] == \
        [(v, c, sorted(f)) for v, c, _, f in want]
    for (_, _, s_g, f_g), (_, _, s_w, f_w) in zip(got, want):
        assert abs(s_g - s_w) <= SCORE_TOL
        for f in f_w:
            np.testing.assert_allclose(f_g[f], f_w[f], rtol=0, atol=TUBE_TOL)
    gt = vds.video_gt()
    for thr in (0.2, 0.5):
        np.testing.assert_equal(tdm.video_map(got, gt, cfg.num_classes, thr),
                                jdm.video_map(want, vds_j.video_gt(),
                                              cfg.num_classes, thr))


def test_collect_video_tubes_refuses_what_is_not_ported(pair):
    _, model, _ = pair
    with pytest.raises(ValueError, match="temporal_stride"):
        collect_video_tubes(STEPDetector(CFG.replace(temporal_stride=2)), None)
    # late fusion needs a dataset that reads flow
    T, fpc = CFG.total_frames, CFG.frames_per_chunk
    no_flow = tsyn.SyntheticVideoDataset(tsyn.SyntheticConfig(
        image_size=32, num_frames=fpc + T, num_classes=CFG.num_classes, max_boxes=2),
        1, 2, T, fpc, seed=7)
    with pytest.raises(ValueError, match="flow-enabled dataset"):
        collect_video_tubes(model, no_flow, model_flow=STEPDetector(
            CFG.replace(input_stream="flow")).eval())
    # and over a mesh (data-parallel evaluation, here on one CPU rank)
    mesh = create_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="temporal_stride"):
        collect_video_tubes(STEPDetector(CFG.replace(temporal_stride=2)), None, mesh=mesh)
    with pytest.raises(ValueError, match="flow-enabled dataset"):
        collect_video_tubes(model, no_flow, mesh=mesh, model_flow=STEPDetector(
            CFG.replace(input_stream="flow")).eval())


# ---- the host-side copies, each equal to its original ----------------------

def _tubes(rng, n_videos, n_classes, n, frames, jitter):
    out = []
    for i in range(n):
        start = rng.randint(1, frames // 2)
        box = rng.rand(4).astype(np.float32) * 20
        box[2:] += box[:2] + 10
        tube = {f: box + rng.randn(4).astype(np.float32) * jitter
                for f in range(start, start + rng.randint(3, frames // 2))}
        out.append((f"v{i % n_videos}", int(rng.randint(n_classes)), tube))
    return out


def test_detection_metrics_copy_equals_the_jax_package():
    rng = np.random.RandomState(11)
    gt = _tubes(rng, 3, 3, 8, 30, 0.0)
    preds = [(v, c, float(rng.rand()), {f: b + rng.randn(4).astype(np.float32)
                                        for f, b in t.items()})
             for v, c, t in gt + _tubes(rng, 3, 3, 6, 30, 2.0)]
    for thr in (0.2, 0.5):
        np.testing.assert_equal(tdm.video_map(preds, gt, 3, thr),
                                jdm.video_map(preds, gt, 3, thr))
    np.testing.assert_equal(tdm.video_map_range(preds, gt, 3),
                            jdm.video_map_range(preds, gt, 3))
    for (_, _, a), (_, _, _, b) in zip(gt, preds):
        assert tdm.spatio_temporal_iou(a, b) == jdm.spatio_temporal_iou(a, b)
    dets = [((v, f), c, s, b) for v, c, s, t in preds for f, b in t.items()]
    frame_gt = [((v, f), c, b) for v, c, t in gt for f, b in t.items()]
    for a, b in ((tdm.frame_map(dets, frame_gt, 3), jdm.frame_map(dets, frame_gt, 3)),
                 (tdm.match_detections(dets, frame_gt, 3, 0.3),
                  jdm.match_detections(dets, frame_gt, 3, 0.3))):
        np.testing.assert_equal(a, b)
    scores, tp = rng.rand(20), rng.rand(20) > 0.5
    assert tdm.average_precision(scores, tp, 12) == jdm.average_precision(scores, tp, 12)


def test_calibration_copy_equals_the_jax_package():
    rng = np.random.RandomState(12)
    box = np.float32([10, 10, 50, 50])
    dets, gts = [], []
    for i in range(60):
        c, s = i % 2, float(rng.rand())
        hit = rng.rand() < s
        gts.append(((f"v{c}", i), c, box))
        dets.append(((f"v{c}", i), c, s, box if hit else box + 200))
    want, got = jcal.fit_calibration(dets, gts, 3), tcal.fit_calibration(dets, gts, 3)
    for key in ("a", "b"):
        np.testing.assert_array_equal(got[key], want[key])
    surface = rng.rand(4, 5, 3).astype(np.float32)
    np.testing.assert_array_equal(tcal.calibrate_scores_array(surface, got["a"], got["b"]),
                                  jcal.calibrate_scores_array(surface, want["a"], want["b"]))
    np.testing.assert_equal(tcal.apply_calibration(dets, got),
                            jcal.apply_calibration(dets, want))


@pytest.mark.parametrize("fields", [{}, {"same_class_actors": True, "num_classes": 3},
                                    {"force_label": 5, "num_classes": 12}])
def test_synthetic_copy_equals_the_jax_package(fields):
    kw = dict(image_size=32, num_frames=10, **fields)
    ours, theirs = tsyn.SyntheticConfig(**kw), jsyn.SyntheticConfig(**kw)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    np.testing.assert_array_equal(ours.palette, theirs.palette)
    for a, b in ((tsyn.make_clip(3, ours), jsyn.make_clip(3, theirs)),
                 (tsyn.make_batch(4, 2, ours), jsyn.make_batch(4, 2, theirs))):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    clip = jsyn.make_clip(5, theirs)["rgb"]
    np.testing.assert_array_equal(tsyn.make_flow(clip), jsyn.make_flow(clip))
    args = (2, 3, 6, 2)
    vds_t = tsyn.SyntheticVideoDataset(ours, *args, seed=1, with_flow=True)
    vds_j = jsyn.SyntheticVideoDataset(theirs, *args, seed=1, with_flow=True)
    assert vds_t.samples == vds_j.samples and len(vds_t) == len(vds_j)
    for i in (0, 4):
        a, b = vds_t[i], vds_j[i]
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    np.testing.assert_equal(vds_t.video_gt(), vds_j.video_gt())


def test_synthetic_ucf_layout_copy_equals_the_jax_package(tmp_path):
    kw = dict(num_videos=2, num_classes=3, image_size=32, frames_lo=6, frames_hi=8,
              seed=2)
    assert tsyn.write_ucf_layout(str(tmp_path / "t"), **kw) == \
        jsyn.write_ucf_layout(str(tmp_path / "j"), **kw)
    files = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*")
                   if p.is_file())
    assert files
    for rel in files:
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()


def test_uint8_wire_equals_the_jax_package():
    rng = np.random.RandomState(13)
    x = np.concatenate([rng.rand(1000), np.arange(256) / 255.0,
                        (np.arange(256) + 0.5) / 255.0,      # exact half steps
                        [-1.0, -0.0, 0.0, 1.0, 2.0, np.inf, -np.inf]]).astype(np.float32)
    got, want = tpipe.rgb_to_uint8_wire(x), jpipe.rgb_to_uint8_wire(x)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tpipe.rgb_to_uint8_wire(x.astype(np.float64)),
                                  jpipe.rgb_to_uint8_wire(x.astype(np.float64)))
