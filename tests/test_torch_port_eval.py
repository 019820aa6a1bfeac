"""The port's UCF101-24 evaluation against the JAX package's, on the CPU:
`evaluate.collect_detections`, `dedupe_frame_detections`,
`link_frame_detections`, `tube_nms`, `evaluate_ucf` (host and device
linking, whole and cut by `max_batches`, calibrated, dumped), and
`train_eval_synth`'s video-eval arm.

A tiny float32 configuration (32 px, 2-frame chunks, 3 chunks, tiny depth)
with the JAX package's weights bridged by `from_jax_variables`, on a mini
on-disk UCF101-24 layout read by each package's own reader (their items
are bit-equal, `tests/test_torch_port_ucf.py`). Tolerances: detections
carry the same frame keys and classes in the same order, scores within
1e-5 and boxes within 1e-4 px (float reassociation between XLA's and
PyTorch's CPU convolutions); every mAP within 1e-6 and `eval_subset`
equal; the host-side functions (dedupe, linker, tube NMS) exactly equal to
the JAX functions on the same detections, order included.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import os
import pickle

import jax
import numpy as np
import pytest

from step_tpu import evaluate as jev
from step_tpu.config import StepConfig as JaxStepConfig
from step_tpu.data import synthetic as jsyn
from step_tpu.data.ucf import UCFDataset as JaxUCFDataset
from step_tpu.eval import detection_metrics as jdm
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch import evaluate as tev
from step_tpu_torch.config import StepConfig
from step_tpu_torch.convert import from_jax_variables
from step_tpu_torch.data.ucf import UCFDataset
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.parallel import create_mesh
from step_tpu_torch.train_eval_synth import evaluate_videos
from tests.test_data import _write_jpg
from tests.test_torch_port_detect import _randomize

FIELDS = dict(
    dataset="ucf101_24", num_classes=3, frames_per_chunk=2, num_chunks=3,
    num_steps=2, iou_thresholds=(0.4, 0.5), step_loss_weights=(1.0, 1.0),
    temporal_extension=True, image_size=32, backbone_depth="tiny",
    feature_stride=8, pooled_size=4, max_proposals=12, max_detections=4,
    compute_dtype="float32", max_gt_tubes=2, score_thresh=0.0,
)
JCFG, CFG = JaxStepConfig(**FIELDS), StepConfig(**FIELDS)
SCORE_TOL, BOX_TOL, MAP_TOL = 1e-5, 1e-4, 1e-6
MAPS = ("frame_mAP@0.5", "video_mAP@0.2", "video_mAP@0.5", "video_mAP@0.5:0.95")


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(JAX variables, JAX detector, the port's model on the same weights,
    the root of a mini UCF101-24 layout)."""
    variables = _randomize(init_detector_cpu(JCFG, jax.random.PRNGKey(0)), 1)
    model = STEPDetector(CFG).eval()
    model.load_state_dict(from_jax_variables(variables, CFG))
    root = str(tmp_path_factory.mktemp("ucf_eval"))
    rng = np.random.RandomState(5)
    H, W = 48, 64
    # 6 + 5 + 5 windows: two full batches of 8, and every video's clip
    # axis padded to 8 in device linking, so each program shape compiles
    # once in the JAX package
    nframes = {"Run/v1": 12, "Jump/v2": 11, "Run/v3": 10}
    gttubes = {}
    for video, n in nframes.items():
        for f in range(n):
            img = rng.rand(H, W, 3) * 0.3
            img[10 + f:30 + f, 12:34] = 0.9         # a bright actor, moving down
            _write_jpg(os.path.join(root, "rgb-images", video, f"{f + 1:05d}.jpg"), img)
        frames = np.arange(1, n + 1, dtype=np.float32)
        tube = np.stack([frames, np.full_like(frames, 12), 10 + frames - 1,
                         np.full_like(frames, 34), 30 + frames - 1], axis=1)
        gttubes[video] = {int(video.startswith("Jump")): [tube]}
    gt = {"labels": ["Run", "Jump", "Wave"], "train_videos": [list(nframes)],
          "test_videos": [list(nframes)], "nframes": nframes, "gttubes": gttubes,
          "resolution": {v: (H, W) for v in nframes}}
    with open(os.path.join(root, "UCF101v2-GT.pkl"), "wb") as f:
        pickle.dump(gt, f)
    return variables, JaxDetector(JCFG), model, root


def _datasets(root):
    return UCFDataset(root, CFG, split="test"), JaxUCFDataset(root, JCFG, split="test")


def _assert_detections_close(got, want):
    assert len(got) == len(want) > 0
    assert [(k, c) for k, c, _, _ in got] == [(k, c) for k, c, _, _ in want]
    np.testing.assert_allclose([s for _, _, s, _ in got], [s for _, _, s, _ in want],
                               rtol=0, atol=SCORE_TOL)
    np.testing.assert_allclose(np.stack([b for *_, b in got]),
                               np.stack([b for *_, b in want]), rtol=0, atol=BOX_TOL)
    assert all(b.dtype == np.float32 for *_, b in got)


@pytest.mark.parametrize("max_batches", [None, 1])
def test_collect_detections_matches_jax(pair, max_batches):
    variables, jmodel, model, root = pair
    ds, jds = _datasets(root)
    cov, jcov = {}, {}
    got = tev.collect_detections(model, ds, max_batches=max_batches, coverage=cov)
    want = jev.collect_detections(variables, jds, JCFG, jmodel, max_batches=max_batches,
                                  coverage=jcov)
    _assert_detections_close(got, want)
    assert cov == jcov
    # boxes scaled back to the native 64 px width
    assert max(b[2] for *_, b in got) > CFG.image_size
    assert {k for k, *_ in got} <= cov["fkeys"]


def test_collect_detections_refuses_what_is_not_ported(pair):
    _, _, model, root = pair
    ds, _ = _datasets(root)
    with pytest.raises(ValueError, match="temporal_stride"):
        tev.collect_detections(STEPDetector(CFG.replace(temporal_stride=2)), ds)
    # late fusion needs a dataset that reads flow
    with pytest.raises(ValueError, match="flow-enabled dataset"):
        tev.collect_detections(model, ds, model_flow=STEPDetector(
            CFG.replace(input_stream="flow")).eval())
    # and over a mesh (data-parallel evaluation, here on one CPU rank)
    mesh = create_mesh(device_type="cpu")
    with pytest.raises(ValueError, match="flow-enabled dataset"):
        tev.collect_detections(model, ds, mesh=mesh, model_flow=STEPDetector(
            CFG.replace(input_stream="flow")).eval())
    with pytest.raises(ValueError, match="temporal_stride"):
        tev.evaluate_ucf(STEPDetector(CFG.replace(temporal_stride=2)), ds, mesh=mesh)


@pytest.mark.parametrize("device_linking,max_batches,max_videos", [
    (False, None, None), (False, 1, None), (True, None, None), (True, 1, None),
    (True, None, 2),
])
def test_evaluate_ucf_matches_jax(pair, tmp_path, device_linking, max_batches,
                                  max_videos):
    variables, jmodel, model, root = pair
    ds, jds = _datasets(root)
    dump = str(tmp_path / "dets.pkl")
    got = tev.evaluate_ucf(model, ds, dump_path=dump, max_batches=max_batches,
                           device_linking=device_linking, max_videos=max_videos)
    want = jev.evaluate_ucf(variables, jds, JCFG, jmodel, max_batches=max_batches,
                            device_linking=device_linking, max_videos=max_videos)
    assert sorted(got) == sorted(want)
    assert got.get("eval_subset") == want.get("eval_subset")
    for key in MAPS:
        assert abs(got[key] - want[key]) <= MAP_TOL or (np.isnan(got[key])
                                                        and np.isnan(want[key])), key
    timings = got["timings"]
    assert sorted(timings) == sorted(want["timings"])
    assert timings["n_detections"] == want["timings"]["n_detections"] > 0
    assert timings["n_tubes"] == want["timings"]["n_tubes"]
    # the dump is the JAX package's layout: its evaluator reads it and
    # scores it as the port did
    with open(dump, "rb") as f:
        dumped = pickle.load(f)["detections"]
    frame_gt, _ = jds.video_groundtruth()
    if max_batches is None:
        assert jdm.frame_map(dumped, frame_gt, CFG.num_classes, 0.5)["mAP"] == \
            pytest.approx(got["frame_mAP@0.5"], abs=0)


def test_evaluate_ucf_calibration_matches_jax(pair, tmp_path):
    """`fit_calibration_path` fits per-class Platt scaling on the run's
    deduplicated detections against its GT: the JAX package's
    `fit_calibration` on the dumped detections gives the saved parameters
    exactly. A calibration, from a dict and from an .npz, applied to host
    and device linking gives the JAX package's mAPs within MAP_TOL."""
    from step_tpu.eval.calibration import fit_calibration

    variables, jmodel, model, root = pair
    ds, jds = _datasets(root)
    path, dump = str(tmp_path / "calib.npz"), str(tmp_path / "dets.pkl")
    tev.evaluate_ucf(model, ds, fit_calibration_path=path, dump_path=dump)
    with open(dump, "rb") as f:
        dumped = pickle.load(f)["detections"]
    want = fit_calibration(dumped, jds.video_groundtruth()[0], CFG.num_classes)
    got = dict(np.load(path))
    for k in ("a", "b"):
        np.testing.assert_array_equal(got[k], want[k])
    given = {"a": np.float32([3.0, 0.5, 1.5]), "b": np.float32([-1.0, 0.2, 0.0])}
    np.savez(path, **given)
    for link, calibration in ((False, given), (True, path)):
        got = tev.evaluate_ucf(model, ds, calibration=calibration, device_linking=link)
        want = jev.evaluate_ucf(variables, jds, JCFG, jmodel, calibration=calibration,
                                device_linking=link)
        for key in MAPS:
            assert abs(got[key] - want[key]) <= MAP_TOL, (link, key)


# ---- the host-side functions, on the same randomized detection lists -------

def _random_detections(rng, n, videos=3, frames=12, classes=3):
    """Detections revisiting earlier boxes exactly or within the 0.1 px
    cell, tied scores, and frame gaps longer than the linker's max_gap."""
    dets = []
    for _ in range(n):
        fkey = (f"v{rng.randint(videos)}", int(rng.choice(np.r_[1:frames, frames + 6])))
        c = int(rng.randint(classes))
        box = (rng.rand(4) * 40).astype(np.float32)
        box[2:] += box[:2] + 4
        if dets and rng.rand() < 0.5:
            box = np.asarray(dets[rng.randint(len(dets))][3], np.float32)
            if rng.rand() < 0.5:
                box = box + np.float32(rng.choice([0.04, 0.06, 1.5]))
        dets.append((fkey, c, round(float(rng.rand()), 1), box))
    return dets


def _assert_same_tubes(got, want):
    assert len(got) == len(want)
    for (v, c, s, f), (jv, jc, js, jf) in zip(got, want):
        assert (v, c, s) == (jv, jc, js) and list(f) == list(jf)
        for k in jf:
            np.testing.assert_array_equal(f[k], jf[k])


@pytest.mark.parametrize("trial", range(5))
def test_dedupe_frame_detections_equals_jax(trial):
    rng = np.random.RandomState(30 + trial)
    dets = _random_detections(rng, int(rng.randint(0, 400)))
    got, want = tev.dedupe_frame_detections(dets), jev.dedupe_frame_detections(dets)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g is w        # the same detections, in the same order


@pytest.mark.parametrize("trial", range(4))
def test_link_frame_detections_equals_jax(trial):
    rng = np.random.RandomState(40 + trial)
    dets = _random_detections(rng, 300)
    kw = [{}, dict(link_iou=0.5, max_gap=1, min_length=3)][trial % 2]
    _assert_same_tubes(tev.link_frame_detections(dets, **kw),
                       jev.link_frame_detections(dets, **kw))


@pytest.mark.parametrize("thresh", [0.0, -1.0, 0.2, 0.5])
def test_tube_nms_equals_jax(thresh):
    rng = np.random.RandomState(7)
    tubes = jev.link_frame_detections(_random_detections(rng, 400), link_iou=0.05)
    assert len(tubes) > 20
    got, want = tev.tube_nms(tubes, thresh), jev.tube_nms(tubes, thresh)
    if thresh <= 0:
        assert got is tubes
    elif thresh == 0.2:
        assert len(got) < len(tubes)
    _assert_same_tubes(got, want)


def test_video_eval_arm_matches_jax(pair):
    """`train_eval_synth --video-eval`'s arm (both linkers on synthetic
    videos) against the JAX script's, on the same weights: the same mAPs
    to the 4 places both print, and the same detection and tube counts."""
    variables, jmodel, model, _ = pair
    W, T, fpc = 4, CFG.total_frames, CFG.frames_per_chunk
    got = evaluate_videos(model, CFG, 2, W, 8)
    vds = jsyn.SyntheticVideoDataset(
        jsyn.SyntheticConfig(image_size=32, num_frames=(W - 1) * fpc + T, num_classes=3,
                             max_boxes=2), 2, W, T, fpc, seed=20_000_000)
    gt = vds.video_gt()
    dets = jev.dedupe_frame_detections(jev.collect_detections(
        variables, vds, JCFG, jmodel, batch_size=8, image_scale_to_gt=False))
    tubes = {"host": jev.link_frame_detections(dets),
             "device": jev.collect_video_tubes(variables, vds, JCFG, jmodel,
                                               image_scale_to_gt=False)}
    times = got.pop("video_eval_timings")
    assert sorted(got) == sorted(f"video_mAP@{t}_{n}" for n in ("host", "device")
                                 for t in (0.2, 0.5))
    assert (times["windows"], times["n_detections"], times["n_tubes_host"],
            times["n_tubes_device"]) == (2 * W, len(dets), len(tubes["host"]),
                                         len(tubes["device"]))
    assert times["detections_per_window"] == len(dets) / (2 * W)
    for name in ("host", "device"):
        assert len(tubes[name]) > 0
        for thr in (0.2, 0.5):
            want = round(float(jdm.video_map(tubes[name], gt, 3, thr)["mAP"]), 4)
            assert got[f"video_mAP@{thr}_{name}"] == want, (name, thr)
