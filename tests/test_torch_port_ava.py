"""The port's AVA path against the JAX package's, on the CPU: the copies of
`eval/ava_eval.py` and `data/ava.py`, `detect_clip` on `ava_3step` (60
sigmoid outputs, no background column, the context branch), `train_step`
on a multilabel batch, and `evaluate_ava`.

The copies are compared exactly (label maps, exclusions, CSV rows, the
reader's items bit-equal on the same files, seeds and decoder, and
`groundtruth()`), on an on-disk layout shaped like
`tests/test_ava_protocol.py::real_ava_root`: real sparse action ids (80
among them, and ids no label map evaluates), a person with no evaluated
action, and an excluded keyframe. The detector is tiny (depth "tiny", 32
px, 2-frame chunks, float32), the JAX package's weights bridged by
`from_jax_variables`; tolerances as `tests/test_torch_port_detect.py`
states them (scores 1e-4, tubes 1e-3 px, the NMS surface exact on the JAX
package's tubes and scores), `train_step` as
`tests/test_torch_port_train_step.py` states it for SGD, and
`evaluate_ava`'s frame-mAP@0.5 within 1e-6.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from step_tpu.data.ava import AVADataset as JaxAVADataset
from step_tpu.data.ava import read_ava_csv as jax_read_ava_csv
from step_tpu.eval import ava_eval as jav
from step_tpu.evaluate import evaluate_ava as jax_evaluate_ava
from step_tpu.inference import detect_clip as jax_detect_clip
from step_tpu_torch.data.ava import AVADataset, read_ava_csv
from step_tpu_torch.eval import ava_eval as tav
from step_tpu_torch.evaluate import evaluate_ava
from step_tpu_torch.inference import detect_clip
from step_tpu_torch.models.detector import STEPDetector
from tests.test_ava_protocol import PBTXT_ITEM, PBTXT_LABEL
from tests.test_data import _write_jpg
from tests.test_torch_port_two_stream import (_assert_surface, _bridged, _cfgs, _props,
                                              assert_train_steps_match,
                                              assert_training_init_matches, run_train_steps)

ROWS = [
    "vidA,3,0.1,0.2,0.5,0.9,1,1",       # person 1: an evaluated action (1) ...
    "vidA,3,0.1,0.2,0.5,0.9,2,1",       # ... and one no label map evaluates (2)
    "vidA,3,0.6,0.1,0.9,0.7,3,2",       # person 2: none evaluated
    "vidA,4,0.2,0.2,0.4,0.8,80,1",      # the largest sparse id
    "vidA,5,0.2,0.2,0.4,0.8,4,1",       # the excluded keyframe
    "vidB,3,0.3,0.3,0.7,0.7,4,5",
    "vidB,4,0.3,0.3,0.7,0.7,1,5",
    "vidB,4,0.35,0.3,0.75,0.8,4,5",     # the same person, a second action
    "vidA,2,0.15,0.2,0.55,0.9,1,1",
    "vidB,2,0.3,0.3,0.7,0.7,80,5",
]


@pytest.fixture(scope="module")
def ava_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ava"))
    rng = np.random.RandomState(7)
    for video, n in (("vidA", 29), ("vidB", 22)):     # vidB's last clip runs past its end
        for fn in range(1, n + 1):
            _write_jpg(os.path.join(root, "frames", video, f"{video}_{fn:06d}.jpg"),
                       rng.rand(40, 56, 3) * 0.5)
    with open(os.path.join(root, "ava_val.csv"), "w") as f:
        f.write("\n".join(ROWS))
    with open(os.path.join(root, "label_map.pbtxt"), "w") as f:
        f.write(PBTXT_ITEM)
    with open(os.path.join(root, "excluded.csv"), "w") as f:
        f.write("vidA,5\n")
    return root


@pytest.mark.parametrize("text", [PBTXT_ITEM, PBTXT_LABEL])
def test_label_map_copy_equals_the_jax_package(text):
    got, want = tav.AVALabelMap.from_pbtxt_text(text), jav.AVALabelMap.from_pbtxt_text(text)
    assert (got.ids, got.names, got.num_classes) == (want.ids, want.names, want.num_classes)
    assert [got.dense(i) for i in range(0, 82)] == [want.dense(i) for i in range(0, 82)]
    assert [got.sparse(d) for d in range(got.num_classes)] == \
        [want.sparse(d) for d in range(want.num_classes)]
    ident = tav.AVALabelMap.identity(60)
    assert ident.ids == jav.AVALabelMap.identity(60).ids
    with pytest.raises(ValueError, match="no label entries"):
        tav.AVALabelMap.from_pbtxt_text("nothing here")
    with pytest.raises(ValueError, match="duplicate"):
        tav.AVALabelMap([1, 1])


def test_csv_rows_exclusions_and_frame_map_equal_the_jax_package(ava_root, tmp_path):
    rows = [r.split(",") + ["0.9"] for r in ROWS]
    for label_map in (None, "label_map.pbtxt"):
        lm_t = lm_j = None
        if label_map:
            path = os.path.join(ava_root, label_map)
            lm_t, lm_j = tav.AVALabelMap.from_pbtxt(path), jav.AVALabelMap.from_pbtxt(path)
        for scores in (True, False):
            got = tav.parse_ava_csv_rows(rows, scores, lm_t)
            want = jav.parse_ava_csv_rows(rows, scores, lm_j)
            assert got == want
        got = read_ava_csv(os.path.join(ava_root, "ava_val.csv"), lm_t)
        want = jax_read_ava_csv(os.path.join(ava_root, "ava_val.csv"), lm_j)
        assert got.keys() == want.keys()
        for key in want:
            assert [(b.tolist(), a, p) for b, a, p in got[key]] == \
                [(b.tolist(), a, p) for b, a, p in want[key]]
    excl = tmp_path / "excl.csv"
    excl.write_text("# a comment\nvidA,0902\n\nvidB,1230\n")
    assert tav.read_exclusions(str(excl)) == jav.read_exclusions(str(excl)) == \
        {("vidA", 902.0), ("vidB", 1230.0)}
    # the evaluator: whitelist, exclusions, ids out of range
    rng = np.random.RandomState(0)
    keys = [("v", float(t)) for t in range(6)]
    gt = [(k, int(rng.randint(0, 5)), rng.rand(4).tolist()) for k in keys for _ in range(2)]
    det = [(k, c, float(rng.rand()), (np.asarray(b) + rng.randn(4) * 0.05).tolist())
           for k, c, b in gt] + [(keys[0], 79, 0.5, [0, 0, 1, 1])]
    for kw in ({}, {"excluded_keyframes": {keys[1]}},
               {"label_map": tav.AVALabelMap([1, 2, 3])}):
        jkw = dict(kw)
        if "label_map" in kw:
            jkw["label_map"] = jav.AVALabelMap([1, 2, 3])
        got, want = tav.ava_frame_map(det, gt, 5, **kw), jav.ava_frame_map(det, gt, 5, **jkw)
        np.testing.assert_equal(got, want)


@pytest.mark.parametrize("label_map,augment,native", [
    (True, False, False), (False, False, False), (True, True, False), (True, False, True),
])
def test_dataset_copy_equals_the_jax_package(ava_root, label_map, augment, native):
    """Every keyframe's item bit-equal, the keyframes, exclusions and
    `groundtruth()` equal, on the same files (cv2, or the native loader
    built from the same source)."""
    jcfg, cfg = _cfgs("ava_3step", max_gt_tubes=4)
    kw = dict(fps=5, augment=augment, exclusions_file="excluded.csv", use_native=native)
    path = os.path.join(ava_root, "label_map.pbtxt")
    got_ds = AVADataset(ava_root, cfg, "ava_val.csv",
                        label_map=tav.AVALabelMap.from_pbtxt(path) if label_map else None,
                        **kw)
    want_ds = JaxAVADataset(ava_root, jcfg, "ava_val.csv",
                            label_map=jav.AVALabelMap.from_pbtxt(path) if label_map else None,
                            **kw)
    assert got_ds.keyframes == want_ds.keyframes and len(got_ds) == 6
    assert ("vidA", 5.0) not in got_ds.keyframes and got_ds.excluded == want_ds.excluded
    for i in range(len(got_ds)):
        np.testing.assert_array_equal(got_ds.clip_frame_numbers(got_ds.keyframes[i][1]),
                                      want_ds.clip_frame_numbers(want_ds.keyframes[i][1]))
        got, want = got_ds[i], want_ds[i]
        assert got.keys() == want.keys()
        for key, value in want.items():
            if isinstance(value, np.ndarray):
                assert got[key].dtype == value.dtype, key
                np.testing.assert_array_equal(got[key], value, err_msg=key)
            else:
                assert got[key] == value, key
    gt_t, gt_j = got_ds.groundtruth(), want_ds.groundtruth()
    assert [(k, c, np.asarray(b).tolist()) for k, c, b in gt_t] == \
        [(k, c, np.asarray(b).tolist()) for k, c, b in gt_j]
    if label_map:
        # (vidA, 3): person 1 keeps its evaluated action, person 2 no slot
        item = got_ds[got_ds.keyframes.index(("vidA", 3.0))]
        assert item["gt_mask"].sum() == 1 and item["gt_labels"].sum() == 1.0
        assert any(c == 2 for _, c, _ in gt_t)           # id 80 → dense 2


@pytest.fixture(scope="module")
def ava_pair():
    jcfg, cfg = _cfgs("ava_3step", max_gt_tubes=4)
    return (jcfg, cfg) + _bridged(jcfg, cfg, 40)


@pytest.fixture(scope="module")
def ava_eval_pair():
    """`ava_3step` over the label map's three evaluated classes."""
    jcfg, cfg = _cfgs("ava_3step", max_gt_tubes=4, num_classes=3)
    return (jcfg, cfg) + _bridged(jcfg, cfg, 50)


def test_ava_detect_clip_matches_jax(ava_pair):
    """Sigmoid scores over 60 classes with no background column, the
    context branch, and the C = 60 NMS surface."""
    jcfg, cfg, variables, model = ava_pair
    assert cfg.num_cls_outputs == 60 and model.context is not None
    rgb = np.random.RandomState(41).randint(0, 256, (2, cfg.total_frames, 32, 32, 3))
    rgb = rgb.astype(np.uint8)
    props, pmask = _props(cfg)
    detect = jax.jit(lambda v, r, p, m: jax_detect_clip(v, r, p, m, jcfg))
    want = detect(variables, jnp.asarray(rgb), jnp.asarray(props.numpy()),
                  jnp.asarray(pmask.numpy()))
    got = detect_clip(model, torch.from_numpy(rgb), props, pmask)
    K = min(cfg.max_detections, cfg.max_proposals)
    assert got["frame_mask"].shape == (2, cfg.total_frames, 60, K)
    _assert_surface(got, want, cfg, pmask)
    with torch.no_grad():
        logits = model(torch.from_numpy(rgb), props)["cls_logits"][-1]
    np.testing.assert_allclose(got["tube_scores"].numpy(),
                               (torch.sigmoid(logits) * pmask[..., None]).numpy(),
                               rtol=0, atol=1e-6)


def test_training_init_draws_the_class_prior(ava_pair):
    """The multilabel head's class bias is logit(cls_prior), as the JAX
    package's (`step_tpu/models/detector.py:121-124`)."""
    jcfg, cfg, variables, _ = ava_pair
    assert_training_init_matches(jcfg, cfg, variables)


def test_train_step_on_a_multilabel_batch_matches_jax():
    assert_train_steps_match(run_train_steps("ava_3step", {"num_classes": 60},
                                             multilabel=True))


@pytest.mark.parametrize("max_batches", [None, 1])
def test_evaluate_ava_matches_jax(ava_eval_pair, ava_root, max_batches, tmp_path):
    """The same frame-mAP@0.5 (within 1e-6) and the same dumped detections
    on the same layout and bridged weights; a truncated pass scores the
    keyframes it saw."""
    jcfg, cfg, variables, model = ava_eval_pair
    path = os.path.join(ava_root, "label_map.pbtxt")
    ds = AVADataset(ava_root, cfg, "ava_val.csv", fps=5, exclusions_file="excluded.csv",
                    label_map=tav.AVALabelMap.from_pbtxt(path))
    jds = JaxAVADataset(ava_root, jcfg, "ava_val.csv", fps=5, exclusions_file="excluded.csv",
                        label_map=jav.AVALabelMap.from_pbtxt(path))
    got_dump, want_dump = str(tmp_path / "got.pkl"), str(tmp_path / "want.pkl")
    got = evaluate_ava(model, ds, dump_path=got_dump, max_batches=max_batches)
    want = jax_evaluate_ava(variables, jds, jcfg, dump_path=want_dump,
                            max_batches=max_batches)
    assert got["frame_mAP@0.5"] == pytest.approx(want["frame_mAP@0.5"], abs=1e-6)
    assert 0.0 <= got["frame_mAP@0.5"] <= 1.0
    with open(got_dump, "rb") as f:
        g = pickle.load(f)["detections"]
    with open(want_dump, "rb") as f:
        w = pickle.load(f)["detections"]
    assert len(g) == len(w) > 0
    assert [(k, c) for k, c, _, _ in g] == [(k, c) for k, c, _, _ in w]
    np.testing.assert_allclose([s for _, _, s, _ in g], [s for _, _, s, _ in w],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.stack([b for *_, b in g]), np.stack([b for *_, b in w]),
                               rtol=0, atol=1e-4 / cfg.image_size)
    assert max(float(np.max(b)) for *_, b in g) <= 1.0       # normalized coordinates
    if max_batches == 1:
        assert {k for k, *_ in g} <= set(ds.keyframes[:4])


def test_evaluate_ava_refuses_flow_configurations():
    """RGB only, with the JAX package's message (its
    `test_evaluate_ava_rejects_two_stream`)."""
    for over in ({"two_stream": True}, {"input_stream": "flow"}):
        _, cfg = _cfgs("ava_3step", **over)
        with pytest.raises(ValueError, match="RGB-only"):
            evaluate_ava(STEPDetector(cfg), None)
