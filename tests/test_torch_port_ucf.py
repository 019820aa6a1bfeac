"""The port's UCF101-24 reader against the JAX package's, on the CPU:
`data/ucf.py`, `data/augmentations.py` and the native loader's wrapper
`data/native_loader.py`.

Every comparison here is exact (bit-equal arrays, equal strings and
keys): the port's reader and augmentations are copies run on the same
files, seeds and decoder, and the native library is built from the same
source with the same flags. The mini layout writes JPEGs as
`tests/test_data.py::_write_jpg` does: three videos at 48x64, one without
a resolution entry (the native path then falls back to cv2), one with a
short tube between window centres (an orphan), flow frames for all.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import os
import pickle

import numpy as np
import pytest

from step_tpu.config import StepConfig as JaxStepConfig
from step_tpu.data import augmentations as jaug
from step_tpu.data import native_loader as jnative
from step_tpu.data.ucf import UCFDataset as JaxUCFDataset
from step_tpu_torch.config import StepConfig
from step_tpu_torch.data import augmentations as taug
from step_tpu_torch.data import native_loader as tnative
from step_tpu_torch.data.ucf import UCFDataset
from tests.test_data import _write_jpg

FIELDS = dict(dataset="ucf101_24", num_classes=3, frames_per_chunk=2, num_chunks=3,
              image_size=32, max_gt_tubes=2)
JCFG, CFG = JaxStepConfig(**FIELDS), StepConfig(**FIELDS)


@pytest.fixture(scope="module")
def ucf_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ucf"))
    rng = np.random.RandomState(0)
    H, W = 48, 64
    nframes = {"Run/v1": 10, "Jump/v2": 9, "Wave/v3": 7}
    gttubes = {}
    for video, n in nframes.items():
        for f in range(n):
            for kind in ("rgb-images", "brox-images"):
                _write_jpg(os.path.join(root, kind, video, f"{f + 1:05d}.jpg"),
                           rng.rand(H, W, 3) * 0.8)
        frames = np.arange(1, n + 1, dtype=np.float32)
        x1 = 5 + 2 * frames
        tube = np.stack([frames, x1, np.full_like(x1, 10), x1 + 20, np.full_like(x1, 36)], -1)
        cls = {"Run": 0, "Jump": 1, "Wave": 2}[video.split("/")[0]]
        gttubes[video] = {cls: [tube]}
    # two short class-0 tubes beside Jump/v2's long one: frames 5-6, which
    # the window centred on frame 6 covers (0-based centres 1, 3, 5, 7),
    # and frame 9 alone, which no centre covers (an orphan, given to the
    # nearest window)
    gttubes["Jump/v2"][0] = [np.float32([[5, 2, 2, 20, 20], [6, 3, 2, 21, 20]]),
                             np.float32([[9, 30, 5, 50, 40]])]
    gt = {
        "labels": ["Run", "Jump", "Wave"],
        "train_videos": [["Run/v1", "Jump/v2"]],
        "test_videos": [["Jump/v2", "Wave/v3", "Run/v1"]],
        "nframes": nframes,
        "gttubes": gttubes,
        # Wave/v3 has no entry: the native path falls back to cv2 there
        "resolution": {"Run/v1": (H, W), "Jump/v2": (H, W)},
    }
    with open(os.path.join(root, "UCF101v2-GT.pkl"), "wb") as f:
        pickle.dump(gt, f)
    return root


def _assert_items_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key


@pytest.mark.parametrize("split,kw,epoch", [
    ("train", dict(augment=True), 0),
    ("train", dict(augment=True), 3),
    ("train", dict(augment=True, with_flow=True), 1),
    ("test", dict(), 0),
    ("test", dict(use_native=False), 0),
    ("test", dict(with_flow=True), 0),
    ("test", dict(clip_stride=3), 0),
])
def test_ucf_items_equal_the_jax_package(ucf_root, split, kw, epoch):
    """Every item of the split, bit for bit, with the augmentation salted by
    the same epoch; and the decoder the port says it ran."""
    want_ds = JaxUCFDataset(ucf_root, JCFG, split=split, **kw)
    got_ds = UCFDataset(ucf_root, CFG, split=split, **kw)
    want_ds._epoch = got_ds._epoch = epoch
    assert got_ds.samples == want_ds.samples and len(got_ds) == len(want_ds) > 0
    for i in range(len(want_ds)):
        got = got_ds[i]
        _assert_items_equal(got, want_ds[i])
        native = (got_ds.use_native and not got_ds.with_flow
                  and got["video"] in got_ds.resolution and jnative.native_available())
        assert got_ds.decoder == ("native" if native else "cv2"), (i, got["video"])
    assert got_ds._orphan_owners("Jump/v2") == want_ds._orphan_owners("Jump/v2")


def test_ucf_orphan_tube_supervises_its_nearest_window(ucf_root):
    ds = UCFDataset(ucf_root, CFG, split="test", use_native=False)
    # Jump/v2's centres are 1, 3, 5, 7 (0-based); the one-frame tube at
    # 0-based frame 8 covers none and is owned by the window centred on 7
    assert ds._orphan_owners("Jump/v2") == {(0, 1): 7}
    items = {it["center_frame"]: it for it in (ds[i] for i in range(len(ds)))
             if it["video"] == "Jump/v2"}
    labels = {c: sorted(it["gt_labels"][it["gt_mask"] > 0].tolist())
              for c, it in items.items()}
    assert labels == {1: [1], 3: [1], 5: [0, 1], 7: [0, 1]}


def test_ucf_video_groundtruth_equals_the_jax_package(ucf_root):
    for split in ("train", "test"):
        got = UCFDataset(ucf_root, CFG, split=split).video_groundtruth()
        want = JaxUCFDataset(ucf_root, JCFG, split=split).video_groundtruth()
        for g, w in zip(got, want):
            assert len(g) == len(w) > 0
            for a, b in zip(g, w):
                assert a[:2] == b[:2]
                if isinstance(b[2], dict):
                    assert sorted(a[2]) == sorted(b[2])
                    for f in b[2]:
                        np.testing.assert_array_equal(a[2][f], b[2][f])
                else:
                    np.testing.assert_array_equal(a[2], b[2])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("flow", [False, True])
def test_augmentations_bit_equal_to_the_jax_package(seed, flow):
    rng = np.random.RandomState(100 + seed)
    T, H, W = 4, 30, 40
    frames = rng.rand(T, H, W, 3).astype(np.float32)
    flow_in = (rng.rand(T, H, W, 2).astype(np.float32) * 2 - 1) if flow else None
    tubes = np.zeros((3, T, 4), np.float32)
    tubes[:2, :, :2] = rng.rand(2, T, 2) * 15
    tubes[:2, :, 2:] = tubes[:2, :, :2] + 5 + rng.rand(2, T, 2) * 15
    mask = np.float32([1, 1, 0])
    # every transform on: photometric, expand, crop and flip each fire
    cfg_kw = dict(hflip_prob=0.5, photometric_prob=0.7, expand_prob=0.6, crop_prob=0.8)
    got = taug.TubeAugment(taug.TubeAugmentConfig(**cfg_kw))(
        frames, tubes, mask, np.random.RandomState(seed), flow=flow_in)
    want = jaug.TubeAugment(jaug.TubeAugmentConfig(**cfg_kw))(
        frames, tubes, mask, np.random.RandomState(seed), flow=flow_in)
    assert len(got) == len(want) == (4 if flow else 3)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    for size in (16, 32):
        for g, w in zip(taug.resize_clip(got[0], got[1], size),
                        jaug.resize_clip(want[0], want[1], size)):
            np.testing.assert_array_equal(g, w)


def test_augment_config_defaults_equal_the_jax_package():
    import dataclasses

    assert (dataclasses.asdict(taug.TubeAugmentConfig())
            == dataclasses.asdict(jaug.TubeAugmentConfig()))


def test_native_loader_equals_the_jax_package(ucf_root):
    """The port builds `native/clip_loader.cc` unedited into its own build
    directory; its decode equals the JAX package's library's bit for bit,
    with the normalizing mean and std and without."""
    assert tnative.native_available() == jnative.native_available()
    if not tnative.native_available():
        with pytest.raises(RuntimeError, match="unavailable"):
            tnative.decode_clip([], 8)
        return
    lib = tnative.library_path()
    assert lib.parent.name == "_build" and lib.parent.parent.name == "step_tpu_torch"
    assert lib.exists()
    paths = [os.path.join(ucf_root, "rgb-images", "Run/v1", f"{f:05d}.jpg")
             for f in (1, 4, 10)]
    for size in (32, 24):
        got = tnative.decode_clip(paths, size)
        np.testing.assert_array_equal(got, jnative.decode_clip(paths, size))
        zero, one = np.zeros(3, np.float32), np.ones(3, np.float32)
        np.testing.assert_array_equal(tnative.decode_clip(paths, size, zero, one),
                                      jnative.decode_clip(paths, size, zero, one))
    with pytest.raises(FileNotFoundError, match="missing.jpg"):
        tnative.decode_clip(paths[:1] + [os.path.join(ucf_root, "missing.jpg")], 16)


def test_native_loader_can_be_disabled(ucf_root, monkeypatch):
    monkeypatch.setenv("STEP_TPU_DISABLE_NATIVE", "1")
    assert not tnative.native_available()
    ds = UCFDataset(ucf_root, CFG, split="test")
    assert ds.decoder == "cv2"
    ds[0]
    assert ds.decoder == "cv2"
