"""The port's serving and demo command lines (`step_tpu_torch/cli/serve.py`,
`cli/demo.py`) and its copy of `utils/vis.py`, on the CPU.

  * `_sliding_windows` and `_load_clips` equal the JAX package's `serve.py`
    (the ownership tiling and the decoded clips, exactly).
  * The twin of `tests/test_serve_protocol.py::test_serve_matches_test_cli`:
    on a 3-chunk tiny config, `cli.train`, then `cli.test --dump` against
    `cli.export` then `cli.serve` on the same video and checkpoint give the
    same detections (frames and classes equal, scores within rtol 1e-5 /
    atol 1e-6, boxes within rtol 1e-4 / atol 1e-3 px, that test's
    bounds), as the evaluated model, as the `--optimized` tree and as the
    kernel configuration (`--set fused_bn_relu=True`). Both pin the cv2
    decoder (`STEP_TPU_DISABLE_NATIVE`).
  * A directory of videos, served with the next video's decode in
    flight, gives each video the detections of its standalone serve.
  * The refusals: a flow-stream config, a config whose wire format is not
    the program's, and no card without `--device cpu`.
  * `draw_detections` equals the JAX package's pixels; `write_video` then
    `extract_frames` keeps the frame count; `cli.demo` writes as many
    frames as it reads.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import contextlib
import io
import os
import pickle

import numpy as np
import pytest
import torch

import serve as jax_serve
from step_tpu.utils import vis as jax_vis
from step_tpu_torch.cli import demo as cli_demo
from step_tpu_torch.cli import export as cli_export
from step_tpu_torch.cli import serve as cli_serve
from step_tpu_torch.cli import test as cli_test
from step_tpu_torch.cli import train as cli_train
from step_tpu_torch.config import PRESETS
from step_tpu_torch.utils import vis
from step_tpu_torch.utils.export import program_op_counts
from tests.test_cli_e2e import TINY_SET
from tests.test_data import _write_jpg
from tests.test_serve_protocol import TINY3_SET, mini_ucf3  # noqa: F401  (a fixture)


# the kernel configuration: K3, K4 and K5 as nodes of the program
KERNELS = ("--set", "fused_bn_relu=True")


def _quiet(fn, argv):
    with contextlib.redirect_stdout(io.StringIO()):
        return fn(argv)


@pytest.mark.parametrize("fpc,chunks", [(2, 3), (3, 3), (5, 3), (3, 5), (6, 3)])
def test_tiling_and_clips_equal_the_jax_serve(fpc, chunks, tmp_path):
    cfg = PRESETS["ucf_3step"].replace(frames_per_chunk=fpc, num_chunks=chunks,
                                       image_size=16)
    for F in (3, 7, 8, 11, 24):
        for got, want in zip(cli_serve._sliding_windows(F, cfg),
                             jax_serve._sliding_windows(F, cfg)):
            np.testing.assert_array_equal(got, want)
    rng = np.random.RandomState(fpc * 10 + chunks)
    frames = tmp_path / "frames"
    for f in range(11):
        _write_jpg(str(frames / f"{f + 1:05d}.jpg"), rng.rand(20, 24, 3))
    for fast in (False, True):
        got = cli_serve._load_clips(str(frames), cfg, fast)
        want = jax_serve._load_clips(str(frames), cfg, fast)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def checkpoint(mini_ucf3, tmp_path_factory):  # noqa: F811
    """A checkpoint `cli.train` wrote on the 3-chunk layout."""
    ckpt = str(tmp_path_factory.mktemp("serve") / "ckpt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STEP_TPU_DISABLE_NATIVE", "1")
        _quiet(cli_train.main, ["--dataset", "ucf101_24", "--data-root", mini_ucf3,
                                "--ckpt-dir", ckpt, "--epochs", "1", "--device", "cpu",
                                *TINY3_SET])
    return ckpt


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """The tiny 3-chunk detect program at B=2, exported once as the
    evaluated model (key ()), as the `--optimized` tree and as the kernel
    configuration (key `KERNELS`)."""
    root = tmp_path_factory.mktemp("programs")
    out = {}
    for optimized in ((), ("--optimized",), KERNELS):
        out[optimized] = str(root / f"detect{len(optimized)}.pt2")
        _quiet(cli_export.main, ["--batch-size", "2", "--out", out[optimized],
                                 "--device", "cpu", *TINY3_SET, *optimized])
    return out


def _serve(program, ckpt, frames_dir, out, *extra):
    return _quiet(cli_serve.main, ["--program", program, "--ckpt-dir", ckpt,
                                   "--frames-dir", frames_dir, "--out", out,
                                   "--batch-size", "2", "--device", "cpu", *TINY3_SET,
                                   *extra])


@pytest.mark.parametrize("optimized", [(), ("--optimized",), KERNELS])
def test_serve_matches_test_cli(mini_ucf3, checkpoint, programs, tmp_path,  # noqa: F811
                                monkeypatch, optimized):
    monkeypatch.setenv("STEP_TPU_DISABLE_NATIVE", "1")
    dump = str(tmp_path / "test_dets.pkl")
    _quiet(cli_test.main, ["--data-root", mini_ucf3, "--ckpt-dir", checkpoint,
                           "--dump", dump, "--device", "cpu", *TINY3_SET, *optimized])
    with open(dump, "rb") as f:
        test_dets = [d for d in pickle.load(f)["detections"] if d[0][0] == "Run/v2"]

    program = programs[optimized]
    nodes = program_op_counts(program)
    assert ({"conv3x3x3_bn_relu", "scale_bias_relu", "max_pool3x3_same"} <= set(nodes)) \
        == (optimized == KERNELS), nodes
    frames = os.path.join(mini_ucf3, "rgb-images", "Run", "v2")
    served = str(tmp_path / "served.pkl")
    serve_dets = _serve(program, checkpoint, frames, served, *optimized)
    with open(served, "rb") as f:
        assert len(pickle.load(f)["detections"]) == len(serve_dets)

    assert len(test_dets) > 0
    assert len(serve_dets) == len(test_dets)
    key = lambda d: (d[0][1], d[1], -d[2])  # noqa: E731
    for (ka, ca, sa, ba), (kb, cb, sb, bb) in zip(sorted(serve_dets, key=key),
                                                  sorted(test_dets, key=key)):
        assert ka[1] == kb[1], "frame mismatch"
        assert ca == cb, "class mismatch"
        np.testing.assert_allclose(sa, sb, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(ba, bb, rtol=1e-4, atol=1e-3)
    # the unowned tail frame (11) is covered by extension positions only
    assert any(k[1] == 11 for k, *_ in serve_dets)
    # --fast-tiling covers every frame
    fast = _serve(program, checkpoint, frames, str(tmp_path / "fast.pkl"),
                  "--fast-tiling", *optimized)
    assert {k[1] for k, *_ in fast} == set(range(1, 12))


def test_serving_a_directory_equals_each_video_alone(mini_ucf3, checkpoint,  # noqa: F811
                                                     programs, tmp_path):
    program = programs[()]
    root = os.path.join(mini_ucf3, "rgb-images", "Run")
    together = _serve(program, checkpoint, root, str(tmp_path / "all.pkl"))
    for video in sorted(os.listdir(root)):
        alone = _serve(program, checkpoint, os.path.join(root, video),
                       str(tmp_path / f"{video}.pkl"))
        mine = [d for d in together if d[0][0] == video]
        assert len(alone) > 0 and len(mine) == len(alone)
        for (ka, ca, sa, ba), (kb, cb, sb, bb) in zip(mine, alone):
            assert (ka, ca, sa) == (kb, cb, sb)
            np.testing.assert_array_equal(ba, bb)
    assert {d[0][0] for d in together} == set(os.listdir(root))


def test_serve_refuses_flow_wire_mismatch_and_no_card(mini_ucf3, checkpoint,  # noqa: F811
                                                      programs, tmp_path):
    frames = os.path.join(mini_ucf3, "rgb-images", "Run", "v2")
    with pytest.raises(SystemExit, match="RGB-stream programs only"):
        _serve("missing.pt2", checkpoint, frames, str(tmp_path / "x.pkl"),
               "--set", "input_stream=flow")
    program = programs[()]
    with pytest.raises(SystemExit, match="program expects torch.uint8 frames"):
        _serve(program, checkpoint, frames, str(tmp_path / "x.pkl"),
               "--set", "uint8_transfer=False")
    for module in (cli_serve, cli_export, cli_demo):
        argv = {cli_serve: ["--program", "p", "--ckpt-dir", "c", "--frames-dir", "f"],
                cli_export: ["--out", "p"], cli_demo: ["--video", "v"]}[module]
        assert module.parse_args(argv).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli_serve.main(["--program", program, "--ckpt-dir", checkpoint,
                            "--frames-dir", frames, "--batch-size", "2", *TINY3_SET])


def _boxes_on(frames):
    rng = np.random.RandomState(4)
    boxes = np.concatenate([rng.rand(5, 2) * 20, 20 + rng.rand(5, 2) * 20], 1)
    return boxes.astype(np.float32), [0, 1, 2, 13, 3], [0.9, 0.7, 0.2, 0.55, 0.01]


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_draw_detections_equals_the_jax_package(dtype):
    rng = np.random.RandomState(3)
    frame = rng.rand(48, 64, 3).astype(np.float32)
    if dtype == "uint8":
        frame = (frame * 255).astype(np.uint8)
    boxes, labels, scores = _boxes_on(frame)
    for names, thresh in ((None, 0.0), ([f"c{i}" for i in range(14)], 0.1)):
        got = vis.draw_detections(frame, boxes, labels, scores, names, thresh)
        want = jax_vis.draw_detections(frame, boxes, labels, scores, names, thresh)
        assert got.dtype == np.uint8 and (got != (frame if dtype == "uint8" else
                                                 (frame * 255).astype(np.uint8))).any()
        np.testing.assert_array_equal(got, want)


def test_write_then_extract_keeps_the_frames(tmp_path):
    rng = np.random.RandomState(5)
    frames = [rng.rand(40, 48, 3).astype(np.float32) for _ in range(7)]
    path = str(tmp_path / "v.mp4")
    vis.write_video(path, frames, fps=5)
    back = vis.extract_frames(path)
    assert back.shape == (7, 40, 48, 3) and back.dtype == np.float32
    assert vis.extract_frames(path, max_frames=3).shape[0] == 3


def test_demo_writes_every_frame_it_reads(tmp_path):
    import cv2

    src = str(tmp_path / "in.mp4")
    rng = np.random.RandomState(0)
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 5, (48, 40))
    assert w.isOpened()
    for _ in range(6):
        w.write((rng.rand(40, 48, 3) * 255).astype(np.uint8))
    w.release()
    out = str(tmp_path / "out.mp4")
    n = _quiet(cli_demo.main, ["--video", src, "--output", out, "--score-thresh", "0.0",
                               "--device", "cpu", *TINY_SET])
    assert n == 6 and vis.extract_frames(out).shape[0] == 6
