"""The port's command-line entry points on the CPU: `utils/cli.py` (the
`--set` overlay, held equal to the JAX package's on
`tests/test_cli_overrides.py`'s cases), `optimize_for_inference_cli`
(config held equal field for field to the JAX package's), and
`python -m step_tpu_torch.cli.train` / `cli.test` driven in-process
(`main(argv)`) on a mini on-disk UCF101-24 layout at the tiny size of
`tests/test_cli_e2e.py::TINY_SET`, plus one subprocess run of `cli.test`;
and, after `tests/test_cli_e2e.py:185`, the AVA branch (training with its
in-training `evaluate_ava`, then `--preset ava_3step`) on a mini AVA
layout, and the flow branches on a UCF layout with `brox-images`: `--flow`
(two-stream), a flow-stream detector (`--set input_stream=flow`) and late
fusion (`--flow-ckpt-dir`).

Tolerances: overrides and configs exactly equal; `--optimized` (BN folded
in float32) within 1e-4 of the unfolded model's mAPs; the CLI's printed
mAPs equal `evaluate_ucf`'s to the 4 places it prints.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import contextlib
import dataclasses
import io
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

from step_tpu.config import StepConfig as JaxStepConfig
from step_tpu.models.optimize import optimize_for_inference_cli as jax_optimize_cli
from step_tpu.utils.cli import parse_overrides as jax_parse_overrides
from step_tpu_torch.cli import test as cli_test
from step_tpu_torch.cli import train as cli_train
from step_tpu_torch.config import StepConfig
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.models.optimize import optimize_for_inference_cli
from step_tpu_torch.utils.cli import apply_overrides, parse_overrides
from tests.test_cli_e2e import TINY_SET

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAPS = ("frame_mAP@0.5", "video_mAP@0.2", "video_mAP@0.5", "video_mAP@0.5:0.95")

OVERRIDE_CASES = [
    ["max_gt_tubes=2"],
    ["max_gt_tubes=2,warmup_steps=100"],
    ["iou_thresholds=(0.4,0.5,0.6)"],
    ["iou_thresholds=(0.4,0.5),num_steps=2,max_gt_tubes=3"],
    ["backbone_depth=tiny"],
    ["iou_thresholds=(0.4,)", "num_steps=1,score-thresh=0.0"],
    ["max_gt_tubes=2,oops"],
    ["max_gt_tubes"],
    ["roi_impl=0"],
]


@pytest.mark.parametrize("overrides", OVERRIDE_CASES)
def test_parse_overrides_equals_the_jax_package(overrides):
    try:
        want = jax_parse_overrides(JaxStepConfig(), overrides)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_overrides(StepConfig(), overrides)
        assert str(got.value) == str(e)
        return
    got = parse_overrides(StepConfig(), overrides)
    assert got == want and [type(v) for v in got.values()] == [type(v) for v in want.values()]
    assert dataclasses.asdict(apply_overrides(StepConfig(), overrides)) == \
        dataclasses.asdict(JaxStepConfig().replace(**want))


@pytest.mark.parametrize("overrides", [
    [], ["fused_inception=False"], ["scan_unroll=False"], ["fused_inception3=tail"],
    ["fused_bn_relu=True,compute_dtype=float32"], ["bn_folded=False"],
])
def test_optimize_for_inference_cli_equals_the_jax_package(overrides):
    """Explicit --set serving flags win over the optimized defaults; the
    config is the JAX package's field for field, and the weights follow
    the fusion flags."""
    cfg = StepConfig(backbone_depth="tiny", feature_stride=8, image_size=32)
    jcfg = JaxStepConfig(backbone_depth="tiny", feature_stride=8, image_size=32)
    sd = STEPDetector(cfg).eval().state_dict()
    if overrides == ["bn_folded=False"]:
        with pytest.raises(ValueError, match="conflicts with --optimized"):
            optimize_for_inference_cli(cfg, overrides, sd)
        with pytest.raises(ValueError, match="conflicts with --optimized"):
            jax_optimize_cli(jcfg, overrides)
        return
    got, sd = optimize_for_inference_cli(cfg, overrides, sd)
    want, _ = jax_optimize_cli(jcfg, overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert optimize_for_inference_cli(cfg, overrides) == (got, None)
    served = STEPDetector(got).eval()
    served.load_state_dict(sd)       # the folded weights fit the served model
    assert any(".b012." in k for k in sd) == got.fused_inception
    assert not any(".bn." in k for k in sd)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A mini UCF101-24 layout, a checkpoint trained on it by `cli.train`
    (4 steps, an in-training evaluation each epoch) and what it printed."""
    from step_tpu_torch.data.synthetic import write_ucf_layout

    tmp = tmp_path_factory.mktemp("cli")
    root = str(tmp / "ucf")
    videos = write_ucf_layout(root, 3, num_classes=2, image_size=32, frames_lo=8,
                              frames_hi=10, seed=1)
    with open(os.path.join(root, "UCF101v2-GT.pkl"), "rb") as f:
        gt = pickle.load(f)
    gt["train_videos"] = [videos[:2]]
    with open(os.path.join(root, "UCF101v2-GT.pkl"), "wb") as f:
        pickle.dump(gt, f)
    ckpt, logs = str(tmp / "ckpt"), str(tmp / "logs")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = cli_train.main([
            "--dataset", "ucf101_24", "--data-root", root, "--ckpt-dir", ckpt,
            "--log-dir", logs, "--epochs", "2", "--eval-every-epochs", "1",
            "--eval-max-batches", "2", "--set", "num_classes=2", "--device", "cpu",
            *TINY_SET])
    return dict(root=root, ckpt=ckpt, logs=logs, out=buf.getvalue(), state=state,
                tmp=tmp)


def test_train_cli_checkpoints_and_evaluates(trained):
    out = trained["out"]
    assert trained["state"].step == 4
    assert re.search(r"epoch 0 eval: .*'frame_mAP@0\.5'", out), out
    assert "'eval_subset'" in out and "trained to step 4 on cpu; decoder: cv2" in out
    assert sorted(os.listdir(trained["ckpt"])) == ["4.pt"]
    with open(os.path.join(trained["logs"], "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 4


def _test_cli(trained, *extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        results = cli_test.main(["--data-root", trained["root"], "--ckpt-dir",
                                 trained["ckpt"], "--set", "num_classes=2", "--device",
                                 "cpu", *TINY_SET, *extra])
    return results, buf.getvalue()


@pytest.mark.parametrize("extra", [
    [], ["--optimized"], ["--device-linking"], ["--max-batches", "1"],
    ["--device-linking", "--max-videos", "1"],
])
def test_test_cli_prints_the_evaluation(trained, extra):
    dump = str(trained["tmp"] / "dets.pkl")
    results, out = _test_cli(trained, "--dump", dump, "--set", "score_thresh=0.0", *extra)
    assert "restored step 4" in out and re.search(r"^decoder: (native|cv2)$", out, re.M)
    for key in MAPS:
        m = re.search(rf"^{re.escape(key)}: ([0-9.]+|nan)$", out, re.M)
        assert m, out
        assert m.group(1) == f"{results[key]:.4f}"
    assert re.search(r"^timings: collect_s=\d+\.\d\d, .*n_detections=\d+, .*peak_rss_mb=",
                     out, re.M), out
    if "--max-batches" in extra:
        assert "eval_subset: 2 videos touched" in out
    if "--max-videos" in extra:
        assert "eval_subset: 1 videos" in out
    with open(dump, "rb") as f:
        assert len(pickle.load(f)["detections"]) == results["timings"]["n_detections"] > 0
    if extra == ["--optimized"]:
        plain, _ = _test_cli(trained, "--set", "score_thresh=0.0")
        for key in MAPS:
            assert results[key] == pytest.approx(plain[key], abs=1e-4), key


@pytest.mark.parametrize("module,argv,item", [
    # the JAX package's own refusals (train.py:196-198, :204-209; test.py:93-95,
    # :107-109); WORLD_SIZE=2 as torchrun would set it for two processes
    (cli_train, ["--distributed", "--eval-every-epochs", "1"],
     "not supported with --distributed"),
    (cli_train, ["--distributed", "--batch-size", "3"], "not divisible by 2 processes"),
    (cli_test, ["--data-root", "x", "--ckpt-dir", "y", "--flow-ckpt-dir", "z",
                "--optimized"], "does not combine with --flow-ckpt-dir"),
    (cli_test, ["--data-root", "x", "--ckpt-dir", "y", "--flow-ckpt-dir", "z",
                "--preset", "ava_3step"], "UCF-only"),
])
def test_clis_refuse_what_is_not_ported(module, argv, item, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match=item):
        module.main([*argv, "--device", "cpu"])


def test_distributed_train_and_sharded_test_on_one_process(trained, monkeypatch):
    """`cli.train --distributed` and `cli.test --sharded` with no torchrun
    environment: one rank. Training takes the fixture's 4 steps, with
    losses within 1e-4 relative of the plain run's (BatchNorm's sums over
    the group against its means); the sharded evaluation prints the plain
    one's results exactly."""
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    ckpt, logs = str(trained["tmp"] / "ckpt_dp"), str(trained["tmp"] / "logs_dp")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        state = cli_train.main([
            "--dataset", "ucf101_24", "--data-root", trained["root"], "--ckpt-dir", ckpt,
            "--log-dir", logs, "--epochs", "2", "--distributed", "--set", "num_classes=2",
            "--device", "cpu", *TINY_SET])
    assert "distributed: process 0/1" in buf.getvalue()
    assert state.step == 4 and sorted(os.listdir(ckpt)) == ["4.pt"]
    read = lambda d: [eval(line)["loss"] for line in open(os.path.join(d, "metrics.jsonl"))]  # noqa: E731
    np.testing.assert_allclose(read(logs), read(trained["logs"]), rtol=1e-4)
    plain, _ = _test_cli(trained)
    sharded, out = _test_cli(trained, "--sharded")
    assert "sharded eval over 1 devices" in out
    for key in MAPS:
        assert sharded[key] == plain[key] or (np.isnan(sharded[key]) and np.isnan(plain[key]))


def test_clis_run_on_the_card_unless_asked(trained):
    """`--device` defaults to cuda: without a card the entry points raise,
    they do not fall back to the CPU."""
    for module in (cli_train, cli_test):
        assert module.parse_args(["--data-root", "x", "--ckpt-dir", "y"]).device == "cuda"
    import torch

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cli_test.main(["--data-root", trained["root"], "--ckpt-dir", trained["ckpt"],
                           "--set", "num_classes=2", *TINY_SET])


def test_test_cli_as_a_module(trained):
    """`python -m step_tpu_torch.cli.test --device cpu` in a fresh process."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "step_tpu_torch.cli.test", "--data-root", trained["root"],
         "--ckpt-dir", trained["ckpt"], "--device", "cpu", "--set", "num_classes=2",
         *TINY_SET],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    for key in MAPS:
        assert re.search(rf"^{re.escape(key)}: ", proc.stdout, re.M), proc.stdout
    assert "decoder: " in proc.stdout and "timings: " in proc.stdout
    assert not any(m in proc.stderr for m in ("import jax", "No module named 'jax'"))


# ---- AVA and flow -----------------------------------------------------------

AVA_SET = ["--set", "num_classes=3", "--set", "max_gt_tubes=2"]


def _run(module, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = module.main([*argv, "--device", "cpu", *TINY_SET])
    return result, buf.getvalue()


@pytest.fixture(scope="module")
def ava_trained(tmp_path_factory):
    """A mini AVA layout (`tests/test_cli_e2e.py::mini_ava`'s: frames, a
    training and a validation CSV with real sparse ids, the label map, an
    exclusion file) and a checkpoint `cli.train --dataset ava` trained on
    it, evaluating the validation CSV after each epoch."""
    from tests.test_ava_protocol import PBTXT_ITEM
    from tests.test_data import _write_jpg

    tmp = tmp_path_factory.mktemp("cli_ava")
    root = str(tmp / "ava")
    rng = np.random.RandomState(1)
    for video in ("vidA", "vidB"):
        for fn in range(1, 30):
            _write_jpg(os.path.join(root, "frames", video, f"{video}_{fn:06d}.jpg"),
                       rng.rand(40, 48, 3) * 0.5)
    rows = ["vidA,2,0.1,0.2,0.5,0.9,1,1", "vidA,3,0.1,0.2,0.5,0.9,1,1",
            "vidA,3,0.1,0.2,0.5,0.9,2,1", "vidA,4,0.2,0.2,0.6,0.8,80,2",
            "vidB,3,0.3,0.3,0.7,0.7,4,5", "vidB,4,0.3,0.3,0.7,0.7,80,5"]
    for name in ("ava_train.csv", "ava_val.csv"):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(rows))
    with open(os.path.join(root, "label_map.pbtxt"), "w") as f:
        f.write(PBTXT_ITEM)
    with open(os.path.join(root, "excluded.csv"), "w") as f:
        f.write("vidA,2\n")
    ckpt = str(tmp / "ckpt")
    ava = ["--label-map", os.path.join(root, "label_map.pbtxt"), "--fps", "5",
           "--exclusions", "excluded.csv", *AVA_SET]
    state, out = _run(cli_train, [
        "--preset", "ava_3step", "--dataset", "ava", "--data-root", root,
        "--annotation-file", "ava_train.csv", "--eval-annotation-file", "ava_val.csv",
        "--ckpt-dir", ckpt, "--epochs", "2", "--eval-every-epochs", "1", *ava])
    return dict(root=root, ckpt=ckpt, ava=ava, state=state, out=out, tmp=tmp)


def test_ava_train_cli_evaluates_during_training(ava_trained):
    out = ava_trained["out"]
    assert ava_trained["state"].step == 4
    m = re.search(r"epoch 0 eval: \{'frame_mAP@0\.5': ([0-9.e-]+|nan)\}", out)
    assert m, out
    assert re.search(r"epoch 1 eval: \{'frame_mAP@0\.5'", out) and "trained to step 4" in out
    assert sorted(os.listdir(ava_trained["ckpt"])) == ["4.pt"]


def test_ava_test_cli_prints_the_evaluation(ava_trained):
    """`cli.test --preset ava_3step` restores the AVA checkpoint and prints
    `evaluate_ava`'s frame-mAP; the dump holds its detections."""
    dump = str(ava_trained["tmp"] / "ava_dets.pkl")
    results, out = _run(cli_test, [
        "--preset", "ava_3step", "--data-root", ava_trained["root"], "--ckpt-dir",
        ava_trained["ckpt"], "--annotation-file", "ava_val.csv", "--dump", dump,
        "--set", "score_thresh=0.0", *ava_trained["ava"]])
    assert "restored step 4" in out and "decoder:" not in out
    m = re.search(r"^frame_mAP@0\.5: ([0-9.]+|nan)$", out, re.M)
    assert m and m.group(1) == f"{results['frame_mAP@0.5']:.4f}", out
    assert 0.0 <= results["frame_mAP@0.5"] <= 1.0
    with open(dump, "rb") as f:
        dets = pickle.load(f)["detections"]
    assert dets and all(0 <= c < 3 and (k[0], k[1]) != ("vidA", 2.0) for k, c, _, _ in dets)


@pytest.fixture(scope="module")
def flow_trained(trained):
    """`trained`'s layout with `brox-images` beside its frames, and two
    checkpoints trained on it: a two-stream detector (`--flow`) and a
    flow-stream one (`--set input_stream=flow`, for late fusion)."""
    from tests.test_data import _write_jpg

    root = trained["root"]
    rng = np.random.RandomState(2)
    rgb = os.path.join(root, "rgb-images")
    for dirpath, _, files in os.walk(rgb):
        for name in files:
            _write_jpg(os.path.join(root, "brox-images", os.path.relpath(dirpath, rgb), name),
                       rng.rand(32, 32, 3))
    out = {}
    for kind, extra in (("two_stream", ["--flow"]),
                        ("flow_stream", ["--set", "input_stream=flow"])):
        ckpt = str(trained["tmp"] / f"ckpt_{kind}")
        state, text = _run(cli_train, ["--dataset", "ucf101_24", "--data-root", root,
                                       "--ckpt-dir", ckpt, "--epochs", "1",
                                       "--set", "num_classes=2", *extra])
        out[kind] = dict(ckpt=ckpt, state=state, out=text)
    return out


def _test_cli_maps(out, results):
    for key in MAPS:
        m = re.search(rf"^{re.escape(key)}: ([0-9.]+|nan)$", out, re.M)
        assert m, out
        assert m.group(1) == f"{results[key]:.4f}"


def test_flow_train_then_test_cli(trained, flow_trained):
    """`cli.train --flow` trains both stems and the fusion unit; `cli.test
    --preset two_stream_train` evaluates that checkpoint with the flow."""
    ts = flow_trained["two_stream"]
    assert ts["state"].step == 4 and ts["state"].model.features.fusion is not None
    results, out = _run(cli_test, ["--preset", "two_stream_train", "--data-root",
                                   trained["root"], "--ckpt-dir", ts["ckpt"],
                                   "--set", "num_classes=2", "--set", "score_thresh=0.0"])
    assert "restored step 4" in out
    _test_cli_maps(out, results)
    assert results["timings"]["n_detections"] > 0


def test_flow_stream_test_cli(trained, flow_trained):
    """A flow-stream checkpoint evaluated alone: the flow is its input."""
    fs = flow_trained["flow_stream"]
    assert fs["state"].model.features.stem_rgb.Conv3d_1a_7x7.conv.weight.shape[1] == 2
    results, out = _run(cli_test, ["--data-root", trained["root"], "--ckpt-dir", fs["ckpt"],
                                   "--set", "num_classes=2", "--set", "input_stream=flow",
                                   "--set", "score_thresh=0.0"])
    _test_cli_maps(out, results)


def test_test_cli_late_fusion(trained, flow_trained):
    """`--flow-ckpt-dir`: the RGB checkpoint and the flow-stream one fused
    before NMS, equal to `evaluate_ucf(model, ds, model_flow=...)` on the
    same weights, linked on the device."""
    from step_tpu_torch.data.ucf import UCFDataset
    from step_tpu_torch.evaluate import evaluate_ucf

    fs = flow_trained["flow_stream"]
    results, out = _run(cli_test, ["--data-root", trained["root"], "--ckpt-dir",
                                   trained["ckpt"], "--flow-ckpt-dir", fs["ckpt"],
                                   "--set", "num_classes=2", "--set", "score_thresh=0.0",
                                   "--device-linking"])
    assert "restored the flow stream's step 4" in out
    _test_cli_maps(out, results)
    cfg = trained["state"].model.cfg.replace(score_thresh=0.0)
    models = []
    for c, state in ((cfg, trained["state"]), (cfg.replace(input_stream="flow"), fs["state"])):
        models.append(STEPDetector(c).eval())
        models[-1].load_state_dict(state.model.state_dict())
    ds = UCFDataset(trained["root"], cfg, split="test", with_flow=True)
    want = evaluate_ucf(models[0], ds, model_flow=models[1], device_linking=True)
    for key in MAPS:
        assert results[key] == pytest.approx(want[key], abs=1e-6, nan_ok=True), key
    assert results["timings"]["n_detections"] == want["timings"]["n_detections"] > 0
