"""Pretrained I3D weights and the I3D classifier in the PyTorch port
against the JAX package, on the CPU.

  * `models/convert.py`: the normalizer's report and the converted tensors
    equal the JAX package's (bridged by `from_jax_classifier_variables`)
    for the four public namings and a `module.` prefix, bit for bit; a
    missing key, a bias-less classifier and an unknown naming behave as
    there;
  * `pretrained_detector_variables` on a `.pt` file equals the JAX
    package's, both bridged, exactly, for `ucf_3step` and
    `two_stream_train` (the inflated flow stem), and both refuse a
    detector the checkpoint cannot fill. The detector trees start from
    seeded random values of the JAX init's shapes (`jax.eval_shape`), so
    no full-width init is compiled;
  * `I3DClassifier` logits equal the JAX classifier's on `[1, 16, 64, 64,
    3]` float32 within 1e-4 relative (XLA's and PyTorch's CPU convolutions
    reassociate through ~60 layers), and the kernel configuration's plain
    versions equal the main configuration's;
  * `fit(pretrained_i3d=...)`, `cli.train --pretrained-i3d` and
    `cli.classify`, in-process on the CPU. The detector is the full I3D at
    32 px, since a checkpoint of the full I3D fills no tiny backbone.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.models import convert as jconvert
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.models.i3d import I3DClassifier as JaxClassifier
from step_tpu_torch import PRESETS
from step_tpu_torch.convert import from_jax_classifier_variables, from_jax_variables
from step_tpu_torch.models import convert
from step_tpu_torch.models.i3d import I3DClassifier
from tests.test_convert import _rekey_hassony2, _rekey_piergiaj, make_fake_torch_i3d

_NESTED = {"branch_0.conv3d_0a_1x1": "b0", "branch_1.conv3d_0a_1x1": "b1a",
           "branch_1.conv3d_0b_3x3": "b1b", "branch_2.conv3d_0a_1x1": "b2a",
           "branch_2.conv3d_0b_3x3": "b2b", "branch_3.conv3d_0b_1x1": "b3b"}
# full I3D on small clips: 2-frame chunks, 32 px, one refinement step
SMALL = dict(image_size=32, frames_per_chunk=2, num_steps=1, iou_thresholds=(0.4,),
             step_loss_weights=(1.0,), compute_dtype="float32", dropout_rate=0.0)


def _rekey_flat(sd):
    """The from-spec oracle's nested naming → its flat naming."""
    out = {}
    for k, v in sd.items():
        for nested, ours in _NESTED.items():
            k = k.replace(f".{nested}.", f".{ours}.")
        out[k] = v
    return out


NAMINGS = {
    "nested": lambda sd: sd,
    "flat": _rekey_flat,
    "piergiaj": _rekey_piergiaj,
    "hassony2": _rekey_hassony2,
    "module_piergiaj": lambda sd: {f"module.{k}": v for k, v in _rekey_piergiaj(sd).items()},
}


@pytest.fixture(scope="module")
def fake():
    return make_fake_torch_i3d(num_classes=7, seed=3)


def _assert_same(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("naming", sorted(NAMINGS))
def test_convert_equals_the_jax_package(naming, fake):
    sd = NAMINGS[naming](fake)
    _, want_report = jconvert.normalize_i3d_state_dict(sd)
    _, report = convert.normalize_i3d_state_dict(sd)
    assert report == want_report
    assert report["scheme"] == naming.replace("module_", "") and not report["missing"]
    want = from_jax_classifier_variables(jconvert.convert_torch_i3d(sd))
    _assert_same(convert.convert_torch_i3d(sd), want)
    assert "logits.bias" in want
    # the same from torch tensors, as torch.load gives them
    tensors = {k: torch.as_tensor(np.asarray(v)) for k, v in sd.items()}
    _assert_same(convert.convert_torch_i3d(tensors), want)


def test_missing_key_biasless_logits_and_unknown_naming_as_the_jax_package(fake):
    sd = dict(fake)
    dropped = "Mixed_4c.branch_1.conv3d_0b_3x3.conv3d.weight"
    del sd[dropped]
    _, want_report = jconvert.normalize_i3d_state_dict(sd)
    _, report = convert.normalize_i3d_state_dict(sd)
    assert report == want_report and dropped in report["missing"]
    for fn in (jconvert.convert_torch_i3d, convert.convert_torch_i3d):
        with pytest.raises(KeyError, match="missing"):
            fn(sd)
    sd = dict(fake)
    del sd["logits.conv3d.bias"]
    got = convert.convert_torch_i3d(sd)
    _assert_same(got, from_jax_classifier_variables(jconvert.convert_torch_i3d(sd)))
    assert torch.equal(got["logits.bias"], torch.zeros(7))
    assert "logits.weight" not in convert.convert_torch_i3d(sd, include_logits=False)
    for fn in (jconvert.convert_torch_i3d, convert.convert_torch_i3d):
        with pytest.raises(KeyError, match="unrecognized"):
            fn({"backbone.blocks.0.weight": np.zeros(3)})
    with pytest.raises(KeyError, match="not an I3DClassifier"):
        from_jax_classifier_variables({"params": {"features": {}}})


def test_inflate_rgb_to_flow_equals_the_jax_package():
    w = np.random.RandomState(0).randn(64, 3, 7, 7, 7).astype(np.float32)
    want = np.asarray(jconvert.inflate_rgb_to_flow(jnp.asarray(jconvert._conv_kernel(w))))
    got = convert.inflate_rgb_to_flow(torch.from_numpy(w))
    assert got.shape == (64, 2, 7, 7, 7)
    np.testing.assert_array_equal(got.numpy(), want.transpose(4, 3, 0, 1, 2))


def _jax_detector_variables(cfg, seed):
    """Seeded random values in the shapes of the JAX detector's init."""
    shapes = jax.eval_shape(
        lambda: JaxDetector(cfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, cfg.total_frames, 32, 32, 3)),
            jnp.zeros((1, cfg.max_proposals, cfg.total_frames, 4)),
            jnp.zeros((1, cfg.total_frames, 32, 32, 2)) if cfg.two_stream else None))
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda s: rng.randn(*s.shape).astype(np.float32), shapes)


@pytest.mark.parametrize("preset", ["ucf_3step", "two_stream_train"])
def test_pretrained_detector_variables_equals_the_jax_package(preset, fake, tmp_path):
    path = str(tmp_path / "i3d.pt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in
                               _rekey_piergiaj(fake).items() if isinstance(v, np.ndarray)}},
               path)
    jcfg, cfg = JAX_PRESETS[preset], PRESETS[preset]
    variables = _jax_detector_variables(jcfg, 1)
    want = from_jax_variables(
        jconvert.pretrained_detector_variables(variables, path, jcfg, verbose=False), cfg)
    init = from_jax_variables(variables, cfg)
    got = convert.pretrained_detector_variables(init, path, cfg, verbose=False)
    _assert_same(got, want)
    stem = "Conv3d_1a_7x7.conv3d.weight"
    assert torch.equal(got["features.stem_rgb.Conv3d_1a_7x7.conv.weight"],
                       torch.from_numpy(fake[stem]))
    for s in range(cfg.num_steps):
        assert torch.equal(got[f"steps.{s}.tail.Mixed_5c.b3b.bn.running_var"],
                           torch.from_numpy(fake["Mixed_5c.branch_3.conv3d_0b_1x1.batch3d"
                                                 ".running_var"]))
    assert torch.equal(got["steps.0.cls.weight"], init["steps.0.cls.weight"])
    if cfg.two_stream:
        flow = got["features.stem_flow.Conv3d_1a_7x7.conv.weight"]
        assert flow.shape[1] == 2
        np.testing.assert_allclose(flow.sum(1).numpy(), fake[stem].sum(1), rtol=1e-5,
                                   atol=1e-6)


def test_both_packages_refuse_a_detector_the_checkpoint_cannot_fill(fake, tmp_path):
    path = str(tmp_path / "i3d.pt")
    torch.save({k: torch.from_numpy(v) for k, v in fake.items()}, path)
    over = dict(backbone_depth="tiny", feature_stride=8)
    jcfg = JAX_PRESETS["ucf_3step"].replace(**over)
    cfg = PRESETS["ucf_3step"].replace(**over)
    variables = _jax_detector_variables(jcfg, 2)
    with pytest.raises(AssertionError):
        jconvert.pretrained_detector_variables(variables, path, jcfg, verbose=False)
    with pytest.raises(ValueError, match="does not fit"):
        convert.pretrained_detector_variables(from_jax_variables(variables, cfg), path, cfg,
                                              verbose=False)
    bad = str(tmp_path / "not_i3d.pt")
    torch.save({"model": {"fc.weight": torch.zeros(3, 3)}}, bad)
    with pytest.raises(KeyError, match="unrecognized I3D"):
        convert.pretrained_detector_variables({}, bad, cfg, verbose=False)


@pytest.fixture(scope="module")
def classifier(fake):
    """(JAX classifier variables, the port's state_dict, a clip)."""
    jvars = jconvert.convert_torch_i3d(fake)
    x = np.random.RandomState(5).randn(1, 16, 64, 64, 3).astype(np.float32)
    return jvars, convert.convert_torch_i3d(fake), x


def test_classifier_logits_equal_the_jax_package(classifier):
    jvars, sd, x = classifier
    want = np.asarray(jax.jit(JaxClassifier(num_classes=7).apply)(jvars, jnp.asarray(x)))
    model = I3DClassifier(num_classes=7).eval()
    model.load_state_dict(sd)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 7) and np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    # the kernel configuration (fused_bn_relu, K5 pools), plain versions here
    kmodel = I3DClassifier(num_classes=7, fused_bn_relu=True).eval()
    kmodel.load_state_dict(sd)
    with torch.no_grad():
        kernel = kmodel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(kernel, got, rtol=1e-5, atol=1e-5 * np.abs(got).max())


def test_classifier_trains_with_dropout_from_a_generator(classifier):
    _, sd, x = classifier
    model = I3DClassifier(num_classes=7, dropout_rate=0.5)
    model.load_state_dict(sd)
    clip = torch.from_numpy(x)      # 2x2x2 after MaxPool_5a: batch statistics
    with pytest.raises(ValueError, match="Generator"):
        model(clip, train=True)
    outs = [model(clip, train=True, generator=torch.Generator().manual_seed(1))
            for _ in range(2)]
    assert torch.equal(outs[0], outs[1]) and outs[0].requires_grad
    outs[0].sum().backward()
    assert float(model.stem.Conv3d_1a_7x7.conv.weight.grad.abs().sum()) > 0


@pytest.fixture(scope="module")
def piergiaj(fake, tmp_path_factory):
    """The fake checkpoint in piergiaj's naming with `module.` prefixes, as
    a file that both pretrained starts read."""
    path = str(tmp_path_factory.mktemp("piergiaj") / "i3d.pt")
    torch.save({f"module.{k}": torch.as_tensor(np.asarray(v))
                for k, v in _rekey_piergiaj(fake).items()}, path)
    return path


def test_fit_starts_from_the_pretrained_backbone(fake, piergiaj, tmp_path, capsys):
    from step_tpu_torch.data.loader import DataLoader
    from step_tpu_torch.data.synthetic import SyntheticConfig
    from step_tpu_torch.train import fit as fit_module
    from step_tpu_torch.train_eval_synth import SyntheticClips

    path = piergiaj
    cfg = PRESETS["ucf_3step"].replace(dataset="synthetic", num_classes=4, batch_size=1,
                                       total_steps=2, warmup_steps=1, **SMALL)
    want = convert.convert_torch_i3d(fake, include_logits=False)
    seen = []
    step = fit_module.train_step

    def first_step(state, batch, cfg_):
        if not seen:
            sd = state.model.state_dict()
            seen.append(all(torch.equal(sd[f"features.stem_rgb.{k[5:]}"], v)
                            for k, v in want.items() if k.startswith("stem."))
                        and all(torch.equal(sd[f"steps.0.tail.{k[5:]}"], v)
                                for k, v in want.items() if k.startswith("tail.")))
            seen.append([float(m.abs().max()) for m in state.opt_state["mu"]])
        return step(state, batch, cfg_)

    syn = SyntheticConfig(image_size=32, num_frames=cfg.total_frames, num_classes=4,
                          max_boxes=2)
    loader = DataLoader(SyntheticClips(syn, 2, 0), cfg, seed=0, num_workers=1)
    ckpt = str(tmp_path / "ckpt")
    fit_module.train_step = first_step
    try:
        state = fit_module.fit(cfg, loader, device="cpu", pretrained_i3d=path, ckpt_dir=ckpt)
        out = capsys.readouterr().out
        # a --resume checkpoint wins over the pretrained start
        resumed = []
        fit_module.train_step = lambda st, b, c: (
            resumed.append({k: v.clone() for k, v in st.model.state_dict().items()}),
            step(st, b, c))[1]
        fit_module.fit(cfg.replace(total_steps=3), loader, device="cpu", pretrained_i3d=path,
                       ckpt_dir=ckpt, resume=True, num_epochs=2)
    finally:
        fit_module.train_step = step
    assert "pretrained I3D: scheme='piergiaj'" in out and "missing=0" in out
    assert f"initialized backbone from {path}" in out
    assert seen[0] is True and max(seen[1]) == 0.0
    assert state.step == 2
    sd = state.model.state_dict()
    key = "features.stem_rgb.Mixed_4f.b0.conv.weight"
    moved = sd[key] - want["stem.Mixed_4f.b0.conv.weight"]
    assert float(moved.abs().max()) > 0 and bool(torch.isfinite(moved).all())
    assert len(resumed) == 1 and torch.equal(resumed[0][key], sd[key])


def test_train_cli_pretrained_and_classify_cli(piergiaj, tmp_path, capsys):
    import cv2

    from step_tpu_torch.cli import classify as cli_classify
    from step_tpu_torch.cli import train as cli_train

    path = piergiaj
    over = ("num_classes=4,image_size=32,frames_per_chunk=2,num_steps=1,"
            "iou_thresholds=(0.4,),step_loss_weights=(1.0,),compute_dtype='float32'")
    state = cli_train.main(["--dataset", "synthetic", "--steps", "1", "--epochs", "1",
                            "--batch-size", "1", "--pretrained-i3d", path,
                            "--device", "cpu", "--set", over])
    out = capsys.readouterr().out
    assert "pretrained I3D: scheme='piergiaj'" in out and state.step == 1
    assert "trained to step 1 on cpu" in out

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.RandomState(7)
    for i in range(5):                       # fewer than --num-frames: edge clamp
        cv2.imwrite(str(frames / f"{i:05d}.jpg"),
                    rng.randint(0, 256, (40, 48, 3)).astype(np.uint8))
    labels = tmp_path / "labels.txt"
    labels.write_text("\n".join(f"action_{i}" for i in range(7)) + "\n")
    argv = ["--frames-dir", str(frames), "--num-classes", "7", "--num-frames", "8",
            "--image-size", "32", "--top-k", "3", "--labels", str(labels),
            "--device", "cpu"]
    probs = cli_classify.main(argv + ["--torch-ckpt", path])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(line.split("  ")[1].startswith("action_")
                                   for line in lines)
    assert probs.shape == (7,) and abs(float(probs.sum()) - 1.0) < 1e-5
    top = np.argsort(-probs)[:3]
    assert [line.split("  ")[1] for line in lines] == [f"action_{i}" for i in top]
    # the clip the CLI builds, classified here in float32: bf16 stays close
    args = cli_classify.parse_args(argv + ["--torch-ckpt", path])
    model = cli_classify.load_classifier(args)
    clip = cli_classify.load_frames(args)
    assert clip.shape == (1, 8, 32, 32, 3) and np.array_equal(clip[0, 5], clip[0, 7])
    from step_tpu_torch.preprocess import device_preprocess

    with torch.no_grad():
        ref = torch.softmax(model(device_preprocess(torch.from_numpy(clip))), -1)[0]
    np.testing.assert_allclose(probs, ref.numpy(), atol=0.05)
    # the port's own checkpoint directory gives the same answer
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    torch.save({"step": 0, "model": model.state_dict()}, str(ckpt / "0.pt"))
    again = cli_classify.main(argv + ["--ckpt-dir", str(ckpt)])
    np.testing.assert_array_equal(again, probs)
    with pytest.raises(SystemExit, match="need --torch-ckpt or --ckpt-dir"):
        cli_classify.main(argv)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli_classify.main(argv[:-2] + ["--torch-ckpt", path])
