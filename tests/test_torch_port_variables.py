"""The variables bridge of the port on the CPU, at tiny depth in float32:
the JAX tree both ways (`convert.to_jax_variables`), flax msgpack
variables files (`utils/msgpack_codec.py`), `train_eval_synth`'s
`--save-variables`, `--load-variables` and `--load-ckpt-dir`, and
TensorBoard scalars in training (`train/fit.py::MetricsLogger`).

  * The codec's bytes equal `flax.serialization.msgpack_serialize`'s for a
    detector tree and for a tree of every leaf kind flax writes (bfloat16,
    numpy scalars, int8, empty arrays, Python ints of every width, floats,
    None, lists, long strings); it decodes flax's bytes to what
    `msgpack_restore` gives, bit for bit.
  * `to_jax_variables ∘ from_jax_variables` is the identity on the JAX
    detector's tree, unfolded and BN-folded, and on the JAX
    `I3DClassifier`'s structure; the other way round too, bit for bit.
  * A variables file written by the port and read by flax drives the JAX
    package's `detect_clip` to the port's detections (tubes 1e-3 px, tube
    scores 1e-4, each NMS surface the port's NMS of its tubes and scores).
  * `train_eval_synth --save-variables` then `--load-variables` in a
    second call gives the same held-out frame-mAPs, the file re-read equals
    the trained weights bit for bit, and `--load-ckpt-dir` on a `fit`
    checkpoint of those weights gives them again; `--set two_stream=True`
    and `--same-class-actors` run as the JAX script's.
  * `MetricsLogger(tensorboard=True)` writes `<log_dir>/tb`, read back
    under the JAX package's tags, and imports neither tensorflow nor JAX.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.inference import detect_clip as jax_detect_clip
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.models.i3d import I3DClassifier as JaxClassifier
from step_tpu.models.optimize import optimize_for_inference as jax_optimize
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch import PRESETS
from step_tpu_torch import train_eval_synth
from step_tpu_torch.convert import (from_jax_classifier_variables, from_jax_variables,
                                    to_jax_variables)
from step_tpu_torch.inference import detect_clip, nms_surface
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.models.i3d import I3DClassifier
from step_tpu_torch.utils import msgpack_codec

TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32, frames_per_chunk=2,
            compute_dtype="float32", num_classes=4)


def _flat(tree):
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _same_tree(got, want):
    """Equal keys, and each leaf of the same dtype, shape and bytes."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for key, w in want.items():
        g = got[key]
        if torch.is_tensor(g):                   # the codec's bfloat16
            g = g.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        g, w = np.asarray(g), np.asarray(w)
        assert (g.dtype, g.shape) == (w.dtype, w.shape) and g.tobytes() == w.tobytes(), key


@pytest.fixture(scope="module")
def jax_variables():
    cfg = JAX_PRESETS["ucf_3step"].replace(**TINY)
    return cfg, jax.tree.map(np.asarray, init_detector_cpu(cfg, jax.random.PRNGKey(0)))


def _every_kind():
    rng = np.random.RandomState(0)
    return {"b": {"z": rng.randn(3, 4).astype(np.float32), "a": np.arange(5, dtype=np.int32)},
            "a": {"scalar": np.float32(3.5), "big": rng.randn(70_000).astype(np.float32),
                  "empty": np.zeros((0, 3), np.float32),
                  "bf16": rng.randn(4, 5).astype(ml_dtypes.bfloat16),
                  "i8": rng.randint(-128, 127, (300,)).astype(np.int8),
                  "u8": rng.randint(0, 255, (2, 70)).astype(np.uint8),
                  "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, -1, -32, -33,
                           -128, -129, -32768, -32769, -2 ** 31 - 1],
                  "f": 1.25, "t": True, "none": None, "s": "x" * 40, "long": "y" * 300}}


@pytest.mark.parametrize("kind", ["detector", "every_kind"])
def test_codec_bytes_equal_flax(kind, jax_variables):
    tree = jax_variables[1] if kind == "detector" else _every_kind()
    want = serialization.msgpack_serialize(tree)
    assert msgpack_codec.packb(tree) == want
    _same_tree(msgpack_codec.unpackb(want), serialization.msgpack_restore(want))


def test_codec_writes_the_ports_tree_as_flax_does(jax_variables, tmp_path):
    """The port's state_dict through `to_jax_variables` and the codec: the
    bytes flax writes for the JAX tree of the same weights, and read back
    equal to the weights."""
    jcfg, variables = jax_variables
    cfg = PRESETS["ucf_3step"].replace(**TINY)
    sd = from_jax_variables(variables, cfg)
    path = tmp_path / "v.msgpack"
    msgpack_codec.write_variables(path, to_jax_variables(sd, cfg))
    assert path.read_bytes() == serialization.msgpack_serialize(variables)
    back = from_jax_variables(msgpack_codec.read_variables(path), cfg)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


@pytest.mark.parametrize("folded", [False, True])
def test_to_jax_variables_inverts_from_jax_variables(folded, jax_variables):
    jcfg, variables = jax_variables
    if folded:
        jcfg, variables = jax_optimize(jcfg, variables)
        variables = jax.tree.map(np.asarray, variables)
    cfg = PRESETS["ucf_3step"].replace(**{f: getattr(jcfg, f) for f in (
        *TINY, "bn_folded", "fused_inception", "fused_inception3")})
    sd = from_jax_variables(variables, cfg)
    assert not STEPDetector(cfg).load_state_dict(sd).missing_keys
    _same_tree(to_jax_variables(sd, cfg), variables)
    back = from_jax_variables(to_jax_variables(sd, cfg), cfg)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)


def test_classifier_tree_round_trips():
    """The port's `I3DClassifier` state_dict → a tree of the JAX
    classifier's structure (names and shapes, from `jax.eval_shape` of its
    init) → the state_dict again, bit for bit; and the tree back."""
    torch.manual_seed(0)
    sd = I3DClassifier(num_classes=7).state_dict()
    for v in sd.values():
        v.copy_(torch.randn_like(v))
    tree = to_jax_variables(sd)
    shapes = jax.eval_shape(JaxClassifier(num_classes=7).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 64, 64, 3)))
    want = {k: v.shape for k, v in _flat(shapes).items()}
    assert {k: v.shape for k, v in _flat(tree).items()} == want
    back = from_jax_classifier_variables(tree)
    assert back.keys() == sd.keys() and all(torch.equal(back[k], sd[k]) for k in sd)
    _same_tree(to_jax_variables(back), tree)


def test_ports_variables_file_drives_the_jax_detector(tmp_path):
    from step_tpu_torch.utils.init import init_detector_

    cfg = PRESETS["ucf_3step"].replace(**TINY)
    jcfg = JAX_PRESETS["ucf_3step"].replace(**TINY)
    model = init_detector_(STEPDetector(cfg), seed=3).eval()
    path = tmp_path / "v.msgpack"
    msgpack_codec.write_variables(path, to_jax_variables(model.state_dict(), cfg))
    variables = serialization.msgpack_restore(path.read_bytes())
    rng = np.random.RandomState(4)
    rgb = rng.randint(0, 256, (2, cfg.total_frames, 32, 32, 3)).astype(np.uint8)
    props, mask = STEPDetector.initial_proposals(cfg, 2, device="cpu")
    want = jax.jit(lambda v, r, p, m: jax_detect_clip(v, r, p, m, jcfg, JaxDetector(jcfg)))(
        variables, jnp.asarray(rgb), jnp.asarray(props.numpy()), jnp.asarray(mask.numpy()))
    got = detect_clip(model, torch.from_numpy(rgb), props, mask)
    np.testing.assert_allclose(got["tubes"].numpy(), np.asarray(want["tubes"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["tube_scores"].numpy(), np.asarray(want["tube_scores"]),
                               rtol=0, atol=1e-4)
    theirs = nms_surface(torch.from_numpy(np.array(want["tubes"])),
                         torch.from_numpy(np.array(want["tube_scores"])), mask, cfg)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        np.testing.assert_array_equal(theirs[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert float(got["frame_mask"].sum()) > 0


SYNTH = ["--steps", "2", "--batch", "2", "--image-size", "32", "--classes", "2",
         "--eval-clips", "4", "--eval-batch", "2", "--device", "cpu", "--tag", "tiny",
         "--set", "backbone_depth=tiny,feature_stride=8,frames_per_chunk=2,"
                  "score_thresh=0.0,warmup_steps=1"]
MAPS = ("frame_mAP@0.5", "frame_mAP@0.2")


def test_train_eval_synth_saves_and_loads(tmp_path, capsys):
    from step_tpu_torch.train.trainer import create_train_state
    from step_tpu_torch.utils.checkpoint import save_checkpoint

    path = str(tmp_path / "v.msgpack")
    trained = train_eval_synth.main([*SYNTH, "--save-variables", path])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == trained
    assert trained["tag"] == "tiny" and trained["overrides"] == SYNTH[-1]
    assert len(trained["loss_curve"]) == 2 and trained["train_s"] > 0
    loaded = train_eval_synth.main([*SYNTH, "--load-variables", path])
    assert loaded["loss_curve"] == [] and loaded["train_s"] == 0.0
    assert all(loaded[k] == trained[k] for k in MAPS)

    # the file holds the trained weights: flax reads it, and a checkpoint
    # of those weights restored in a fresh call gives the same evaluation
    args = train_eval_synth.parse_args(SYNTH)
    cfg = train_eval_synth.synth_config(args)
    assert cfg.backbone_depth == "tiny" and cfg.score_thresh == 0.0
    variables = msgpack_codec.read_variables(path)
    _same_tree(variables, serialization.msgpack_restore(open(path, "rb").read()))
    state = create_train_state(cfg, 0, model=STEPDetector(cfg), device="cpu")
    state.model.load_state_dict(from_jax_variables(variables, cfg))
    state.step = 2
    save_checkpoint(str(tmp_path / "ckpt"), state)
    restored = train_eval_synth.main([*SYNTH, "--load-ckpt-dir", str(tmp_path / "ckpt")])
    assert "restored step 2" in capsys.readouterr().out
    assert all(restored[k] == trained[k] for k in MAPS)


def test_train_eval_synth_takes_the_jax_scripts_other_flags(capsys):
    """`--set two_stream=True` trains and evaluates with each clip's flow
    (and the video evaluation with its windows' flow), and
    `--same-class-actors` gives scenes whose actors share one class."""
    from step_tpu_torch.data.synthetic import make_batch

    argv = [a if not a.startswith("backbone_depth") else a + ",two_stream=True"
            for a in SYNTH] + ["--same-class-actors", "--video-eval", "1"]
    record = train_eval_synth.main(argv)
    assert record["overrides"].endswith("two_stream=True")
    assert {"video_mAP@0.2_host", "video_mAP@0.5_device"} <= set(record)
    args = train_eval_synth.parse_args(argv)
    cfg = train_eval_synth.synth_config(args)
    raw = make_batch(0, 8, train_eval_synth.synth_data(cfg, args))
    assert cfg.two_stream and (raw["gt_mask"] > 0).all()
    assert all(len(set(labels)) == 1 for labels in raw["gt_labels"])


def test_metrics_logger_writes_tensorboard_scalars(tmp_path):
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from step_tpu_torch.train.fit import MetricsLogger

    logger = MetricsLogger(str(tmp_path), tensorboard=True)
    assert logger.tb is not None
    for step in (1, 2):
        logger.log(step, {"loss": torch.tensor(0.5 * step),
                          "cls_loss_per_step": torch.tensor([0.25, 0.125 * step])},
                   {"epoch": 0, "clips_per_sec": 3.0})
    logger.close()
    events = EventAccumulator(str(tmp_path / "tb"))
    events.Reload()
    tags = set(events.Tags()["scalars"])
    assert {"loss", "cls_loss_per_step/0", "cls_loss_per_step/1", "clips_per_sec"} <= tags
    assert "epoch" not in tags                  # an int, as the JAX package skips it
    assert [(e.step, e.value) for e in events.Scalars("loss")] == [(1, 0.5), (2, 1.0)]
    assert [e.value for e in events.Scalars("cls_loss_per_step/1")] == [0.125, 0.25]
    assert MetricsLogger(str(tmp_path / "off"), tensorboard=False).tb is None


def test_tensorboard_writer_imports_no_tensorflow(tmp_path):
    """`torch.utils.tensorboard` imports tensorflow where it is installed,
    and tensorflow imports JAX: the port's writer goes without both."""
    pytest.importorskip("tensorboard")
    code = (f"import sys; from step_tpu_torch.train.fit import MetricsLogger; "
            f"m = MetricsLogger({str(tmp_path)!r}); m.log(1, {{'loss': 1.0}}); m.close(); "
            f"assert m.tb is not None; "
            f"bad = [k for k in sys.modules if k.split('.')[0] in ('tensorflow', 'jax')]; "
            f"assert not bad, bad[:5]")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr[-2000:]
