"""The port's two-stream paths against the JAX package's, on the CPU: flow
preprocessing, the two-stream `FeatureNet` (conv fusion), the
`two_stream_train` and flow-input detectors, late fusion, the video paths
with a second stream, `optimize_for_inference` on the two-stream tree,
the bridge on full-depth trees, the training init and `train_step` with
flow, and the UCF evaluation with a flow model.

Tiny detectors (depth "tiny", 32 px, 2-frame chunks, float32) with the
JAX package's weights bridged by `from_jax_variables`, inputs from numpy
seeds. Tolerances as `tests/test_torch_port_detect.py` states them: 1e-4
on logits, deltas, features and scores, 1e-3 px on tubes, NMS surfaces
exact on the JAX package's own tubes and scores; `train_step` as
`tests/test_torch_port_train_step.py` states it for SGD with dropout 0;
evaluation as `tests/test_torch_port_eval.py` states it (scores 1e-5,
boxes 1e-4 px, mAPs 1e-6). Preprocessing and the bridge are exact.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from step_tpu import evaluate as jev
from step_tpu import inference as jinf
from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.config import StepConfig as JaxStepConfig
from step_tpu.data.pipeline import build_model_batch
from step_tpu.data.synthetic import SyntheticConfig, make_batch, make_flow
from step_tpu.data.ucf import UCFDataset as JaxUCFDataset
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.models.i3d import Unit3D as JaxUnit3D
from step_tpu.models.nets import FeatureNet as JaxFeatureNet
from step_tpu.models.optimize import optimize_for_inference as jax_optimize
from step_tpu.preprocess import device_preprocess_flow as jax_preprocess_flow
from step_tpu.train.trainer import TrainState as JaxTrainState
from step_tpu.train.trainer import make_optimizer as jax_make_optimizer
from step_tpu.train.trainer import train_step as jax_train_step
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch import PRESETS
from step_tpu_torch import evaluate as tev
from step_tpu_torch import inference as tinf
from step_tpu_torch.config import StepConfig
from step_tpu_torch.convert import from_jax_variables
from step_tpu_torch.data.ucf import UCFDataset
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.models.i3d import Unit3D
from step_tpu_torch.models.nets import FeatureNet
from step_tpu_torch.models.optimize import optimize_for_inference
from step_tpu_torch.preprocess import device_preprocess_flow
from step_tpu_torch.train.trainer import batch_to_device, create_train_state, train_step
from step_tpu_torch.utils.init import init_detector_train_
from tests.test_data import _write_jpg
from tests.test_torch_port_detect import _randomize

TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32, frames_per_chunk=2,
            compute_dtype="float32", score_thresh=0.0)
B, S = 2, 32
SCORE_TOL, TUBE_TOL = 1e-4, 1e-3


def _cfgs(name, **over):
    """(JAX config, port config) of preset `name` at the tiny size."""
    return (JAX_PRESETS[name].replace(**TINY, **over),
            PRESETS[name].replace(**TINY, **over))


def _bridged(jcfg, cfg, seed):
    """(JAX variables off the identity, the port's model on the same)."""
    variables = _randomize(init_detector_cpu(jcfg, jax.random.PRNGKey(seed)), seed + 1)
    model = STEPDetector(cfg).eval()
    model.load_state_dict(from_jax_variables(variables, cfg))
    return variables, model


@pytest.fixture(scope="module")
def streams():
    """uint8 RGB `[B, 6, 32, 32, 3]` and int8 flow `[B, 6, 32, 32, 2]` (the
    wire's codes, -127..127) from one seed."""
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, (B, 6, S, S, 3)).astype(np.uint8)
    flow = rng.randint(-127, 128, (B, 6, S, S, 2)).astype(np.int8)
    return rgb, flow


@pytest.fixture(scope="module")
def two_stream():
    jcfg, cfg = _cfgs("two_stream_train")
    return (jcfg, cfg) + _bridged(jcfg, cfg, 0)


@pytest.fixture(scope="module")
def flow_stream():
    jcfg, cfg = _cfgs("ucf_3step", input_stream="flow", late_fusion_weight=0.7)
    return (jcfg, cfg) + _bridged(jcfg, cfg, 2)


@pytest.fixture(scope="module")
def rgb_stream():
    jcfg, cfg = _cfgs("ucf_3step", late_fusion_weight=0.7)
    return (jcfg, cfg) + _bridged(jcfg, cfg, 4)


def _props(cfg, b=B):
    props, pmask = STEPDetector.initial_proposals(cfg, b, device="cpu")
    return props.contiguous(), pmask.contiguous()


def _assert_surface(got, want, cfg, pmask):
    """tubes and scores within tolerance; the NMS surface exact on the JAX
    package's own tubes and scores."""
    np.testing.assert_allclose(got["tubes"].numpy(), np.asarray(want["tubes"]),
                               rtol=0, atol=TUBE_TOL)
    np.testing.assert_allclose(got["tube_scores"].numpy(), np.asarray(want["tube_scores"]),
                               rtol=0, atol=SCORE_TOL)
    surface = tinf.nms_surface(torch.tensor(np.asarray(want["tubes"])),
                               torch.tensor(np.asarray(want["tube_scores"])), pmask, cfg)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        np.testing.assert_array_equal(surface[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert float(surface["frame_mask"].sum()) > 0


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_device_preprocess_flow_equals_the_jax_package(dtype, streams):
    flow = streams[1]
    if dtype == "float32":
        flow = np.random.RandomState(1).uniform(-1, 1, flow.shape).astype(np.float32)
    got = device_preprocess_flow(torch.from_numpy(flow))
    want = np.asarray(jax_preprocess_flow(jnp.asarray(flow)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == "int8":       # the wire divides by 127, not 127.5
        assert float(got.abs().max()) == 1.0


@pytest.mark.parametrize("chunk_stem", [False, True])
def test_two_stream_feature_net_matches_jax(chunk_stem):
    rng = np.random.RandomState(3)
    rgb = rng.randn(B, 6, S, S, 3).astype(np.float32)
    flow = rng.uniform(-1, 1, (B, 6, S, S, 2)).astype(np.float32)
    net = JaxFeatureNet(two_stream=True, depth="tiny", chunk_stem=chunk_stem, num_chunks=3)
    variables = _randomize(jax.jit(net.init)(jax.random.PRNGKey(5), jnp.asarray(rgb),
                                             jnp.asarray(flow)), 6)
    assert set(variables["params"]) == {"stem_rgb", "stem_flow", "fusion"}
    assert variables["params"]["fusion"]["conv"]["kernel"].shape == (1, 1, 1, 256, 832)
    want = np.asarray(jax.jit(net.apply)(variables, jnp.asarray(rgb), jnp.asarray(flow)))
    port = FeatureNet("tiny", chunk_stem=chunk_stem, num_chunks=3, two_stream=True).eval()
    port.load_state_dict(from_jax_variables(variables, JaxStepConfig()))
    assert port.out_channels == 832
    with torch.no_grad():
        got = port(torch.from_numpy(rgb), flow=torch.from_numpy(flow)).numpy()
    assert got.shape == want.shape == (B, 3 if chunk_stem else 2, 4, 4, 832)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="requires a flow input"):
        port(torch.from_numpy(rgb))


def test_two_stream_detector_every_step_matches_jax(two_stream, streams):
    jcfg, cfg, variables, model = two_stream
    rgb, flow = streams
    props, _ = _props(cfg)
    want = jax.jit(JaxDetector(jcfg).apply)(variables, jnp.asarray(rgb),
                                            jnp.asarray(props.numpy()), jnp.asarray(flow))
    with torch.no_grad():
        got = model(torch.from_numpy(rgb), props, torch.from_numpy(flow))
    assert got["cls_logits"].shape == (cfg.num_steps, B, cfg.max_proposals, 25)
    for key, tol in (("cls_logits", SCORE_TOL), ("deltas", SCORE_TOL), ("tubes", TUBE_TOL)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=tol, err_msg=key)
    # the flow stream moves the logits: with the flow swapped for zeros
    # they differ, so the fusion is not reading only the RGB half
    with torch.no_grad():
        zero = model(torch.from_numpy(rgb), props, torch.zeros(flow.shape, dtype=torch.int8))
    assert float((zero["cls_logits"] - got["cls_logits"]).abs().max()) > 1e-3


@pytest.mark.parametrize("which", ["two_stream", "flow_stream"])
def test_detect_clip_matches_jax(which, two_stream, flow_stream, streams):
    jcfg, cfg, variables, model = two_stream if which == "two_stream" else flow_stream
    rgb, flow = streams
    props, pmask = _props(cfg)
    if which == "two_stream":
        primary, second = rgb, flow
    else:
        primary, second = flow, None
    detect = jax.jit(lambda v, x, p, m, f: jinf.detect_clip(v, x, p, m, jcfg, flow=f))
    want = detect(variables, jnp.asarray(primary), jnp.asarray(props.numpy()),
                  jnp.asarray(pmask.numpy()), None if second is None else jnp.asarray(second))
    got = tinf.detect_clip(model, torch.from_numpy(primary), props, pmask,
                           None if second is None else torch.from_numpy(second))
    assert got.keys() == want.keys()
    _assert_surface(got, want, cfg, pmask)


def test_detect_clip_late_fusion_matches_jax(rgb_stream, flow_stream, streams):
    jcfg, cfg, v_rgb, m_rgb = rgb_stream
    _, _, v_flow, m_flow = flow_stream
    rgb, flow = streams
    props, pmask = _props(cfg)
    fused = jax.jit(lambda a, b, x, f, p, m: jinf.detect_clip_late_fusion(
        a, b, x, f, p, m, jcfg))
    want = fused(v_rgb, v_flow, jnp.asarray(rgb), jnp.asarray(flow),
                 jnp.asarray(props.numpy()), jnp.asarray(pmask.numpy()))
    got = tinf.detect_clip_late_fusion(m_rgb, m_flow, torch.from_numpy(rgb),
                                       torch.from_numpy(flow), props, pmask)
    _assert_surface(got, want, cfg, pmask)
    # w * p_rgb + (1 - w) * p_flow on the RGB stream's boxes
    one = tinf.detect_clip(m_rgb, torch.from_numpy(rgb), props, pmask)
    other = tinf.detect_clip(m_flow, torch.from_numpy(flow), props, pmask)
    np.testing.assert_allclose(got["tube_scores"].numpy(),
                               (0.7 * one["tube_scores"] + 0.3 * other["tube_scores"]).numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(got["tubes"], one["tubes"])
    with pytest.raises(ValueError, match="flow-stream detector"):
        tinf.detect_clip_late_fusion(m_flow, m_rgb, torch.from_numpy(flow),
                                     torch.from_numpy(rgb), props, pmask)


def test_two_stream_video_paths_match_jax(streams):
    """`detect_video` and `detect_video_stream_batched` with a second stream
    (the two-stream chunk-stem detector) against the JAX package's."""
    jcfg, cfg = _cfgs("two_stream_train", chunk_stem=True, num_steps=1,
                      iou_thresholds=(0.4,), step_loss_weights=(1.0,))
    variables, model = _bridged(jcfg, cfg, 8)
    rng = np.random.RandomState(9)
    n = 3                                   # chunks of the video
    frames = rng.rand(n * 2, S, S, 3).astype(np.float32)
    flow = rng.uniform(-1, 1, (n * 2, S, S, 2)).astype(np.float32)
    got = tinf.detect_video_stream_batched(model, torch.from_numpy(frames), clip_batch=n,
                                           flow=torch.from_numpy(flow))
    want = jinf.detect_video_stream_batched(variables, jnp.asarray(frames), jcfg,
                                            flow=jnp.asarray(flow), clip_batch=n)
    for key, tol in (("tubes", TUBE_TOL), ("tube_scores", SCORE_TOL)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=tol, err_msg=f"stream batched {key}")
    # the windows as clips, through detect_video
    centers = tinf.window_centers(n, cfg).numpy()
    clips = np.stack([np.concatenate([frames[i * 2:(i + 1) * 2] for i in ids])
                      for ids in centers])
    fclips = np.stack([np.concatenate([flow[i * 2:(i + 1) * 2] for i in ids])
                       for ids in centers])
    got_v = tinf.detect_video(model, torch.from_numpy(clips), tiling_stride=2,
                              flow=torch.from_numpy(fclips))
    want_v = jinf.make_detect_video_fn(jcfg)(variables, jnp.asarray(clips),
                                             flow=jnp.asarray(fclips), tiling_stride=2)
    for key, tol in (("tubes", TUBE_TOL), ("tube_scores", SCORE_TOL)):
        np.testing.assert_allclose(got_v[key].numpy(), np.asarray(want_v[key]), rtol=0,
                                   atol=tol, err_msg=f"detect_video {key}")
        # the cache serves the same windows as the clips
        np.testing.assert_allclose(got_v[key].numpy(), got[key].numpy(), rtol=0,
                                   atol=1e-5, err_msg=f"cache vs clips {key}")
    assert got_v["link_paths"].shape == (cfg.num_classes, cfg.link_tubes_per_class, n)


def test_optimize_for_inference_on_the_two_stream_tree(two_stream, streams):
    """The BN folding reaches `stem_flow` and `fusion`: the folded state
    equals the bridge of the JAX package's folded tree, and the folded
    detector matches the JAX package's folded detector."""
    jcfg, cfg, variables, model = two_stream
    rgb, flow = streams
    cfg_f, folded = optimize_for_inference(cfg, model.state_dict())
    jcfg_f, jfolded = jax_optimize(jcfg, variables)
    want_sd = from_jax_variables(jfolded, cfg_f)
    assert sorted(folded) == sorted(want_sd)
    assert "features.fusion.conv.bias" in folded
    assert any(k.startswith("features.stem_flow.Mixed_4f.b012.") for k in folded)
    for key, value in want_sd.items():
        np.testing.assert_allclose(folded[key].numpy(), value.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    served = STEPDetector(cfg_f).eval()
    served.load_state_dict(folded)
    props, pmask = _props(cfg)
    want = jax.jit(JaxDetector(jcfg_f).apply)(jfolded, jnp.asarray(rgb),
                                              jnp.asarray(props.numpy()), jnp.asarray(flow))
    with torch.no_grad():
        got = served(torch.from_numpy(rgb), props, torch.from_numpy(flow))
    for key, tol in (("cls_logits", SCORE_TOL), ("tubes", TUBE_TOL)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=tol, err_msg=key)


def _zeros_tree(jcfg):
    """The JAX detector's variables at full size, as zeros (shapes from
    `jax.eval_shape`: nothing is computed)."""
    T, s = jcfg.total_frames, jcfg.image_size
    cin = 3 if jcfg.input_stream == "rgb" else 2
    spec = lambda *shape: jax.ShapeDtypeStruct(shape, jnp.float32)  # noqa: E731
    shapes = jax.eval_shape(JaxDetector(jcfg).init, jax.random.PRNGKey(0),
                            spec(1, T, s, s, cin), spec(1, jcfg.max_proposals, T, 4),
                            spec(1, T, s, s, 2) if jcfg.two_stream else None)
    return jax.tree.map(lambda x: np.zeros(x.shape, np.float32), shapes)


@pytest.mark.parametrize("name,over,folded", [
    ("two_stream_train", {}, False),
    ("two_stream_train", {}, True),
    ("ucf_3step", {"input_stream": "flow"}, False),
    ("ava_3step", {}, False),
    ("pr1_ref", {}, False),
])
def test_bridge_maps_every_leaf_of_full_depth_trees(name, over, folded):
    jcfg, cfg = JAX_PRESETS[name].replace(**over), PRESETS[name].replace(**over)
    variables = _zeros_tree(jcfg)
    if folded:
        jcfg, variables = jax_optimize(jcfg, variables)
        cfg = cfg.replace(bn_folded=True, fused_inception=True, scan_unroll=True)
    leaves = jax.tree.leaves(variables)
    sd = from_jax_variables(variables, cfg)
    per_step = sum(x.size for x in jax.tree.leaves(variables["params"].get("steps", {})))
    per_step += sum(x.size for x in jax.tree.leaves(variables.get("batch_stats", {})
                                                    .get("steps", {})))
    assert sum(v.numel() for v in sd.values()) == sum(x.size for x in leaves)
    assert sum(v.numel() for k, v in sd.items() if k.startswith("steps.")) == per_step
    model = STEPDetector(cfg)
    model.load_state_dict(sd, strict=True)     # every parameter and buffer, every shape
    if cfg.two_stream:
        assert model.features.fusion.conv.weight.shape == (832, 1664, 1, 1, 1)
        assert model.features.stem_flow.Conv3d_1a_7x7.conv.weight.shape[1] == 2
    if cfg.input_stream == "flow":
        assert model.features.stem_rgb.Conv3d_1a_7x7.conv.weight.shape[1] == 2
    if cfg.multilabel:
        assert model.steps[0].cls.weight.shape[0] == 60 and model.context is not None


def test_bridge_keeps_the_fusion_channel_order():
    """The fusion kernel `[1, 1, 1, 2C, 832]` goes to `[832, 2C, 1, 1, 1]`
    with input channel i kept as i: RGB features first, then flow."""
    jcfg, cfg = _cfgs("two_stream_train")
    variables = _zeros_tree(jcfg)
    kernel = np.arange(256 * 832, dtype=np.float32).reshape(1, 1, 1, 256, 832)
    variables["params"]["features"]["fusion"]["conv"]["kernel"] = kernel
    w = from_jax_variables(variables, cfg)["features.fusion.conv.weight"]
    assert w.shape == (832, 256, 1, 1, 1)
    assert torch.equal(w[:, :, 0, 0, 0], torch.from_numpy(kernel[0, 0, 0].T))


def assert_training_init_matches(jcfg, cfg, variables):
    """The training init (`utils/init.py`, after `step_tpu/utils/init.py:
    30-41`) draws every parameter the JAX package's init has, in the same
    shapes, and the class bias the JAX package's (logit(cls_prior) for a
    multilabel head, `step_tpu/models/detector.py:121-124`; else 0)."""
    model = init_detector_train_(STEPDetector(cfg), cfg, seed=0)
    sd = model.state_dict()
    ref = from_jax_variables(variables, cfg)
    assert sorted(sd) == sorted(ref)
    assert all(sd[k].shape == ref[k].shape for k in ref)
    bias = [k for k in ref if k.endswith(".cls.bias")]
    assert len(bias) == cfg.num_steps
    for k in bias:
        np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(), rtol=1e-6, atol=0)
    if cfg.multilabel:
        assert float(sd[bias[0]][0]) == pytest.approx(np.log(0.01 / 0.99), rel=1e-6)
    return sd


@pytest.mark.parametrize("which", ["two_stream", "flow_stream"])
def test_training_init_builds_the_streams(which, request):
    jcfg, cfg, variables, _ = request.getfixturevalue(which)
    sd = assert_training_init_matches(jcfg, cfg, variables)
    if cfg.two_stream:
        assert float(sd["features.fusion.bn.running_var"].min()) == 1.0
        assert sd["features.stem_flow.Conv3d_1a_7x7.conv.weight"].shape[1] == 2
    else:
        assert sd["features.stem_rgb.Conv3d_1a_7x7.conv.weight"].shape[1] == 2


def _raw_batch(cfg, seed, multilabel=False):
    syn = SyntheticConfig(image_size=S, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=2)
    raw = make_batch(seed, 2, syn)
    raw["flow"] = np.stack([make_flow(c) for c in raw["rgb"]])
    if multilabel:          # AVA's multi-hot labels: a second action on each actor
        labels = np.zeros((*raw["gt_labels"].shape, cfg.num_classes), np.float32)
        for b, g in np.ndindex(*raw["gt_labels"].shape):
            labels[b, g, raw["gt_labels"][b, g]] = 1.0
            labels[b, g, (raw["gt_labels"][b, g] * 7 + 3) % cfg.num_classes] = 1.0
        raw["gt_labels"] = labels
    return raw


def run_train_steps(name, over, steps=2, multilabel=False):
    """Two SGD steps (dropout 0) of both packages from the same weights on
    the same batch → (cfg, the initial state_dict, the JAX package's
    after, the port's after, per step (JAX metrics, port metrics))."""
    fields = dict(TINY, batch_size=2, warmup_steps=2, total_steps=50, max_gt_tubes=2,
                  dropout_rate=0.0, optimizer="sgd", num_steps=2, iou_thresholds=(0.4, 0.5),
                  step_loss_weights=(1.0, 1.0), remat_steps=False, **over)
    jcfg, cfg = JAX_PRESETS[name].replace(**fields), PRESETS[name].replace(**fields)
    variables = init_detector_cpu(jcfg, jax.random.PRNGKey(0), JaxDetector(jcfg))
    batch = build_model_batch(_raw_batch(jcfg, 0, multilabel), jcfg, train=True)
    batch = {k: v for k, v in batch.items() if k != "meta"}
    tx = jax_make_optimizer(jcfg)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jmodel = JaxDetector(jcfg)
    jstep = jax.jit(lambda s, b, r: jax_train_step(s, b, r, jcfg, jmodel))
    model = STEPDetector(cfg)
    initial = from_jax_variables(variables, cfg)
    model.load_state_dict(initial)
    state = create_train_state(cfg, model=model, device="cpu")
    tbatch = batch_to_device(batch, "cpu")
    assert "flow" in tbatch
    metrics = []
    for _ in range(steps):
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(1))
        state, m = train_step(state, tbatch, cfg)
        metrics.append(({k: np.asarray(v) for k, v in jm.items()},
                        {k: v.numpy() for k, v in m.items()}))
    after = from_jax_variables({"params": jstate.params,
                                "batch_stats": jstate.batch_stats}, cfg)
    return cfg, initial, after, state.model.state_dict(), metrics


def assert_train_steps_match(result):
    """`tests/test_torch_port_train_step.py`'s tolerances for SGD."""
    cfg, initial, want, got, metrics = result
    for jm, tm in metrics:
        for key in ("loss", "cls_loss_per_step", "reg_loss_per_step"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, atol=1e-6, err_msg=key)
        np.testing.assert_array_equal(tm["num_positive_per_step"],
                                      jm["num_positive_per_step"])
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
    for key, w in want.items():
        if "running_" in key:
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0, atol=5e-5,
                                       err_msg=key)
            assert not torch.equal(w, initial[key]), f"{key} was not updated"
        else:
            np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0, atol=1e-6,
                                       err_msg=key)
    moved = [k for k in want if "running_" not in k and not torch.equal(want[k], initial[k])]
    assert any(k.startswith("features.stem_rgb.") for k in moved)
    return moved


@pytest.mark.parametrize("name,over", [("two_stream_train", {}),
                                       ("ucf_3step", {"input_stream": "flow"})])
def test_train_step_with_flow_matches_jax(name, over):
    moved = assert_train_steps_match(run_train_steps(name, over))
    if name == "two_stream_train":
        assert any(k.startswith("features.stem_flow.") for k in moved)
        assert any(k.startswith("features.fusion.") for k in moved)


def test_train_step_needs_flow_for_a_flow_detector():
    cfg = PRESETS["ucf_3step"].replace(**TINY, input_stream="flow", batch_size=2)
    state = create_train_state(cfg, device="cpu")
    batch = build_model_batch(_raw_batch(cfg, 0), cfg, train=True)
    batch = batch_to_device({k: v for k, v in batch.items() if k != "flow"}, "cpu")
    with pytest.raises(ValueError, match="flow-enabled dataset"):
        train_step(state, batch, cfg)


def test_fusion_unit_in_bfloat16_rounds_where_flax_does():
    """The fusion unit (1x1x1 conv to 832, BN, ReLU) in bf16: flax's
    BatchNorm(dtype=bfloat16) computes in float32 and rounds once, as
    `BatchNorm` does; at most 0.1% of the outputs may differ, by one bf16
    step, as `test_bfloat16_batchnorm_rounds_where_flax_does` holds the
    stem's units."""
    rng = np.random.RandomState(11)
    x = jnp.asarray(rng.randn(2, 3, 4, 4, 256), jnp.bfloat16)
    unit = JaxUnit3D(832, (1, 1, 1), dtype=jnp.bfloat16)
    variables = _randomize(unit.init(jax.random.PRNGKey(0), x), 12)
    want = np.asarray(unit.apply(variables, x).astype(jnp.float32))
    port = Unit3D(256, 832, (1, 1, 1)).eval()
    port.load_state_dict(from_jax_variables(variables, JaxStepConfig()))
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = port(xt.permute(0, 4, 1, 2, 3))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 4, 1).numpy()
    diff = np.abs(got - want)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(abs(got), abs(want)),
                                               1e-30))) - 7)
    assert (diff > 0).mean() <= 1e-3, f"{(diff > 0).mean():.2%} of outputs differ"
    assert bool((diff <= step).all()), float(diff.max())


# ---- the UCF evaluation with a flow model ---------------------------------

FIELDS = dict(
    dataset="ucf101_24", num_classes=3, frames_per_chunk=2, num_chunks=3,
    num_steps=2, iou_thresholds=(0.4, 0.5), step_loss_weights=(1.0, 1.0),
    temporal_extension=True, image_size=32, backbone_depth="tiny",
    feature_stride=8, pooled_size=4, max_proposals=12, max_detections=4,
    compute_dtype="float32", max_gt_tubes=2, score_thresh=0.0, late_fusion_weight=0.6,
)
MAPS = ("frame_mAP@0.5", "video_mAP@0.2", "video_mAP@0.5", "video_mAP@0.5:0.95")


@pytest.fixture(scope="module")
def flow_layout(tmp_path_factory):
    """A mini UCF101-24 layout with `brox-images` (flow unlike the RGB)."""
    root = str(tmp_path_factory.mktemp("ucf_flow"))
    rng = np.random.RandomState(6)
    H, W = 40, 48
    nframes = {"Run/v1": 8, "Jump/v2": 7}
    gttubes = {}
    for video, n in nframes.items():
        for f in range(n):
            img = rng.rand(H, W, 3) * 0.3
            img[8 + f:26 + f, 12:32] = 0.9
            _write_jpg(os.path.join(root, "rgb-images", video, f"{f + 1:05d}.jpg"), img)
            _write_jpg(os.path.join(root, "brox-images", video, f"{f + 1:05d}.jpg"),
                       rng.rand(H, W, 3))
        frames = np.arange(1, n + 1, dtype=np.float32)
        tube = np.stack([frames, np.full_like(frames, 12), 8 + frames - 1,
                         np.full_like(frames, 32), 26 + frames - 1], axis=1)
        gttubes[video] = {int(video.startswith("Jump")): [tube]}
    gt = {"labels": ["Run", "Jump", "Wave"], "train_videos": [list(nframes)],
          "test_videos": [list(nframes)], "nframes": nframes, "gttubes": gttubes,
          "resolution": {v: (H, W) for v in nframes}}
    with open(os.path.join(root, "UCF101v2-GT.pkl"), "wb") as f:
        pickle.dump(gt, f)
    return root


def _eval_models(kind):
    """(JAX config, JAX variables, JAX variables_flow, port config, port
    model, port model_flow) for `kind`: late fusion, two-stream or a
    flow-stream detector alone."""
    over = {"two_stream": kind == "two_stream",
            "input_stream": "flow" if kind == "flow_stream" else "rgb"}
    jcfg, cfg = JaxStepConfig(**FIELDS, **over), StepConfig(**FIELDS, **over)
    variables, model = _bridged(jcfg, cfg, 20)
    if kind != "late_fusion":
        return jcfg, variables, None, cfg, model, None
    jcfg_f, cfg_f = jcfg.replace(input_stream="flow"), cfg.replace(input_stream="flow")
    v_flow, m_flow = _bridged(jcfg_f, cfg_f, 30)
    return jcfg, variables, v_flow, cfg, model, m_flow


@pytest.mark.parametrize("kind", ["late_fusion", "two_stream", "flow_stream"])
def test_evaluate_ucf_with_flow_matches_jax(kind, flow_layout, tmp_path):
    """`collect_detections` and `evaluate_ucf` with a flow model against the
    JAX package's (`variables_flow` for late fusion), after the JAX
    package's `test_evaluate_ucf_two_stream`, `..._late_fusion_protocol`
    and `..._flow_stream_standalone`: the detections (`collect_detections`)
    and every mAP, linked on the host, and for late fusion also on the
    device (`collect_video_tubes` with the flow stream)."""
    jcfg, variables, v_flow, cfg, model, m_flow = _eval_models(kind)
    ds = UCFDataset(flow_layout, cfg, split="test", with_flow=True)
    jds = JaxUCFDataset(flow_layout, jcfg, split="test", with_flow=True)
    got = tev.collect_detections(model, ds, model_flow=m_flow)
    want = jev.collect_detections(variables, jds, jcfg, variables_flow=v_flow)
    assert len(got) == len(want) > 0
    assert [(k, c) for k, c, _, _ in got] == [(k, c) for k, c, _, _ in want]
    np.testing.assert_allclose([s for _, _, s, _ in got], [s for _, _, s, _ in want],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.stack([b for *_, b in got]),
                               np.stack([b for *_, b in want]), rtol=0, atol=1e-4)
    for linking in (False, True) if kind == "late_fusion" else (False,):
        res = tev.evaluate_ucf(model, ds, model_flow=m_flow, device_linking=linking)
        jres = jev.evaluate_ucf(variables, jds, jcfg, variables_flow=v_flow,
                                device_linking=linking)
        for key in MAPS:
            assert res[key] == pytest.approx(jres[key], abs=1e-6, nan_ok=True), (linking, key)
    if kind == "late_fusion":
        # the flow stream moved the scores: RGB alone gives other ones
        alone = tev.collect_detections(model, ds)
        assert max(abs(a[2] - b[2]) for a, b in zip(alone, got)) > 1e-3
    # a dataset without flow is a clear error
    no_flow = UCFDataset(flow_layout, cfg, split="test")
    with pytest.raises(ValueError, match="flow-enabled dataset"):
        tev.collect_detections(model, no_flow, model_flow=m_flow)
    with pytest.raises(ValueError, match="flow-enabled dataset"):
        tev.collect_video_tubes(model, no_flow, model_flow=m_flow)
