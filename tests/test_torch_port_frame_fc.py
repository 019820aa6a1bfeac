"""The "frame_fc" regression head (`reg_head="frame_fc"`, the reference's
4·T FC) in the PyTorch port against the JAX package, on the CPU.

The detector is tiny (depth "tiny", 64 px, float32); the JAX package's
weights are bridged by `from_jax_variables`, with the BN statistics moved
off the identity and the regression Dense large enough that the tubes
move. Tolerances are `detect_clip`'s (`test_torch_port_detect.py`): 1e-4
on logits and deltas, 1e-3 px on boxes. One SGD `train_step` is held as
`test_torch_port_train_step.py` holds the grid head's: losses within 1e-5
relative, `grad_norm` 1e-4 relative, weights within 1e-6, BN statistics
within 5e-5.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.data.pipeline import build_model_batch
from step_tpu.data.synthetic import SyntheticConfig, make_batch
from step_tpu.inference import detect_clip as jax_detect_clip
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.train.trainer import TrainState as JaxTrainState
from step_tpu.train.trainer import make_optimizer as jax_make_optimizer
from step_tpu.train.trainer import train_step as jax_train_step
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch import PRESETS
from step_tpu_torch.convert import from_jax_variables
from step_tpu_torch.inference import detect_clip
from step_tpu_torch.models.detector import STEPDetector, feature_frames
from step_tpu_torch.models.nets import REG_CHANNELS
from step_tpu_torch.models.optimize import optimize_for_inference
from step_tpu_torch.train.trainer import batch_to_device, create_train_state, train_step
from step_tpu_torch.utils.init import init_detector_, init_detector_train_

OVER = dict(backbone_depth="tiny", feature_stride=8, image_size=64, compute_dtype="float32",
            reg_head="frame_fc")
B = 2


def _randomize(variables, seed):
    rng = np.random.RandomState(seed)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.rand(*a.shape).astype(np.float32) * 0.5,
        variables["batch_stats"])
    params = jax.tree.map(np.asarray, variables["params"])
    reg = params["steps"]["head"]["reg"]
    reg["kernel"] = (rng.randn(*reg["kernel"].shape) * 0.01).astype(np.float32)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def pair():
    jcfg = JAX_PRESETS["ucf_3step"].replace(**OVER)
    cfg = PRESETS["ucf_3step"].replace(**OVER)
    variables = _randomize(init_detector_cpu(jcfg, jax.random.PRNGKey(0)), 1)
    model = STEPDetector(cfg).eval()
    model.load_state_dict(from_jax_variables(variables, cfg))
    rng = np.random.RandomState(2)
    rgb = rng.randint(0, 256, (B, cfg.total_frames, 64, 64, 3)).astype(np.uint8)
    props, pmask = JaxDetector.initial_proposals(jcfg, B)
    return jcfg, cfg, variables, model, rgb, np.array(props), np.array(pmask)


@pytest.mark.parametrize("chunk_stem", [False, True])
def test_frame_fc_builds_with_the_feature_frames(chunk_stem):
    cfg = PRESETS["ucf_3step"].replace(reg_head="frame_fc", chunk_stem=chunk_stem)
    Tp = feature_frames(cfg)
    assert Tp == (6 if chunk_stem else 5)
    head = STEPDetector(cfg).steps[0]
    assert head.reg.weight.shape == (4 * cfg.total_frames, Tp * 7 * 7 * REG_CHANNELS)
    assert head.dropout_shapes(16, Tp) == ((16, head.cls.in_features),
                                           (16, Tp * 7 * 7 * REG_CHANNELS))
    jcfg = JAX_PRESETS["ucf_3step"].replace(reg_head="frame_fc", chunk_stem=chunk_stem)
    shapes = jax.eval_shape(lambda: JaxDetector(jcfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 18, 224, 224, 3)), jnp.zeros((1, 16, 18, 4))))
    assert shapes["params"]["steps"]["head"]["reg"]["kernel"].shape == (
        cfg.num_steps, Tp * 7 * 7 * REG_CHANNELS, 4 * cfg.total_frames)


def test_every_step_matches_jax(pair):
    jcfg, cfg, variables, model, rgb, props, _ = pair
    want = jax.jit(JaxDetector(jcfg).apply)(variables, jnp.asarray(rgb), jnp.asarray(props))
    with torch.no_grad():
        got = model(torch.tensor(rgb), torch.tensor(props))
    for key, tol in (("cls_logits", 1e-4), ("deltas", 1e-4), ("tubes", 1e-3)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                   atol=tol, err_msg=key)
    # the regression moved the boxes, so the comparison above is not vacuous
    assert float((got["tubes"][-1] - got["proposals"][0]).abs().max()) > 1.0


def test_detect_clip_and_the_folded_tree_match_jax(pair):
    jcfg, cfg, variables, model, rgb, props, pmask = pair
    want = jax.jit(lambda v, r, p, m: jax_detect_clip(v, r, p, m, jcfg))(
        variables, jnp.asarray(rgb), jnp.asarray(props), jnp.asarray(pmask))
    got = detect_clip(model, torch.tensor(rgb), torch.tensor(props), torch.tensor(pmask))
    np.testing.assert_allclose(got["tubes"].numpy(), np.asarray(want["tubes"]), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(got["tube_scores"].numpy(), np.asarray(want["tube_scores"]),
                               rtol=0, atol=1e-4)
    # optimize_for_inference carries the head unchanged
    cfg_opt, folded = optimize_for_inference(cfg, model.state_dict())
    assert cfg_opt.reg_head == "frame_fc"
    for k in ("steps.0.reg.weight", "steps.0.reg.bias", "steps.0.reg_reduce.weight"):
        assert torch.equal(folded[k], model.state_dict()[k]), k
    served = STEPDetector(cfg_opt).eval()
    served.load_state_dict(folded)
    again = detect_clip(served, torch.tensor(rgb), torch.tensor(props), torch.tensor(pmask))
    np.testing.assert_allclose(again["tubes"].numpy(), np.asarray(want["tubes"]), rtol=0,
                               atol=1e-3)


def test_training_init_draws_the_regression_from_normal_1e3():
    cfg = PRESETS["ucf_3step"].replace(**OVER)
    model = init_detector_train_(STEPDetector(cfg), cfg, seed=0)
    for head in model.steps:
        w = head.reg.weight.detach()
        assert w.shape == (4 * 18, 5 * 7 * 7 * REG_CHANNELS)
        assert abs(float(w.std()) - 1e-3) < 5e-5 and abs(float(w.mean())) < 5e-5
        assert float(head.reg.bias.detach().abs().max()) == 0.0
    serving = init_detector_(STEPDetector(cfg).eval(), seed=0)
    assert abs(float(serving.steps[0].reg.weight.detach().std()) - 1e-3) < 5e-5


def test_sgd_train_step_matches_jax():
    over = dict(backbone_depth="tiny", feature_stride=8, image_size=32, frames_per_chunk=2,
                compute_dtype="float32", batch_size=2, warmup_steps=2, total_steps=50,
                num_classes=4, max_gt_tubes=2, dropout_rate=0.0, optimizer="sgd",
                reg_head="frame_fc")
    jcfg = JAX_PRESETS["ucf_3step"].replace(**over)
    cfg = PRESETS["ucf_3step"].replace(**over)
    variables = init_detector_cpu(jcfg, jax.random.PRNGKey(0), JaxDetector(jcfg))
    syn = SyntheticConfig(image_size=32, num_frames=jcfg.total_frames, num_classes=4,
                          max_boxes=2)
    batch = build_model_batch(make_batch(0, 2, syn), jcfg, train=True)
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
    for _ in range(2):            # warmup-cosine applies lr 0 at step 0
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(1))
        state, m = train_step(state, tbatch, cfg)
        for key in ("loss", "cls_loss_per_step", "reg_loss_per_step"):
            np.testing.assert_allclose(m[key].numpy(), np.asarray(jm[key]), rtol=1e-5,
                                       atol=1e-6, err_msg=key)
        np.testing.assert_allclose(m["grad_norm"].numpy(), np.asarray(jm["grad_norm"]),
                                   rtol=1e-4)
    want = from_jax_variables({"params": jstate.params,
                               "batch_stats": jstate.batch_stats}, cfg)
    got = state.model.state_dict()
    for key, w in want.items():
        tol = 5e-5 if "running_" in key else 1e-6
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), rtol=0, atol=tol,
                                   err_msg=key)
    moved = got["steps.0.reg.weight"] - initial["steps.0.reg.weight"]
    assert float(moved.abs().max()) > 0
