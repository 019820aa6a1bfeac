"""The PyTorch port's backbone, detector and detect_clip against the JAX
package, on the same weights (bridged by `from_jax_variables`) and the
same inputs, in float32 on the CPU.

Tolerances: 1e-4 on logits, deltas and features (float reassociation
between XLA's and PyTorch's CPU convolutions through ~10 layers) and 1e-3
px on boxes. The NMS surface is compared exactly, on the JAX package's own
final tubes and scores, so that a near-tie between two scores cannot flip
a keep list.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from step_tpu.config import PRESETS
from step_tpu.inference import detect_clip as jax_detect_clip
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.models.i3d import I3DTail as JaxI3DTail
from step_tpu.models.optimize import optimize_for_inference as jax_optimize
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch.convert import from_jax_variables
from step_tpu_torch.inference import detect_clip, nms_surface
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.models.i3d import I3DTail
from step_tpu_torch.utils.init import init_detector_

TINY = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8,
                                    image_size=64, compute_dtype="float32")
B = 2


def _randomize(variables, seed):
    """Move BN statistics off the identity and give the box regressor
    weights large enough that the tubes move."""
    rng = np.random.RandomState(seed)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.rand(*a.shape).astype(np.float32) * 0.5,
        variables["batch_stats"])
    params = jax.tree.map(np.asarray, variables["params"])
    if "steps" in params:
        reg = params["steps"]["head"]["reg"]
        reg["kernel"] = (rng.randn(*reg["kernel"].shape) * 0.02).astype(np.float32)
    return {"params": params, "batch_stats": stats}


@pytest.fixture(scope="module")
def pair():
    """(JAX variables, port model with the same weights, inputs)."""
    variables = _randomize(init_detector_cpu(TINY, jax.random.PRNGKey(0)), 1)
    model = STEPDetector(TINY).eval()
    model.load_state_dict(from_jax_variables(variables, TINY))
    rng = np.random.RandomState(2)
    rgb = rng.randint(0, 256, (B, TINY.total_frames, 64, 64, 3)).astype(np.uint8)
    props, pmask = JaxDetector.initial_proposals(TINY, B)
    return variables, model, rgb, np.array(props), np.array(pmask)


def test_i3d_tail_full_width_matches_jax():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 2, 3, 3, 832).astype(np.float32)
    tail = JaxI3DTail(depth="full")
    variables = _randomize(
        jax.jit(tail.init)(jax.random.PRNGKey(1), jnp.asarray(x)), 4)
    want = np.asarray(jax.jit(tail.apply)(variables, jnp.asarray(x)))
    port = I3DTail(832, "full").eval()
    port.load_state_dict(from_jax_variables(variables, TINY))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert want.shape == (2, 2, 3, 3, 1024)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               rtol=1e-4, atol=1e-4)


def test_every_step_matches_jax(pair):
    variables, model, rgb, props, _ = pair
    want = jax.jit(JaxDetector(TINY).apply)(variables, jnp.asarray(rgb),
                                            jnp.asarray(props))
    with torch.no_grad():
        got = model(torch.tensor(rgb), torch.tensor(props))
    S = TINY.num_steps
    assert got["cls_logits"].shape == (S, B, 16, 25)
    assert got["tubes"].shape == (S, B, 16, 18, 4)
    for key, tol in (("cls_logits", 1e-4), ("deltas", 1e-4),
                     ("proposals", 1e-3), ("tubes", 1e-3)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=tol, err_msg=key)
    np.testing.assert_array_equal(got["frame_mask"].numpy(),
                                  np.asarray(want["frame_mask"]))
    # the regression moved the boxes, so the comparison above is not vacuous
    assert float((got["tubes"][-1] - got["proposals"][0]).abs().max()) > 1.0


def test_detect_clip_matches_jax(pair):
    variables, model, rgb, props, pmask = pair
    detect = jax.jit(lambda v, r, p, m: jax_detect_clip(v, r, p, m, TINY))
    want = detect(variables, jnp.asarray(rgb), jnp.asarray(props),
                  jnp.asarray(pmask))
    got = detect_clip(model, torch.tensor(rgb), torch.tensor(props),
                      torch.tensor(pmask))
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["tubes"].numpy(), np.asarray(want["tubes"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["tube_scores"].numpy(),
                               np.asarray(want["tube_scores"]), rtol=0, atol=1e-4)
    assert float(got["tube_scores"][:, TINY.num_proposals:].abs().max()) == 0.0

    surface = nms_surface(torch.tensor(np.asarray(want["tubes"])),
                          torch.tensor(np.asarray(want["tube_scores"])),
                          torch.tensor(pmask), TINY)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        np.testing.assert_array_equal(surface[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert float(surface["frame_mask"].sum()) > 0


def test_folded_detector_matches_jax_folded(pair):
    variables, _, rgb, props, pmask = pair
    cfg_f, vars_f = jax_optimize(TINY, variables, fuse_inception=False)
    want = jax.jit(JaxDetector(cfg_f).apply)(vars_f, jnp.asarray(rgb),
                                             jnp.asarray(props))
    model = STEPDetector(cfg_f).eval()
    model.load_state_dict(from_jax_variables(vars_f, cfg_f))
    with torch.no_grad():
        got = model(torch.tensor(rgb), torch.tensor(props))
    np.testing.assert_allclose(got["cls_logits"].numpy(),
                               np.asarray(want["cls_logits"]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["tubes"].numpy(), np.asarray(want["tubes"]),
                               rtol=0, atol=1e-3)


def test_bfloat16_detect_clip_is_finite():
    cfg = TINY.replace(compute_dtype="bfloat16", image_size=32)
    model = init_detector_(STEPDetector(cfg).eval(), seed=0)
    props, pmask = STEPDetector.initial_proposals(cfg, 1, device="cpu")
    rgb = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (1, cfg.total_frames, 32, 32, 3)).astype(np.uint8))
    out = detect_clip(model, rgb, props, pmask)
    K = min(cfg.max_detections, cfg.max_proposals)
    assert out["frame_boxes"].shape == (1, 18, 24, K, 4)
    assert out["tube_scores"].dtype == torch.float32
    for key, value in out.items():
        assert bool(torch.isfinite(value).all()), key


def test_unported_options_are_refused():
    for kw in ({"two_stream": True}, {"chunk_stem": True},
               {"reg_head": "frame_fc"}, {"input_stream": "flow"}):
        with pytest.raises(NotImplementedError, match="not ported"):
            STEPDetector(TINY.replace(**kw))
