"""The port's exported detect program (`step_tpu_torch/utils/export.py`,
`cli/export.py`) on the CPU, at tiny depth in float32.

  * K1 and K2 are the custom operators `step::nms_surface` and
    `step::tube_roi_align`, K3, K4 and K5 `step::conv3x3x3_bn_relu`,
    `step::scale_bias_relu` and `step::max_pool3x3_same`:
    `torch.library.opcheck` holds their schemas, fake (shape and stride)
    functions and dispatch, the backbone's in float32 and bfloat16, at an
    odd channel count and on an input not in `channels_last_3d` order.
  * The loaded program equals eager `detect_clip` bit for bit (the same
    operations on the same device), holds one `nms_surface`, one
    `tube_roi_align` a step and its pools as the pool kernels' nodes, and
    carries no weight: a second state_dict
    through the same artifact equals eager on it and differs from the
    first, which a cached tensor baked in as a constant would not.
  * The port's served detections equal the JAX package's served detections
    (`step_tpu.utils.export`) on converted weights, with
    `tests/test_torch_port_detect.py`'s tolerances: tubes within 1e-3 px,
    tube scores within 1e-4; the NMS surface exactly, each package's
    surface on the JAX program's tubes and scores, so that a near-tie of
    two scores cannot flip a keep list.
  * A `uint8_transfer=False` program takes float32 frames and equals
    eager on them; `two_stream` and `--platforms` are refused.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.models.optimize import optimize_for_inference as jax_optimize
from step_tpu.utils import export as jax_export
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch.cli import export as cli_export
from step_tpu_torch.config import PRESETS
from step_tpu_torch.convert import from_jax_variables
from step_tpu_torch.inference import detect_clip, nms_surface
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.ops.conv3d import kernel_weight
from step_tpu_torch.utils import export
from step_tpu_torch.utils.init import init_detector_

TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32, frames_per_chunk=2,
            compute_dtype="float32", num_classes=4)
B = 2


def _inputs(cfg, seed, dtype=torch.uint8):
    g = torch.Generator().manual_seed(seed)
    shape = (B, cfg.total_frames, cfg.image_size, cfg.image_size, 3)
    rgb = (torch.randint(0, 256, shape, dtype=torch.uint8, generator=g)
           if dtype == torch.uint8 else torch.rand(shape, generator=g))
    props, mask = STEPDetector.initial_proposals(cfg, B, device="cpu")
    return rgb, props, mask


@pytest.fixture(scope="module")
def served():
    """A tiny detector, its program exported on the CPU, and the program
    loaded."""
    cfg = PRESETS["ucf_3step"].replace(**TINY)
    model = init_detector_(STEPDetector(cfg), seed=0).eval()
    blob = export.export_detect_fn(cfg, B, model=model, device="cpu")
    return cfg, model, blob, export.load_detect_fn(blob)


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)


def _opcheck_cases():
    rng = np.random.RandomState(0)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    xy = rng.rand(2, 5, 6, 2) * 24
    tubes = t(np.concatenate([xy, xy + 2 + rng.rand(2, 5, 6, 2) * 8], -1))
    scores = t(rng.rand(2, 5, 3))
    mask = t(rng.rand(2, 5) > 0.2)
    feats = t(rng.randn(2, 3, 4, 4, 8))
    cases = {}
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype).split(".")[1]
        x = t(rng.randn(2, 5, 3, 4, 6)).to(dtype)            # contiguous NCDHW, odd C
        w = t(rng.randn(7, 5, 3, 3, 3) / 12)
        cases.update({
            f"scale_bias_relu_{tag}": (torch.ops.step.scale_bias_relu.default,
                                       (x, t(rng.rand(5) + 0.5), t(rng.randn(5)))),
            f"max_pool3x3_same_{tag}": (torch.ops.step.max_pool3x3_same.default, (x,)),
            f"conv3x3x3_bn_relu_{tag}": (torch.ops.step.conv3x3x3_bn_relu.default,
                                         (x, kernel_weight(w, dtype), t(rng.rand(7) + 0.5),
                                          t(rng.randn(7)))),
        })
    return {
        **cases,
        "nms_surface": (torch.ops.step.nms_surface.default,
                        (tubes, scores, mask, 4, 0.5, 0.05)),
        "nms_surface_bf16": (torch.ops.step.nms_surface.default,
                             (tubes, scores.to(torch.bfloat16), mask, 5, 0.3, 0.0)),
        "tube_roi_align": (torch.ops.step.tube_roi_align.default,
                           (feats, tubes, 3, 1 / 8, 2)),
        "tube_roi_align_adaptive": (torch.ops.step.tube_roi_align.default,
                                    (feats, tubes, 3, 1 / 8, 0)),
    }


@pytest.mark.parametrize("case", sorted(_opcheck_cases()))
def test_custom_ops_pass_opcheck(case):
    op, args = _opcheck_cases()[case]
    torch.library.opcheck(op, args)


def test_loaded_program_equals_eager_detect_clip(served):
    cfg, model, _, run = served
    rgb, props, mask = _inputs(cfg, 1)
    got = run(export.serving_weights(model.state_dict(), cfg, "cpu"), rgb, props, mask)
    _assert_equal(got, detect_clip(model, rgb, props, mask))
    assert float(got["frame_mask"].sum()) > 0


def test_program_holds_the_kernels_as_nodes(served):
    cfg, _, blob, _ = served
    # tiny depth: the stem's two strided pools, and the b3 pool of each of
    # its two Inception blocks and of each head's one
    assert export.program_op_counts(blob) == {"nms_surface": 1,
                                              "tube_roi_align": cfg.num_steps,
                                              "max_pool3d_same": 2,
                                              "max_pool3x3_same": 2 + cfg.num_steps}
    assert export.detect_fn_input_specs(blob) == (
        ((B, cfg.total_frames, 32, 32, 3), torch.uint8),
        ((B, cfg.max_proposals, cfg.total_frames, 4), torch.float32),
        ((B, cfg.max_proposals), torch.float32))


def test_weights_stay_out_of_the_program(served):
    cfg, model, blob, run = served
    program = export.load_program(blob)
    assert not program.state_dict
    weights = export.serving_weights(model.state_dict(), cfg, "cpu")
    n_weights = sum(v.numel() for v in weights.values())
    # what the program holds besides its graph: the constants it makes (the
    # RGB mean and std), nothing the size of a weight
    assert sum(v.numel() for v in program.constants.values()) <= 16
    other = init_detector_(STEPDetector(cfg), seed=5).eval()
    rgb, props, mask = _inputs(cfg, 2)
    first = run(weights, rgb, props, mask)
    second = run(export.serving_weights(other.state_dict(), cfg, "cpu"), rgb, props, mask)
    _assert_equal(second, detect_clip(other, rgb, props, mask))
    assert float((second["tube_scores"] - first["tube_scores"]).abs().max()) > 1e-3
    assert n_weights > 100_000


@pytest.mark.parametrize("optimized", [False, True])
def test_served_detections_equal_the_jax_package(optimized):
    jcfg = JAX_PRESETS["ucf_3step"].replace(**TINY)
    variables = init_detector_cpu(jcfg, jax.random.PRNGKey(0))
    if optimized:
        jcfg, variables = jax_optimize(jcfg, variables)
    cfg = PRESETS["ucf_3step"].replace(**{f: getattr(jcfg, f) for f in (
        *TINY, "bn_folded", "fused_inception", "fused_inception3", "scan_unroll")})
    model = STEPDetector(cfg).eval()
    model.load_state_dict(from_jax_variables(variables, cfg))
    rgb, props, mask = _inputs(cfg, 3)
    jrun = jax_export.load_detect_fn(jax_export.export_detect_fn(jcfg, B))
    want = jrun(variables, jnp.asarray(rgb.numpy()), jnp.asarray(props.numpy()),
                jnp.asarray(mask.numpy()))
    run = export.load_detect_fn(export.export_detect_fn(cfg, B, model=model, device="cpu"))
    got = run(export.serving_weights(model.state_dict(), cfg, "cpu"), rgb, props, mask)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["tubes"].numpy(), np.asarray(want["tubes"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["tube_scores"].numpy(), np.asarray(want["tube_scores"]),
                               rtol=0, atol=1e-4)
    # each surface is the port's NMS of its program's tubes and scores: the
    # JAX program's equal to the port's NMS of the JAX tubes, bit for bit
    mine = nms_surface(got["tubes"], got["tube_scores"], mask, cfg)
    theirs = nms_surface(torch.from_numpy(np.array(want["tubes"])),
                         torch.from_numpy(np.array(want["tube_scores"])), mask, cfg)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        torch.testing.assert_close(got[key], mine[key], rtol=0, atol=0, msg=key)
        np.testing.assert_array_equal(theirs[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert float(got["frame_mask"].sum()) > 0


def test_float32_wire_program_equals_eager_on_float_frames():
    """With `uint8_transfer=False` the program takes float32 frames in [0,
    1], as the JAX package's float32 twin does, and equals eager on them."""
    cfg = PRESETS["ucf_3step"].replace(**TINY, uint8_transfer=False)
    model = init_detector_(STEPDetector(cfg), seed=0).eval()
    blob = export.export_detect_fn(cfg, B, model=model, device="cpu")
    assert export.detect_fn_input_specs(blob)[0][1] == torch.float32
    rgb, props, mask = _inputs(cfg, 4, torch.float32)
    got = export.load_detect_fn(blob)(export.serving_weights(model.state_dict(), cfg, "cpu"),
                                      rgb, props, mask)
    _assert_equal(got, detect_clip(model, rgb, props, mask))


def test_export_refuses_two_stream_and_platforms(tmp_path):
    cfg = PRESETS["ucf_3step"].replace(**TINY, two_stream=True)
    with pytest.raises(ValueError, match="single-stream detectors only"):
        export.export_detect_fn(cfg, B, device="cpu")
    with pytest.raises(ValueError, match="single-stream detectors only"):
        jax_export.export_detect_fn(JAX_PRESETS["ucf_3step"].replace(**TINY, two_stream=True),
                                    B)
    with pytest.raises(SystemExit, match="--platforms"):
        cli_export.main(["--out", str(tmp_path / "p.pt2"), "--platforms", "tpu,cpu",
                         "--device", "cpu", "--tiny"])
    assert not (tmp_path / "p.pt2").exists()
