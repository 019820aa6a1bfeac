"""The port's exported kernel configuration (`utils/export.py`) on the CPU,
at tiny depth in float32: unfolded weights with `fused_bn_relu=True`, so
the program holds K3, K4 and K5 as the custom operators
`step::conv3x3x3_bn_relu`, `step::scale_bias_relu` and
`step::max_pool3x3_same` beside K1, K2 and the strided pools'
`step::max_pool3d_same`.

  * Its `step::` nodes equal the operator calls of one eager request of the
    same config, counted at the dispatcher.
  * The loaded program equals eager `detect_clip` bit for bit and carries
    no weight.
  * It equals the JAX package's exported program of the same config
    (`step_tpu.utils.export` under `STEP_TPU_POOL3D=pallas`, which the JAX
    package reads: its Pallas BN+ReLU and pool run in interpret mode off
    the TPU) on the same weights and uint8 clips, at
    `test_torch_port_export.py`'s tolerances: tubes within 1e-3 px, tube
    scores within 1e-4, each package's NMS surface equal to the port's NMS
    of its tubes and scores. The JAX kernel configuration runs a 3x3x3
    unit as conv + its BN+ReLU kernel, the port's as one K3 call: the same
    function, whose float32 sums differ in order only, well inside those
    tolerances.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.utils import export as jax_export
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch.config import PRESETS
from step_tpu_torch.convert import from_jax_variables
from step_tpu_torch.inference import detect_clip, nms_surface
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.utils import export

TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32, frames_per_chunk=2,
            compute_dtype="float32", num_classes=4, fused_bn_relu=True)
B = 2


class OpCalls(TorchDispatchMode):
    """Counts the calls of each `step::` operator while it is active."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name()
        if name.startswith("step::"):
            key = name.split("::")[1]
            self.counts[key] = self.counts.get(key, 0) + 1
        return func(*args, **(kwargs or {}))


def _variables(jcfg, seed):
    """JAX variables of `jcfg` with BatchNorm statistics off the identity."""
    v = init_detector_cpu(jcfg, jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed + 1)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.rand(*a.shape).astype(np.float32) * 0.5,
        v["batch_stats"])
    return {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}


def _inputs(cfg, seed):
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 256, (B, cfg.total_frames, cfg.image_size, cfg.image_size, 3))
    props, mask = STEPDetector.initial_proposals(cfg, B, device="cpu")
    return torch.from_numpy(rgb.astype(np.uint8)), props, mask


def _model(cfg, variables):
    model = STEPDetector(cfg).eval()
    model.load_state_dict(from_jax_variables(variables, cfg))
    return model


@pytest.fixture(scope="module")
def served():
    """The JAX config and variables, the port's model on them, and its
    program exported on the CPU."""
    jcfg = JAX_PRESETS["ucf_3step"].replace(**TINY)
    cfg = PRESETS["ucf_3step"].replace(**TINY)
    variables = _variables(jcfg, 0)
    model = _model(cfg, variables)
    blob = export.export_detect_fn(cfg, B, model=model, device="cpu")
    return jcfg, cfg, variables, model, blob, export.load_detect_fn(blob)


def _eager(model, rgb, props, mask):
    with OpCalls() as calls:
        out = detect_clip(model, rgb, props, mask)
    return out, calls.counts


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0, msg=key)


def test_program_nodes_equal_the_eager_request_calls(served):
    _, cfg, _, model, blob, _ = served
    nodes = export.program_op_counts(blob)
    _, calls = _eager(model, *_inputs(cfg, 1))
    assert nodes == calls
    assert set(nodes) == {"conv3x3x3_bn_relu", "scale_bias_relu", "max_pool3x3_same",
                          "max_pool3d_same", "nms_surface", "tube_roi_align"}
    assert nodes["nms_surface"] == 1 and nodes["tube_roi_align"] == cfg.num_steps


def test_program_equals_eager_without_the_switch(served):
    _, cfg, _, model, _, run = served
    rgb, props, mask = _inputs(cfg, 2)
    got = run(export.serving_weights(model.state_dict(), cfg, "cpu"), rgb, props, mask)
    want, _ = _eager(model, rgb, props, mask)
    _assert_equal(got, want)
    assert float(got["frame_mask"].sum()) > 0


def test_weights_stay_out_of_the_kernel_program(served):
    jcfg, cfg, _, model, blob, run = served
    program = export.load_program(blob)
    assert not program.state_dict
    assert sum(v.numel() for v in program.constants.values()) <= 16
    weights = export.serving_weights(model.state_dict(), cfg, "cpu")
    n_bytes = sum(v.numel() * v.element_size() for v in weights.values())
    assert n_bytes > 400_000
    other = _model(cfg, _variables(jcfg, 5))
    rgb, props, mask = _inputs(cfg, 3)
    first = run(weights, rgb, props, mask)
    second = run(export.serving_weights(other.state_dict(), cfg, "cpu"), rgb, props, mask)
    want, _ = _eager(other, rgb, props, mask)
    _assert_equal(second, want)
    assert float((second["tube_scores"] - first["tube_scores"]).abs().max()) > 1e-3


def test_kernel_program_equals_the_jax_package(served, monkeypatch):
    jcfg, cfg, variables, model, _, run = served
    rgb, props, mask = _inputs(cfg, 4)
    monkeypatch.setenv("STEP_TPU_POOL3D", "pallas")
    jrun = jax_export.load_detect_fn(jax_export.export_detect_fn(jcfg, B))
    want = jrun(variables, jnp.asarray(rgb.numpy()), jnp.asarray(props.numpy()),
                jnp.asarray(mask.numpy()))
    monkeypatch.delenv("STEP_TPU_POOL3D")
    got = run(export.serving_weights(model.state_dict(), cfg, "cpu"), rgb, props, mask)
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["tubes"].numpy(), np.asarray(want["tubes"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["tube_scores"].numpy(), np.asarray(want["tube_scores"]),
                               rtol=0, atol=1e-4)
    mine = nms_surface(got["tubes"], got["tube_scores"], mask, cfg)
    theirs = nms_surface(torch.from_numpy(np.array(want["tubes"])),
                         torch.from_numpy(np.array(want["tube_scores"])), mask, cfg)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        torch.testing.assert_close(got[key], mine[key], rtol=0, atol=0, msg=key)
        np.testing.assert_array_equal(theirs[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert float(got["frame_mask"].sum()) > 0
