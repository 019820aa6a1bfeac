"""The port's inference variants against the JAX package, on the same
weights (bridged by `from_jax_variables`) and the same inputs, in float32
on the CPU:

  * the kernel configuration: unfolded variables with `fused_bn_relu=True`,
    the JAX side under `STEP_TPU_POOL3D=pallas` (it runs its Pallas kernels
    in interpret mode, as it does on any non-TPU backend);
  * the serving configuration of `optimize_for_inference`: BN folded with
    `fused_inception`, and `fused_inception3` in "none", "tail" and "all";
  * bfloat16 BatchNorm, which must round where flax's does.

Tolerances as in `test_torch_port_detect.py`: 1e-4 on logits and deltas,
1e-3 px on tubes.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from step_tpu.config import PRESETS
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.models.optimize import optimize_for_inference as jax_optimize
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch.convert import from_jax_variables
from step_tpu_torch.models import i3d
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.models.i3d import BN_EPS, BatchNorm
from step_tpu_torch.models.optimize import optimize_for_inference
from step_tpu_torch.ops import conv3d, fused_bn_relu, pool

TINY = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8,
                                    image_size=64, compute_dtype="float32")
B = 2


@pytest.fixture(scope="module")
def setup():
    """(JAX variables with BN statistics off the identity and a box
    regressor that moves the tubes, uint8 clips, proposals)."""
    v = init_detector_cpu(TINY, jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.rand(*a.shape).astype(np.float32) * 0.5,
        v["batch_stats"])
    params = jax.tree.map(np.asarray, v["params"])
    reg = params["steps"]["head"]["reg"]
    reg["kernel"] = (rng.randn(*reg["kernel"].shape) * 0.02).astype(np.float32)
    rgb = rng.randint(0, 256, (B, TINY.total_frames, 64, 64, 3)).astype(np.uint8)
    props, _ = JaxDetector.initial_proposals(TINY, B)
    return {"params": params, "batch_stats": stats}, rgb, np.array(props)


def _compare(cfg, variables, rgb, props):
    want = jax.jit(JaxDetector(cfg).apply)(variables, jnp.asarray(rgb),
                                           jnp.asarray(props))
    model = STEPDetector(cfg).eval()
    model.load_state_dict(from_jax_variables(variables, cfg))
    with torch.no_grad():
        got = model(torch.tensor(rgb), torch.tensor(props))
    for key, tol in (("cls_logits", 1e-4), ("deltas", 1e-4), ("tubes", 1e-3)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=tol, err_msg=key)
    assert float((got["tubes"][-1] - got["proposals"][0]).abs().max()) > 1.0
    return model


def test_kernel_configuration_matches_jax(setup, monkeypatch):
    """`fused_bn_relu=True` on unfolded variables with the Pallas pools: the
    port runs every unit through K3 or K4 and every b3 pool through K5
    (their plain versions on the CPU)."""
    variables, rgb, props = setup
    monkeypatch.setenv("STEP_TPU_POOL3D", "pallas")
    calls = {"K3": 0, "K4": 0, "K5": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(i3d, "conv3x3x3_bn_relu", counted("K3", conv3d.conv3x3x3_bn_relu))
    monkeypatch.setattr(i3d, "fused_scale_bias_relu",
                        counted("K4", fused_bn_relu.fused_scale_bias_relu))
    monkeypatch.setattr(pool, "max_pool3x3_same", counted("K5", pool.max_pool3x3_same))
    model = _compare(TINY.replace(fused_bn_relu=True), variables, rgb, props)
    # tiny: stem Conv3d_1a + 2 blocks, 3 heads of 1 block; a block has two
    # 3x3x3 units, four others and one b3 pool
    blocks = 2 + TINY.num_steps
    assert calls == {"K3": 2 * blocks, "K4": 1 + 4 * blocks, "K5": blocks}
    assert not any(isinstance(m, BatchNorm) and m.training for m in model.modules())


@pytest.mark.parametrize("scope", ["none", "tail", "all"])
def test_fused_inception_detector_matches_jax(setup, scope):
    variables, rgb, props = setup
    cfg, opt = jax_optimize(TINY, variables, fuse_inception3=scope)
    assert cfg.fused_inception and cfg.fused_inception3 == scope
    model = _compare(cfg, opt, rgb, props)
    names = {k.rsplit(".", 3)[-3] for k in model.state_dict()}
    assert "b012" in names and ("b12" in names) == (scope != "none")
    assert not {"b0", "b1a", "b2a"} & names


@pytest.mark.parametrize("scope", ["none", "tail", "all"])
def test_optimize_for_inference_matches_jax_tree(setup, scope):
    """The port's own optimize_for_inference, on the bridged unfolded
    weights, gives the config and the state_dict of the bridged
    JAX-optimized tree."""
    variables, _, _ = setup
    cfg_j, opt_j = jax_optimize(TINY, variables, fuse_inception3=scope)
    want = from_jax_variables(opt_j, cfg_j)
    cfg, got = optimize_for_inference(TINY, from_jax_variables(variables, TINY),
                                      fuse_inception3=scope)
    assert cfg == cfg_j
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=1e-6, atol=1e-6, msg=k)
    STEPDetector(cfg).load_state_dict(got)                       # strict


def test_optimize_for_inference_refuses_fuse3_without_fuse(setup):
    variables, _, _ = setup
    with pytest.raises(ValueError, match="requires fuse_inception"):
        optimize_for_inference(TINY, from_jax_variables(variables, TINY),
                               fuse_inception=False, fuse_inception3="all")


@pytest.mark.parametrize("scope", ["none", "all"])
def test_bridge_full_depth_fused_tree(scope):
    """ucf_3step at full depth, Inception-fused: the bridge maps every
    `b012`/`b12` leaf onto the port's model (shapes only; the model is built
    on the meta device)."""
    cfg = PRESETS["ucf_3step"]
    props, _ = JaxDetector.initial_proposals(cfg, 1)
    S, T = cfg.image_size, cfg.total_frames
    shapes = jax.eval_shape(JaxDetector(cfg).init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, T, S, S, 3), jnp.float32), props)
    variables = jax.tree.map(lambda s: np.broadcast_to(np.float32(1.0), s.shape), shapes)
    cfg, variables = jax_optimize(cfg, variables, fuse_inception3=scope)
    sd = from_jax_variables(variables, cfg)
    with torch.device("meta"):
        model = STEPDetector(cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}


def test_bfloat16_batchnorm_rounds_where_flax_does():
    """flax's nn.BatchNorm(dtype=bfloat16) computes in float32 and rounds
    once; at most 0.1% of the outputs may differ, by one bf16 step."""
    rng = np.random.RandomState(0)
    C = 64
    x = jnp.asarray(rng.randn(4, 5, 7, 7, C), jnp.bfloat16)
    params = {"scale": (rng.rand(C) + 0.5).astype(np.float32),
              "bias": (rng.randn(C) * 0.5).astype(np.float32)}
    stats = {"mean": (rng.randn(C) * 0.5).astype(np.float32),
             "var": (rng.rand(C) + 0.5).astype(np.float32)}
    bn = fnn.BatchNorm(use_running_average=True, epsilon=BN_EPS, dtype=jnp.bfloat16)
    want = jax.nn.relu(bn.apply({"params": params, "batch_stats": stats}, x))
    want = np.asarray(want.astype(jnp.float32))

    port = BatchNorm(C)
    port.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                          "bias": torch.from_numpy(params["bias"]),
                          "running_mean": torch.from_numpy(stats["mean"]),
                          "running_var": torch.from_numpy(stats["var"])})
    xt = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        got = torch.relu(port(xt.permute(0, 4, 1, 2, 3)))
    assert got.dtype == torch.bfloat16
    got = got.float().permute(0, 2, 3, 4, 1).numpy()
    diff = np.abs(got - want)
    # one bf16 step at the larger magnitude: 2^(exponent - 7)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(abs(got), abs(want)),
                                               1e-30))) - 7)
    assert (diff > 0).mean() <= 1e-3, f"{(diff > 0).mean():.2%} of outputs differ"
    assert bool((diff <= step).all()), float(diff.max())
