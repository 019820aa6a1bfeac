"""The PyTorch port's weight bridge, BN folding, initializer and import
hygiene, held against the JAX package.

`step_tpu_torch.convert.from_jax_variables` maps the JAX detector's
variables onto the port's state_dict; loading it with `strict=True` proves
that every key and shape lines up, and the leaf count proves that no JAX
leaf was dropped.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import subprocess
import sys
from pathlib import Path

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
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.models.i3d import BatchNorm
from step_tpu_torch.models.optimize import fold_bn, optimize_for_inference
from step_tpu_torch.utils.init import init_detector_

REPO = Path(__file__).resolve().parents[1]
TINY = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8,
                                    image_size=64, compute_dtype="float32")


def _leaves(tree):
    if hasattr(tree, "items"):
        for k, v in tree.items():
            for path, leaf in _leaves(v):
                yield (k,) + path, leaf
    else:
        yield (), tree


def _expected_keys(variables, num_steps):
    """Torch keys the bridge must produce: one per JAX leaf, S per
    per-step leaf."""
    n = 0
    for collection in ("params", "batch_stats"):
        for path, _ in _leaves(variables.get(collection, {})):
            n += num_steps if path[0] == "steps" else 1
    return n


@pytest.fixture(scope="module")
def tiny_vars():
    """ucf_3step at tiny depth, with BN statistics moved off the identity
    so that folding and renaming them is visible."""
    v = init_detector_cpu(TINY, jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    stats = jax.tree.map(
        lambda a: np.asarray(a) + rng.rand(*a.shape).astype(np.float32) * 0.5,
        v["batch_stats"])
    return {"params": jax.tree.map(np.asarray, v["params"]), "batch_stats": stats}


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_bridge_covers_every_leaf(tiny_vars, folded):
    cfg, variables = TINY, tiny_vars
    if folded:
        cfg, variables = jax_optimize(TINY, tiny_vars, fuse_inception=False)
    sd = from_jax_variables(variables, cfg)
    assert len(sd) == _expected_keys(variables, cfg.num_steps)
    STEPDetector(cfg.replace(bn_folded=folded)).load_state_dict(sd)  # strict

    p = variables["params"]
    kernel = p["features"]["stem_rgb"]["Conv3d_1a_7x7"]["conv"]["kernel"]
    np.testing.assert_array_equal(
        sd["features.stem_rgb.Conv3d_1a_7x7.conv.weight"].numpy(),
        np.transpose(kernel, (4, 3, 0, 1, 2)))
    np.testing.assert_array_equal(sd["context.proj.weight"].numpy(),
                                  p["context"]["proj"]["kernel"].T)
    for s in range(cfg.num_steps):
        np.testing.assert_array_equal(sd[f"steps.{s}.cls.weight"].numpy(),
                                      p["steps"]["head"]["cls"]["kernel"][s].T)
        np.testing.assert_array_equal(
            sd[f"steps.{s}.reg_reduce.weight"].numpy(),
            np.transpose(p["steps"]["head"]["reg_reduce"]["kernel"][s],
                         (4, 3, 0, 1, 2)))
    if not folded:
        tail = variables["batch_stats"]["steps"]["head"]["tail"]
        var = tail["Mixed_5c"]["b3b"]["bn"]["var"]
        np.testing.assert_array_equal(
            sd["steps.2.tail.Mixed_5c.b3b.bn.running_var"].numpy(), var[2])
        scale = p["features"]["stem_rgb"]["Mixed_3b"]["b0"]["bn"]["scale"]
        np.testing.assert_array_equal(
            sd["features.stem_rgb.Mixed_3b.b0.bn.weight"].numpy(), scale)


@pytest.mark.parametrize("folded", [False, True], ids=["unfolded", "folded"])
def test_bridge_full_depth_key_and_shape_coverage(folded):
    """ucf_3step at full depth: shapes only, through jax.eval_shape (no
    compile); the port's model is built on the meta device."""
    cfg = PRESETS["ucf_3step"]
    B, T, S = 1, cfg.total_frames, cfg.image_size
    props, _ = JaxDetector.initial_proposals(cfg, B)
    shapes = jax.eval_shape(
        JaxDetector(cfg).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((B, T, S, S, 3), jnp.float32), props)
    variables = jax.tree.map(
        lambda s: np.broadcast_to(np.float32(1.0), s.shape), shapes)
    if folded:
        cfg, variables = jax_optimize(cfg, variables, fuse_inception=False)
    sd = from_jax_variables(variables, cfg)
    with torch.device("meta"):
        model = STEPDetector(cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert len(sd) == _expected_keys(variables, cfg.num_steps)


def test_bridge_rejects_unknown_leaves(tiny_vars):
    bad = {"params": {"extra": {"w": np.zeros(3, np.float32)}}}
    with pytest.raises(KeyError, match="no mapping"):
        from_jax_variables(bad, TINY)
    short = {"params": {"steps": {"head": {"cls": {
        "bias": np.zeros((2, 25), np.float32)}}}}}
    with pytest.raises(KeyError, match="stacked 3 deep"):
        from_jax_variables(short, TINY)


def test_fold_bn_matches_jax_fold(tiny_vars):
    sd = fold_bn(from_jax_variables(tiny_vars, TINY))
    cfg_f, vars_f = jax_optimize(TINY, tiny_vars, fuse_inception=False)
    want = from_jax_variables(vars_f, cfg_f)
    assert sd.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=1e-6, atol=1e-6)


def test_optimize_for_inference_sets_bn_folded_only(tiny_vars):
    """Without Inception fusion, only the BN fold changes the weights; the
    config is the JAX package's serving config."""
    sd = from_jax_variables(tiny_vars, TINY)
    cfg_f, folded = optimize_for_inference(TINY, sd, fuse_inception=False)
    assert cfg_f == jax_optimize(TINY, tiny_vars, fuse_inception=False)[0]
    assert cfg_f.bn_folded and not cfg_f.fused_inception
    assert folded.keys() == fold_bn(sd).keys()
    assert not any(".bn." in k for k in folded)
    STEPDetector(cfg_f).load_state_dict(folded)
    with pytest.raises(ValueError, match="already folded"):
        optimize_for_inference(cfg_f, folded)


def test_init_is_seeded_and_near_identity():
    a = init_detector_(STEPDetector(TINY), seed=1).state_dict()
    b = init_detector_(STEPDetector(TINY), seed=1).state_dict()
    c = init_detector_(STEPDetector(TINY), seed=2).state_dict()
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["steps.0.cls.weight"], c["steps.0.cls.weight"])
    assert float(a["steps.1.reg.weight"].std()) < 2e-3
    model = init_detector_(STEPDetector(TINY), seed=1)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            assert float((m.weight.detach() - 1).abs().max()) <= 0.1
            assert float(m.running_var.min()) >= 0.8
            assert float(m.running_var.max()) <= 1.2


def test_port_imports_no_jax():
    code = ("import sys, step_tpu_torch, step_tpu_torch.inference, "
            "step_tpu_torch.convert, step_tpu_torch.kernels, "
            "step_tpu_torch.utils.init, step_tpu_torch.models.optimize\n"
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
