"""The port's training modules against the JAX package's, on the CPU, on
inputs from a numpy seed: box encoding and tube IoU, batch assembly, the
matching and the progressive losses, train-mode BatchNorm, the pool and
ROI-align backwards, the schedule and the optimizer against optax, the
training init, dropout and remat, the loader, and `fit()` resumed through
a checkpoint against an uninterrupted run. The whole train step is held
against the JAX package's in `tests/test_torch_port_train_step.py`.

Tolerances are stated in each test. Copies of numpy code are compared
exactly; float32 math that runs the same operations in the same order
1e-6 relative; math that XLA and PyTorch reduce in different orders 1e-5.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import math
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.data import loader as jloader
from step_tpu.data import pipeline as jpipe
from step_tpu.data.synthetic import SyntheticConfig, make_batch, make_clip
from step_tpu.models.i3d import max_pool_3d as jax_max_pool_3d
from step_tpu.ops import roi_align_pallas as rap
from step_tpu.ops.pool3d_grad import max_pool_3d_s1_sepgrad as jax_sepgrad
from step_tpu.train import losses as jlosses
from step_tpu.train.trainer import make_schedule as jax_make_schedule
from step_tpu.tubes import boxes as jboxes
from step_tpu.tubes import tube_ops as jtube_ops
from step_tpu_torch import PRESETS
from step_tpu_torch.data import loader as tloader
from step_tpu_torch.data import pipeline as tpipe
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.models.i3d import BatchNorm, Unit3D, max_pool_3d, running_updates
from step_tpu_torch.models.nets import _dropout, draw_dropout_masks
from step_tpu_torch.ops.pool import max_pool3x3_same
from step_tpu_torch.ops.roi_align import tube_roi_align
from step_tpu_torch.train import losses as tlosses
from step_tpu_torch.train.fit import fit
from step_tpu_torch.train.trainer import (batch_to_device, create_train_state,
                                          make_optimizer, make_schedule, train_step)
from step_tpu_torch.train_eval_synth import evaluate
from step_tpu_torch.tubes import boxes as tboxes
from step_tpu_torch.tubes import tube_ops as ttube_ops
from step_tpu_torch.utils.checkpoint import checkpoint_steps
from step_tpu_torch.utils.init import init_detector_train_

TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32, frames_per_chunk=2,
            compute_dtype="float32", batch_size=2, warmup_steps=2, total_steps=50,
            num_classes=4, max_gt_tubes=2)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _random_tubes(rng, shape, size=64.0):
    xy = rng.uniform(-0.1, 0.9, shape[:-1] + (2,)) * size
    wh = rng.uniform(0.0, 0.6, shape[:-1] + (2,)) * size
    wh[rng.rand(*shape[:-1]) < 0.1] = 0.0                  # degenerate boxes
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# ---- box and tube math --------------------------------------------------

def test_encode_boxes_and_tube_iou_match_jax():
    """Same float32 operations in the same order: 1e-6 relative."""
    rng = np.random.RandomState(0)
    boxes, anchors = _random_tubes(rng, (3, 5, 4)), _random_tubes(rng, (3, 5, 4))
    np.testing.assert_allclose(
        tboxes.encode_boxes(_t(boxes), _t(anchors), (0.1, 0.2)).numpy(),
        np.asarray(jboxes.encode_boxes(boxes, anchors, (0.1, 0.2))), rtol=1e-6, atol=1e-6)
    a, b = _random_tubes(rng, (2, 6, 4, 4)), _random_tubes(rng, (2, 3, 4, 4))
    for mask in (None, np.float32([1, 0, 1, 1]),
                 (rng.rand(2, 4) > 0.3).astype(np.float32)):
        want = np.asarray(jtube_ops.tube_iou(a, b, mask))
        got = ttube_ops.tube_iou(_t(a), _t(b), None if mask is None else _t(mask))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)


# ---- batches ------------------------------------------------------------

@pytest.mark.parametrize("over", [
    {}, {"gt_jitter_proposals": 3, "max_gt_tubes": 3},
    {"multilabel": True, "max_gt_tubes": 1}, {"max_gt_tubes": 4}])
@pytest.mark.parametrize("train,uint8", [(True, True), (False, False)])
def test_build_model_batch_equals_jax(over, train, uint8):
    cfg = dict(TINY, **over)
    jcfg, tcfg = (JAX_PRESETS["ucf_3step"].replace(**cfg),
                  PRESETS["ucf_3step"].replace(**cfg))
    syn = SyntheticConfig(image_size=32, num_frames=tcfg.total_frames, num_classes=4,
                          max_boxes=2)
    raw = make_batch(3, 2, syn)
    want = jpipe.build_model_batch(raw, jcfg, train=train, seed=5, emit_uint8=uint8)
    got = tpipe.build_model_batch(raw, tcfg, train=train, seed=5, emit_uint8=uint8)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_jitter_gt_proposals_and_normalize_equal_jax():
    rng = np.random.RandomState(1)
    gt = _random_tubes(rng, (3, 6, 4), 32.0)
    for mask in (np.float32([1, 0, 1]), np.float32([0, 0, 0])):
        want = jpipe.jitter_gt_proposals(gt, mask, 5, 32.0, np.random.RandomState(7))
        got = tpipe.jitter_gt_proposals(gt, mask, 5, 32.0, np.random.RandomState(7))
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
    rgb = rng.rand(2, 4, 8, 8, 3).astype(np.float32)
    np.testing.assert_array_equal(tpipe.normalize_rgb(rgb), jpipe.normalize_rgb(rgb))
    flow = rng.uniform(-1.2, 1.2, (2, 4, 8, 8, 2)).astype(np.float32)
    np.testing.assert_array_equal(tpipe.flow_to_int8_wire(flow),
                                  jpipe.flow_to_int8_wire(flow))


# ---- matching and losses ------------------------------------------------

def _loss_inputs(cfg, seed):
    """Detector outputs `[S, ...]` and a batch: proposals near and far
    from the GT, padding slots, an example without GT."""
    rng = np.random.RandomState(seed)
    S, B, P, T, G = cfg.num_steps, 3, cfg.max_proposals, cfg.total_frames, 2
    gt = _random_tubes(rng, (B, G, T, 4), 32.0)
    gt_mask = np.float32([[1, 1], [1, 0], [0, 0]])
    props = _random_tubes(rng, (S, B, P, T, 4), 32.0)
    props[:, :, :4] = gt[None, :, :1] + rng.randn(S, B, 4, T, 4).astype(np.float32)
    prop_mask = np.ones((B, P), np.float32)
    prop_mask[:, -3:] = 0.0
    outputs = {
        "cls_logits": rng.randn(S, B, P, cfg.num_cls_outputs).astype(np.float32) * 2,
        "deltas": rng.randn(S, B, P, T, 4).astype(np.float32) * 0.5,
        "proposals": props,
        "frame_mask": np.stack([(rng.rand(T) > 0.3).astype(np.float32)
                                for _ in range(S)]),
    }
    if cfg.multilabel:
        labels = (rng.rand(B, G, cfg.num_classes) > 0.6).astype(np.float32)
    else:
        labels = rng.randint(0, cfg.num_classes, (B, G)).astype(np.int32)
    return outputs, (gt, labels, gt_mask, prop_mask)


@pytest.mark.parametrize("over", [
    {}, {"neg_pos_ratio": 0.0},
    {"multilabel": True}, {"multilabel": True, "focal_gamma": 0.0}])
def test_match_tubes_and_step_losses_match_jax(over):
    """Matching exactly; the loss, every metric and the gradients wrt the
    logits and deltas within 1e-5 relative (reductions in other orders)."""
    jcfg = JAX_PRESETS["ucf_3step"].replace(**TINY, **over)
    cfg = PRESETS["ucf_3step"].replace(**TINY, **over)
    outputs, (gt, labels, gt_mask, prop_mask) = _loss_inputs(cfg, 4)
    for s in range(cfg.num_steps):
        for b in range(gt.shape[0]):
            want = jlosses.match_tubes(outputs["proposals"][s, b], gt[b], gt_mask[b],
                                       outputs["frame_mask"][s], 0.5,
                                       prop_mask=prop_mask[b])
            got = tlosses.match_tubes(_t(outputs["proposals"][s, b]), _t(gt[b]),
                                      _t(gt_mask[b]), _t(outputs["frame_mask"][s]),
                                      0.5, prop_mask=_t(prop_mask[b]))
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))

    def jax_loss(cls, deltas):
        return jlosses.step_losses({**outputs, "cls_logits": cls, "deltas": deltas},
                                   gt, labels, gt_mask, prop_mask, jcfg)

    (jtotal, jmetrics), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                                    has_aux=True)(
        outputs["cls_logits"], outputs["deltas"])
    tout = {k: _t(v).clone() for k, v in outputs.items()}
    tout["cls_logits"].requires_grad_()
    tout["deltas"].requires_grad_()
    total, metrics = tlosses.step_losses(tout, _t(gt), _t(labels), _t(gt_mask),
                                         _t(prop_mask), cfg)
    total.backward()
    assert sorted(metrics) == sorted(jmetrics)
    assert float(metrics["num_positive_per_step"].sum()) > 0
    for k in jmetrics:
        np.testing.assert_allclose(metrics[k].detach().numpy(), np.asarray(jmetrics[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    for g, w in zip((tout["cls_logits"].grad, tout["deltas"].grad), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)


def test_smooth_l1_matches_jax():
    x = np.float32([-2.0, -1.0, -0.5, 0.0, 0.3, 1.0, 2.5])
    np.testing.assert_array_equal(tlosses.smooth_l1(_t(x)).numpy(),
                                  np.asarray(jlosses.smooth_l1(x)))


# ---- train-mode BatchNorm -----------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_mode_batchnorm_matches_flax(dtype):
    """Output and the running statistics after one update, against flax's
    train-mode BatchNorm (momentum 0.9, eps 1e-3, biased variance):
    float32 within 1e-5; bfloat16 output within one bf16 rounding step of
    its magnitude (the float32 statistics agree to 1e-5 either way); and
    in float32 the gradients wrt x, scale and bias within 1e-4."""
    rng = np.random.RandomState(5)
    C = 6
    x = (rng.randn(3, 4, 5, 5, C) * 2 + rng.randn(C)).astype(np.float32)
    x[0, 0, 0, 0] = 0.0
    state = {"params": {"scale": rng.rand(C).astype(np.float32) + 0.5,
                        "bias": rng.randn(C).astype(np.float32)},
             "batch_stats": {"mean": rng.randn(C).astype(np.float32),
                             "var": rng.rand(C).astype(np.float32) + 0.5}}
    jdt = jnp.dtype(dtype)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3, dtype=jdt)
    xj = jnp.asarray(x).astype(jdt)
    want, mutated = bn.apply(state, xj, mutable=["batch_stats"])
    port = BatchNorm(C)
    port.weight.data = _t(state["params"]["scale"])
    port.bias.data = _t(state["params"]["bias"])
    port.running_mean = _t(state["batch_stats"]["mean"]).clone()
    port.running_var = _t(state["batch_stats"]["var"]).clone()
    xt = _t(x).to(getattr(torch, dtype)).permute(0, 4, 1, 2, 3)
    got = port(xt, train=True).permute(0, 2, 3, 4, 1)
    assert got.dtype == xt.dtype
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got.detach().float().numpy(), want,
                                   rtol=2.0 ** -7, atol=1e-5)
    (mean,), (var,) = running_updates([port])
    np.testing.assert_allclose(mean.numpy(), np.asarray(mutated["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(mutated["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    if dtype != "float32":
        return
    w = rng.randn(*x.shape).astype(np.float32)
    jg = jax.grad(lambda p, a: jnp.sum(bn.apply({**state, "params": p}, a,
                                                mutable=["batch_stats"])[0] * w),
                  argnums=(0, 1))(state["params"], jnp.asarray(x))
    xt = xt.detach().requires_grad_()
    (port(xt, train=True) * _t(w).permute(0, 4, 1, 2, 3)).sum().backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 4, 1).numpy(), np.asarray(jg[1]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.weight.grad.numpy(), np.asarray(jg[0]["scale"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(port.bias.grad.numpy(), np.asarray(jg[0]["bias"]),
                               rtol=1e-4, atol=1e-5)


def test_folded_units_and_trees_refuse_to_train():
    unit = Unit3D(4, 8, (1, 1, 1), bn_folded=True)
    with pytest.raises(ValueError, match="BN-folded"):
        unit(torch.zeros(1, 4, 2, 3, 3), train=True)
    cfg = PRESETS["ucf_3step"].replace(**TINY, bn_folded=True)
    with pytest.raises(ValueError, match="BN-folded"):
        create_train_state(cfg, device="cpu")


# ---- the pool backwards -------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 4, 6, 5, 3), (1, 2, 7, 7, 4), (1, 1, 3, 2, 2)])
def test_stride1_pool_backward_equals_jax_on_ties(shape, dtype):
    """Integer-valued inputs from {0, 1, 2}, so nearly every window has a
    tie, and integer cotangents: the port's separable shift-and-compare
    backward equals jax.grad of `max_pool_3d_s1_sepgrad` exactly, and
    differs from PyTorch's own max-pool backward (one argmax)."""
    rng = np.random.RandomState(6)
    x = rng.randint(0, 3, shape).astype(np.float32)
    g = rng.randint(-3, 4, shape).astype(np.float32)
    jdt = jnp.dtype(dtype)
    want = jax.grad(lambda a: jnp.sum(jax_sepgrad(a, (3, 3, 3)).astype(jnp.float32) * g))(
        jnp.asarray(x).astype(jdt))
    tdt = getattr(torch, dtype)
    xt = _t(x).to(tdt).permute(0, 4, 1, 2, 3).requires_grad_()
    y = max_pool_3d(xt, (3, 3, 3), (1, 1, 1))
    assert y.grad_fn is not None
    (y.float() * _t(g).permute(0, 4, 1, 2, 3)).sum().backward()
    got = xt.grad.permute(0, 2, 3, 4, 1).float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want.astype(jnp.float32)))
    native = xt.detach().clone().requires_grad_()
    (torch.nn.functional.max_pool3d(native, 3, 1, 1).float()
     * _t(g).permute(0, 4, 1, 2, 3)).sum().backward()
    if shape[1] * shape[2] * shape[3] > 8:
        assert not np.array_equal(native.grad.permute(0, 2, 3, 4, 1).float().numpy(), got)


@pytest.mark.parametrize("window,stride,shape", [
    ((1, 3, 3), (1, 2, 2), (2, 4, 9, 9, 3)),
    ((3, 3, 3), (2, 2, 2), (2, 5, 8, 8, 3)),
    ((3, 3, 3), (2, 2, 2), (1, 3, 7, 6, 2))])
@pytest.mark.parametrize("channels_last", [False, True])
def test_strided_pool_backward_equals_jax_on_ties(window, stride, shape, channels_last):
    """Strided pools keep PyTorch's backward: on integer-valued inputs it
    credits the first maximum in window order, as XLA's select-and-scatter
    (jax.grad of `reduce_window` max) does — equal exactly."""
    rng = np.random.RandomState(7)
    x = rng.randint(0, 3, shape).astype(np.float32)
    y = np.asarray(jax_max_pool_3d(jnp.asarray(x), window, stride))
    g = rng.randint(-3, 4, y.shape).astype(np.float32)
    want = jax.grad(lambda a: jnp.sum(jax_max_pool_3d(a, window, stride) * g))(
        jnp.asarray(x))
    xt = _t(x).permute(0, 4, 1, 2, 3)
    if channels_last:
        xt = xt.contiguous(memory_format=torch.channels_last_3d)
    xt = xt.detach().requires_grad_()
    yt = max_pool_3d(xt, window, stride)
    np.testing.assert_array_equal(yt.detach().permute(0, 2, 3, 4, 1).numpy(), y)
    (yt * _t(g).permute(0, 4, 1, 2, 3)).sum().backward()
    np.testing.assert_array_equal(xt.grad.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want))


def test_kernel_wrappers_keep_the_graph_or_raise():
    x = torch.randn(1, 4, 3, 5, 5, requires_grad=True)
    assert max_pool3x3_same(x).grad_fn is not None
    assert max_pool3x3_same(x.detach()).grad_fn is None
    with torch.no_grad():
        assert max_pool3x3_same(x).grad_fn is None
    feat = torch.randn(1, 2, 6, 6, 4, requires_grad=True)
    tubes = torch.tensor([[[[4.0, 4.0, 40.0, 30.0]] * 4]])
    assert tube_roi_align(feat, tubes, 3, 1 / 8, 2).grad_fn is not None
    with pytest.raises(ValueError, match="no kernel"):
        max_pool3x3_same(torch.empty(1, 4, 3, 5, 5, device="meta", requires_grad=True))
    with pytest.raises(ValueError, match="no kernel"):
        tube_roi_align(torch.empty(1, 2, 6, 6, 4, device="meta", requires_grad=True),
                       tubes.to("meta"), 3, 1 / 8, 2)


# ---- the ROI-align backward ---------------------------------------------

@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX package's Pallas kernels in interpret mode on the CPU."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs["interpret"] = True
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setattr(rap.pl, "pallas_call", patched)


@pytest.mark.parametrize("ratio", [2, 0])
def test_roi_align_backward_matches_jax(ratio, interpret_pallas):
    """`tube_roi_align` under autograd against jax.grad through
    `tube_roi_align_pallas` (the Pallas forward in interpret mode, its
    custom VJP): the output, dfeatures and dtubes within 1e-5."""
    rng = np.random.RandomState(8)
    B, Tp, H, W, C, N, T = 2, 3, 8, 8, 5, 4, 6
    feat = rng.randn(B, Tp, H, W, C).astype(np.float32)
    tubes = _random_tubes(rng, (B, N, T, 4), 64.0)
    tubes[:, 0] = [-40.0, -40.0, -10.0, -10.0]             # wholly outside
    w = rng.randn(B, N, Tp, 3, 3, C).astype(np.float32)

    def jloss(f, t):
        out = rap.tube_roi_align_pallas(f, t, 3, 1 / 8, ratio)
        return jnp.sum(out * w), out

    (_, jout), (jdf, jdt) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(feat), jnp.asarray(tubes))
    f = _t(feat).requires_grad_()
    t = _t(tubes).requires_grad_()
    out = tube_roi_align(f, t, 3, 1 / 8, ratio)
    (out * _t(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(), np.asarray(jdf), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jdt), rtol=1e-5, atol=1e-5)
    # only dfeatures when the tubes do not require a gradient
    f2 = _t(feat).requires_grad_()
    (tube_roi_align(f2, _t(tubes), 3, 1 / 8, ratio) * _t(w)).sum().backward()
    np.testing.assert_allclose(f2.grad.numpy(), np.asarray(jdf), rtol=1e-5, atol=1e-5)


# ---- schedule, optimizer, init ------------------------------------------

@pytest.mark.parametrize("over", [
    {"warmup_steps": 5, "total_steps": 40},
    {"warmup_steps": 0, "total_steps": 20},
    {"lr_schedule": "step", "warmup_steps": 4, "lr_decay_milestones": (10, 15)},
    {"lr_schedule": "step", "warmup_steps": 0, "lr_decay_milestones": (3,)}])
def test_schedule_matches_optax(over):
    """float32 values within 1e-6 relative; step 0 of warmup-cosine is 0."""
    jcfg = JAX_PRESETS["ucf_3step"].replace(learning_rate=3e-3, **over)
    cfg = PRESETS["ucf_3step"].replace(learning_rate=3e-3, **over)
    want, got = jax_make_schedule(jcfg), make_schedule(cfg)
    for step in (0, 1, 2, 3, 4, 5, 6, 9, 10, 14, 15, 19, 20, 33, 40, 55):
        np.testing.assert_allclose(got(step), float(want(jnp.int32(step))), rtol=1e-6,
                                   atol=1e-12, err_msg=f"step {step}")
    if over.get("lr_schedule") != "step" and over["warmup_steps"]:
        assert got(0) == 0.0


@pytest.mark.parametrize("over", [{}, {"optimizer": "sgd"}, {"weight_decay": 0.0},
                                  {"adam_mu_dtype": "bfloat16"}])
def test_optimizer_matches_optax(over):
    """Four updates on the same parameters and gradients (the second with a
    gradient norm above the clip's 10): the parameters and the moments
    within 1e-6 relative (1e-2 for a bfloat16 first moment, which JAX
    scales in bfloat16)."""
    cfg = PRESETS["ucf_3step"].replace(learning_rate=1e-2, warmup_steps=2,
                                       total_steps=10, **over)
    jcfg = JAX_PRESETS["ucf_3step"].replace(learning_rate=1e-2, warmup_steps=2,
                                            total_steps=10, **over)
    from step_tpu.train.trainer import make_optimizer as jax_make_optimizer

    rng = np.random.RandomState(9)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    tx = jax_make_optimizer(jcfg)
    jstate = tx.init(params)
    jparams = params
    opt = make_optimizer(cfg)
    tparams = [_t(params[k]).clone() for k in shapes]
    tstate = opt.init(tparams, list(shapes))
    for i in range(4):
        scale = 10.0 if i == 1 else 0.5
        grads = {k: (rng.randn(*s) * scale).astype(np.float32) for k, s in shapes.items()}
        updates, jstate = tx.update(grads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update(tparams, [_t(grads[k]) for k in shapes], tstate)
        for k, p in zip(shapes, tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"update {i}, {k}")
    moments = [s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: hasattr(s, "mu") or hasattr(s, "trace"))
        if hasattr(s, "mu") or hasattr(s, "trace")][0]
    if cfg.optimizer == "sgd":
        pairs = [(tstate["trace"], moments.trace, 1e-6)]
    else:
        tol = 1e-2 if cfg.adam_mu_dtype == "bfloat16" else 1e-6
        pairs = [(tstate["mu"], moments.mu, tol), (tstate["nu"], moments.nu, 1e-6)]
    for got, want, tol in pairs:
        for k, g in zip(shapes, got):
            np.testing.assert_allclose(g.float().numpy(), np.asarray(want[k], np.float32),
                                       rtol=tol, atol=1e-7)


def test_int8_moments_pretrained_i3d_and_a_missing_card_refuse(tmp_path):
    """int8 moments and `pretrained_i3d` are ported (`test_torch_port_int8.py`,
    `test_torch_port_pretrained.py`); what they refuse is what the JAX
    package refuses: int8 with a bfloat16 first moment, and a checkpoint
    that is no I3D. A missing card refuses training."""
    with pytest.raises(ValueError, match="int8"):
        PRESETS["ucf_3step"].replace(adam_moments="int8", adam_mu_dtype="bfloat16")
    assert make_optimizer(PRESETS["ucf_3step"].replace(adam_moments="int8")).int8
    bad = str(tmp_path / "not_i3d.pt")
    torch.save({"state_dict": {"fc.weight": torch.zeros(3, 3)}}, bad)
    with pytest.raises(KeyError, match="unrecognized I3D"):
        fit(PRESETS["ucf_3step"].replace(**TINY), None, device="cpu", pretrained_i3d=bad)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_train_state(PRESETS["ucf_3step"].replace(**TINY))


@pytest.mark.parametrize("multilabel", [False, True])
def test_training_init_draws_flax_distributions(multilabel):
    """lecun-normal kernels (truncated at 2 std, variance 1/fan_in: the
    sample std within 5% over the large kernels), zero biases, the
    regression Dense at normal(1e-3), the class bias at logit(cls_prior)
    for a multilabel head, BatchNorm 1 / 0 / 0 / 1."""
    cfg = PRESETS["ucf_3step"].replace(**TINY, multilabel=multilabel)
    model = init_detector_train_(STEPDetector(cfg), cfg, seed=3)
    for name, p in model.state_dict(keep_vars=False).items():
        if "running_" in name:
            continue
        if name.endswith(".conv.weight") or name.endswith("proj.weight"):
            fan_in = p[0].numel()
            std = 1.0 / math.sqrt(fan_in)
            assert float(p.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6, name
            if p.numel() >= 4096:
                assert abs(float(p.std()) / std - 1.0) < 0.05, name
        elif name.endswith("reg.weight"):
            assert abs(float(p.std()) / 1e-3 - 1.0) < 0.1, name
        elif name.endswith("cls.bias"):
            prior = math.log(cfg.cls_prior / (1 - cfg.cls_prior)) if multilabel else 0.0
            np.testing.assert_allclose(p.detach().numpy(), prior, rtol=1e-6)
        elif name.endswith("bn.weight"):
            assert torch.equal(p, torch.ones_like(p)), name
        elif name.endswith("bias"):
            assert torch.equal(p, torch.zeros_like(p)), name
    for name, buf in model.named_buffers():
        want = 0.0 if name.endswith("running_mean") else 1.0
        assert torch.equal(buf, torch.full_like(buf, want)), name
    again = init_detector_train_(STEPDetector(cfg), cfg, seed=3)
    for (_, a), (_, b) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a, b)


# ---- dropout and remat --------------------------------------------------

def test_dropout_is_deterministic_per_generator_and_keeps_its_share():
    """The same generator state draws the same masks, another seed other
    masks; the keep share is 1 - rate within 0.005 over 2e5 draws; kept
    values are divided by 1 - rate. The masks are torch's draws, so they
    cannot equal the JAX package's (ROADMAP.md §3 records it)."""
    shapes = ((400, 100), (10, 2, 5000))
    draw = lambda seed: draw_dropout_masks(  # noqa: E731
        shapes, 0.3, torch.Generator().manual_seed(seed))
    a, b, c = draw(1), draw(1), draw(2)
    for x, y, z in zip(a, b, c):
        assert torch.equal(x, y) and not torch.equal(x, z)
        assert abs(float(x.float().mean()) - 0.7) < 0.005
    x = torch.randn(400, 100)
    y = _dropout(x, a[0], 0.3)
    torch.testing.assert_close(y[a[0]], x[a[0]] / 0.7, rtol=0, atol=0)
    assert torch.equal(y[~a[0]], torch.zeros_like(y[~a[0]]))


def _tiny_batch(cfg, seed=0):
    syn = SyntheticConfig(image_size=32, num_frames=cfg.total_frames, num_classes=4,
                          max_boxes=2)
    raw = make_batch(seed, cfg.batch_size, syn)
    return batch_to_device(tpipe.build_model_batch(raw, cfg, train=True), "cpu")


def test_remat_matches_no_remat_with_dropout():
    """Dropout 0.3 on: three steps with remat "full" and "dots" give the
    bits of three steps without remat — metrics, weights and statistics —
    so the recomputation applied the same dropout masks."""
    runs = []
    for remat, policy in ((False, "dots"), (True, "full"), (True, "dots")):
        cfg = PRESETS["ucf_3step"].replace(**TINY, dropout_rate=0.3, remat_steps=remat,
                                           remat_policy=policy)
        state = create_train_state(cfg, seed=0, device="cpu")
        batch = _tiny_batch(cfg)
        metrics = [train_step(state, batch, cfg)[1] for _ in range(3)]
        runs.append((metrics, state.model.state_dict()))
    (m0, sd0) = runs[0]
    for m, sd in runs[1:]:
        for a, b in zip(m0, m):
            for k in a:
                assert torch.equal(a[k], b[k]), k
        for k in sd0:
            assert torch.equal(sd0[k], sd[k]), k


# ---- loader, fit, checkpoints -------------------------------------------

class _Clips:
    """A small synthetic dataset: clip i from seed i."""

    def __init__(self, cfg, n):
        self.n = n
        self.syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                                   num_classes=cfg.num_classes, max_boxes=cfg.max_gt_tubes)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return make_clip(i, self.syn)


@pytest.mark.parametrize("drop_last", [True, False])
def test_loader_equals_jax(drop_last):
    """The same batches as the JAX package's loader (seeded shuffle,
    drop_last, uint8 rgb, GT jitter in the padding slots), and `start`
    skips to the same tail."""
    over = dict(TINY, gt_jitter_proposals=2)
    jcfg, cfg = (JAX_PRESETS["ucf_3step"].replace(**over),
                 PRESETS["ucf_3step"].replace(**over))
    data = _Clips(cfg, 7)
    want = list(jloader.DataLoader(data, jcfg, seed=3, num_workers=2,
                                   drop_last=drop_last).epoch(1))
    loader = tloader.DataLoader(data, cfg, seed=3, num_workers=2, drop_last=drop_last)
    got = list(loader.epoch(1))
    assert len(got) == len(want) == len(loader)
    for g, w in zip(got, want):
        assert g["rgb"].dtype == np.uint8
        for k in w:
            if k != "meta":
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    tail = list(loader.epoch(1, start=2))
    assert len(tail) == len(got) - 2
    for g, w in zip(tail, got[2:]):
        np.testing.assert_array_equal(g["rgb"], w["rgb"])


def _fit_cfg():
    return PRESETS["ucf_3step"].replace(**TINY, dropout_rate=0.3)


def _same_state(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    for k in ("mu", "nu"):
        for x, y in zip(a.opt_state[k], b.opt_state[k]):
            assert torch.equal(x, y), k
    assert a.step == b.step and a.opt_state["count"] == b.opt_state["count"]
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def _fit_loader(cfg, data=None):
    return tloader.DataLoader(data or _Clips(cfg, 6), cfg, seed=1, num_workers=1)


@pytest.fixture(scope="module")
def straight(tmp_path_factory):
    """(6 steps of fit() straight, its checkpoint and log directory), which
    the resumed and the preempted runs must end on."""
    tmp = tmp_path_factory.mktemp("straight")
    cfg = _fit_cfg()
    state = fit(cfg, _fit_loader(cfg), num_epochs=2, device="cpu", seed=4,
                ckpt_dir=str(tmp / "ckpt"), ckpt_every=2, log_dir=str(tmp / "log"))
    return state, tmp


def test_fit_resumed_through_a_checkpoint_equals_an_uninterrupted_run(straight, tmp_path):
    """fit() for 3 + 3 steps through a checkpoint (an epoch boundary), and
    for 4 + 2 (mid-epoch, from the step-4 checkpoint), equal 6 steps
    straight, bit for bit on the CPU: weights, BatchNorm statistics,
    optimizer moments, step and the dropout generator."""
    import shutil

    straight, tmp = straight
    cfg = _fit_cfg()
    loader = _fit_loader(cfg)
    assert straight.step == 6
    assert checkpoint_steps(str(tmp / "ckpt")) == [2, 4, 6]   # max_to_keep 3
    lines = open(tmp / "log" / "metrics.jsonl").read().splitlines()
    assert len(lines) == 6 and all(math.isfinite(float(eval(l)["loss"])) for l in lines)

    first = fit(cfg, loader, num_epochs=1, device="cpu", seed=4,
                ckpt_dir=str(tmp_path / "a"))
    assert first.step == 3
    resumed = fit(cfg, loader, num_epochs=2, device="cpu", seed=4,
                  ckpt_dir=str(tmp_path / "a"), resume=True)
    _same_state(resumed, straight)

    mid = tmp_path / "straight"
    shutil.copytree(tmp / "ckpt", mid)
    os.remove(mid / "6.pt")
    resumed = fit(cfg, loader, num_epochs=2, device="cpu", seed=4,
                  ckpt_dir=str(mid), resume=True)
    _same_state(resumed, straight)


def test_evaluate_scores_a_trained_tiny_detector(straight):
    """The synthetic-oracle evaluation of `train_eval_synth` runs on a
    trained detector (the 6 straight steps) and gives frame-mAPs in [0, 1]."""
    cfg = _fit_cfg()
    syn = SyntheticConfig(image_size=32, num_frames=cfg.total_frames, num_classes=4,
                          max_boxes=2)
    result = evaluate(straight[0].model, cfg, syn, 3, 2, "cpu")
    assert sorted(result) == ["frame_mAP@0.2", "frame_mAP@0.5"]
    assert all(0.0 <= v <= 1.0 for v in result.values())


def test_fit_checkpoints_on_sigterm_and_runs_eval_fn(straight, tmp_path, monkeypatch):
    """SIGTERM in the middle of an epoch (its handler called as the signal
    would call it, from the loader's thread) makes fit() write a last
    checkpoint and return; resumed, it ends where an uninterrupted run
    ends (the 6 straight steps), bit for bit. `eval_fn(state, epoch)` runs
    at each epoch's end."""
    import signal

    handlers = {}
    real_signal = signal.signal

    def capture(sig, handler):
        handlers[sig] = handler
        return real_signal(sig, handler) if sig != signal.SIGTERM else signal.SIG_DFL

    monkeypatch.setattr(signal, "signal", capture)
    cfg = _fit_cfg()

    class Preempted(_Clips):
        def __getitem__(self, i):
            if i == 3 and signal.SIGTERM in handlers and not handlers.get("sent"):
                handlers["sent"] = True
                handlers[signal.SIGTERM](signal.SIGTERM, None)
            return super().__getitem__(i)

    evals = []
    loader = _fit_loader(cfg, Preempted(cfg, 6))
    stopped = fit(cfg, loader, num_epochs=2, device="cpu", seed=4,
                  ckpt_dir=str(tmp_path), eval_fn=lambda s, e: evals.append((s.step, e)))
    assert handlers.get("sent") and 1 <= stopped.step < 6
    assert checkpoint_steps(str(tmp_path))[-1] == stopped.step
    resumed = fit(cfg, loader, num_epochs=2, device="cpu", seed=4,
                  ckpt_dir=str(tmp_path), resume=True,
                  eval_fn=lambda s, e: evals.append((s.step, e)))
    _same_state(resumed, straight[0])
    assert evals[-1] == (6, 1)


def test_train_eval_synth_draws_the_jax_scripts_batches():
    """`train_eval_synth` trains on the JAX script's batches
    (`scripts/train_eval_synth.py`: `make_batch(seed * 1000 + step * B, B)`),
    built ahead by the loader: equal arrays. Its configuration is the
    script's."""
    from step_tpu_torch.train_eval_synth import SyntheticClips, parse_args, synth_config

    args = parse_args(["--steps", "3", "--batch", "2", "--image-size", "32", "--seed", "1"])
    cfg = synth_config(args)
    assert (cfg.dataset, cfg.num_classes, cfg.image_size, cfg.batch_size, cfg.max_gt_tubes,
            cfg.warmup_steps, cfg.total_steps, cfg.learning_rate) == \
        ("synthetic", 4, 32, 2, 2, 0, 3, 1e-3)
    syn = SyntheticConfig(image_size=32, num_frames=cfg.total_frames, num_classes=4,
                          max_boxes=2)
    loader = tloader.DataLoader(SyntheticClips(syn, 6, 1000), cfg, shuffle=False, seed=1)
    for step, got in enumerate(loader.epoch(0)):
        want = jpipe.build_model_batch(make_batch(1000 + step * 2, 2, syn),
                                       JAX_PRESETS["ucf_3step"].replace(
                                           **{f: getattr(cfg, f) for f in (
                                               "dataset", "num_classes", "image_size",
                                               "batch_size", "max_gt_tubes")}),
                                       train=True, seed=1000 + step * 2, emit_uint8=True)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
