"""One training step of the port against the JAX package's `train_step`,
on the same weights (bridged by `from_jax_variables`) and the same batch,
in float32 on the CPU: AdamW, SGD, `grad_accum_steps=2` and a frozen
backbone.

The detector is tiny (depth "tiny", 32 px, 2-frame chunks, 3 refinement
steps with temporal extension), dropout 0, warmup 2. Two steps run, since
warmup-cosine applies lr 0 at step 0 (as optax does): the first moves only
the optimizer state and the BatchNorm statistics, the second the weights.

Tolerances, from the spread measured between XLA's and PyTorch's CPU
kernels on this detector: loss and per-step losses 1e-5 relative, the
positive counts exactly, `grad_norm` 1e-4 relative; BatchNorm running
statistics 5e-5 absolute (measured up to 8.5e-6); the weights after SGD
1e-6 absolute (measured 1.3e-7). After AdamW every weight is within 1e-6
of the JAX package's but for at most 0.1% of the elements (measured: 97
of 308,923): where a gradient is at the level of float noise between the
two backends (an activation that is a hair above 0 in one and exactly 0,
a tie of the max pools, in the other), Adam's normalization turns that
noise into a step of up to lr in either direction, and those elements
stay within 2 lr. A frozen subtree is bit for bit unchanged in both.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import jax
import numpy as np
import pytest
import torch

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.data.pipeline import build_model_batch
from step_tpu.data.synthetic import SyntheticConfig, make_batch
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.train.trainer import TrainState as JaxTrainState
from step_tpu.train.trainer import make_optimizer as jax_make_optimizer
from step_tpu.train.trainer import train_step as jax_train_step
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch import PRESETS
from step_tpu_torch.convert import from_jax_variables
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.train.trainer import (batch_to_device, create_train_state,
                                          make_schedule, train_step)

TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32, frames_per_chunk=2,
            compute_dtype="float32", batch_size=2, warmup_steps=2, total_steps=50,
            num_classes=4, max_gt_tubes=2, dropout_rate=0.0)
VARIANTS = {
    "adamw": {},
    "sgd": {"optimizer": "sgd"},
    "accum2": {"grad_accum_steps": 2},
    "frozen_features": {"freeze_submodules": ("features",)},
}
STEPS = 2


@pytest.fixture(scope="module")
def start():
    """The JAX package's initial variables and one training batch."""
    cfg = JAX_PRESETS["ucf_3step"].replace(**TINY)
    variables = init_detector_cpu(cfg, jax.random.PRNGKey(0), JaxDetector(cfg))
    syn = SyntheticConfig(image_size=32, num_frames=cfg.total_frames, num_classes=4,
                          max_boxes=2)
    batch = build_model_batch(make_batch(0, cfg.batch_size, syn), cfg, train=True)
    return variables, {k: v for k, v in batch.items() if k != "meta"}


def _run_both(variant, start):
    over = dict(TINY, **VARIANTS[variant])
    jcfg = JAX_PRESETS["ucf_3step"].replace(**over)
    cfg = PRESETS["ucf_3step"].replace(**over)
    variables, batch = start
    tx = jax_make_optimizer(jcfg)
    jstate = JaxTrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                           params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jmodel = JaxDetector(jcfg)
    jstep = jax.jit(lambda s, b, r: jax_train_step(s, b, r, jcfg, jmodel))
    model = STEPDetector(cfg)
    initial = from_jax_variables(variables, cfg)
    model.load_state_dict(initial)
    state = create_train_state(cfg, model=model, device="cpu")
    tbatch = batch_to_device(batch, "cpu")
    metrics = []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(1))
        state, m = train_step(state, tbatch, cfg)
        metrics.append(({k: np.asarray(v) for k, v in jm.items()},
                        {k: v.numpy() for k, v in m.items()}))
    after = from_jax_variables({"params": jstate.params,
                                "batch_stats": jstate.batch_stats}, cfg)
    return cfg, initial, after, state.model.state_dict(), metrics


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_matches_jax(variant, start):
    cfg, initial, want, got, metrics = _run_both(variant, start)
    for jm, tm in metrics:
        assert sorted(jm) == sorted(tm)
        for key in ("loss", "cls_loss_per_step", "reg_loss_per_step"):
            np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, atol=1e-6,
                                       err_msg=key)
        np.testing.assert_array_equal(tm["num_positive_per_step"],
                                      jm["num_positive_per_step"])
        np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
        assert tm["grad_norm"] > 0
    lr = make_schedule(cfg)(1)
    assert lr > 0
    frozen = tuple(cfg.freeze_submodules)
    far, total = 0, 0
    for key, w in want.items():
        g = got[key]
        if key.startswith(frozen):
            assert torch.equal(g, initial[key]) and torch.equal(w, initial[key]), key
            continue
        if "running_" in key:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=5e-5,
                                       err_msg=key)
            assert not torch.equal(w, initial[key]), f"{key} was not updated"
            continue
        d = (g - w).abs()
        if cfg.optimizer == "sgd":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6,
                                       err_msg=key)
        else:
            assert float(d.max()) <= 2 * lr * (1 + 1e-3), key
            far += int((d > 1e-6).sum())
        total += d.numel()
    assert far <= 1e-3 * total, f"{far} of {total} weights beyond 1e-6"
