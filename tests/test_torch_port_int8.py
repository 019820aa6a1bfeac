"""AdamW with int8 blockwise moments (`adam_moments="int8"`) in the PyTorch
port against the JAX package's `train/optim_int8.py`, on the CPU.

  * `quantize_blockwise`: the same blocks give the same absmax scales and
    the same codes, except where PyTorch's float32 `log` and XLA's differ
    by an ulp and move a value across a rounding boundary: at most one
    level apart, on at most 0.1% of the elements. The round trip keeps the
    log code's relative bound (`tests/test_optim_int8.py:25`): half a log
    step in range, clamped up to the range floor below it, zeros exact.
  * The optimizer over 1-D tensors, whose elements both packages block
    alike, equals `adamw_int8` step for step on the same gradients: codes
    within one level on at most 0.1% of the elements, scales and weights
    within float32 noise (1e-6 relative).
  * The optimizer over the tiny detector's own parameters, the heads
    stacked by step as the JAX package's scan stacks them, blocks as
    `adamw_int8` does: codes, scales and weights to the 1-D bounds.
  * Three `train_step`s of the tiny detector (AdamW, lr 1e-3, warmup 2)
    against the JAX package's with `adam_moments="int8"`. The blocks hold
    the same elements, but the whole step's gradients differ in float
    noise where they are near zero, and Adam turns those into steps of
    up to lr of either sign (the float32 AdamW's recorded difference).
    The bound is the one set when the port blocked in its own layout:
    every weight within 2 lr (measured 1.59 lr; 1.57 before the JAX
    blocking), 99% of them within 0.15 lr (0.076; 0.095), the mean gap
    under 0.03 lr (0.0054; 0.020); losses within 1e-4 relative.
  * The checkpoint round-trips the int8 state bit for bit, and the state
    takes about 2.03 bytes a parameter.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.data.pipeline import build_model_batch
from step_tpu.data.synthetic import SyntheticConfig, make_batch
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.train import optim_int8 as joptim
from step_tpu.train.trainer import TrainState as JaxTrainState
from step_tpu.train.trainer import make_optimizer as jax_make_optimizer
from step_tpu.train.trainer import train_step as jax_train_step
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch import PRESETS
from step_tpu_torch.convert import from_jax_variables
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.train import optim_int8
from step_tpu_torch.train.trainer import (Optimizer, batch_to_device, create_train_state,
                                          make_schedule, train_step)
from step_tpu_torch.utils.checkpoint import restore_checkpoint, save_checkpoint

TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32, frames_per_chunk=2,
            compute_dtype="float32", batch_size=2, warmup_steps=2, total_steps=50,
            num_classes=4, max_gt_tubes=2, dropout_rate=0.0, adam_moments="int8")


def _values(rng, n, signed):
    mag = 10.0 ** rng.uniform(-9, 1, size=n)            # ten decades
    x = mag * rng.choice([-1.0, 1.0], size=n) if signed else mag
    x[rng.rand(n) < 0.05] = 0.0                          # exact zeros
    return x.astype(np.float32)


def _close_codes(got: np.ndarray, want: np.ndarray):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(), (d > 0).mean())


@pytest.mark.parametrize("signed", [True, False])
def test_codes_equal_the_jax_package(signed):
    rng = np.random.RandomState(0)
    x = _values(rng, 256 * 4000, signed)
    jq = joptim.quantize_blockwise(jnp.asarray(x), signed=signed)
    q, scale = optim_int8.quantize_blockwise(torch.from_numpy(x).view(-1, 256), signed)
    assert q.dtype == (torch.int8 if signed else torch.uint8)
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jq.scale))
    _close_codes(q.numpy(), np.asarray(jq.q))
    # the same codes dequantize to the JAX package's values
    back = optim_int8.dequantize_blockwise(torch.from_numpy(np.array(jq.q)), scale)
    want = np.asarray(joptim.dequantize_blockwise(jq, x.shape))
    np.testing.assert_allclose(back.numpy().reshape(-1), want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("signed,R,L", [(True, optim_int8.R_SIGNED, 127),
                                        (False, optim_int8.R_UNSIGNED, 255)])
def test_round_trip_keeps_the_log_bound(signed, R, L):
    rng = np.random.RandomState(1)
    x = torch.from_numpy(_values(rng, 256 * 64, signed)).view(-1, 256)
    back = optim_int8.dequantize_blockwise(*optim_int8.quantize_blockwise(x, signed))
    half_step = np.exp(R / (2 * (L - 1))) - 1.0 + 1e-6
    floor = x.abs().amax(dim=1, keepdim=True) * np.exp(-R)
    in_range = x.abs() >= floor
    rel = (back - x).abs() / torch.clamp(x.abs(), min=1e-37)
    assert float(rel[in_range].max()) <= half_step
    below = ~in_range & (x != 0)
    assert below.any()
    assert torch.equal(torch.sign(back[below]), torch.sign(x[below]))
    assert bool((back[below].abs() >= x[below].abs()).all())
    assert bool((back[below].abs() <= (floor.expand_as(x)[below] * (1 + half_step))).all())
    assert torch.equal(back[x == 0], torch.zeros(int((x == 0).sum())))


def test_optimizer_equals_adamw_int8_on_one_dimensional_tensors():
    rng = np.random.RandomState(2)
    sizes = (300, 256, 513, 17)
    cfg = PRESETS["ucf_3step"].replace(adam_moments="int8", learning_rate=1e-2,
                                       warmup_steps=0, total_steps=100)
    schedule = make_schedule(cfg)
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     joptim.adamw_int8(lambda step: schedule(int(step)),
                                       weight_decay=cfg.weight_decay))
    init = [rng.randn(n).astype(np.float32) for n in sizes]
    jparams = {str(i): jnp.asarray(p) for i, p in enumerate(init)}
    jstate = tx.init(jparams)
    params = [torch.from_numpy(p.copy()) for p in init]
    opt = Optimizer(cfg)
    state = opt.init(params, [str(i) for i in range(len(params))])
    for _ in range(10):
        grads = [(rng.randn(n) * 10.0 ** rng.uniform(-4, 0)).astype(np.float32)
                 for n in sizes]
        updates, jstate = tx.update({str(i): jnp.asarray(g) for i, g in enumerate(grads)},
                                    jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update(params, [torch.from_numpy(g) for g in grads], state)
    jmoments = jstate[1][0]
    for i, (p, (leaf, first, n)) in enumerate(zip(params, state["leaves"])):
        assert leaf == str(i)
        np.testing.assert_allclose(p.numpy(), np.asarray(jparams[str(i)]), rtol=1e-6,
                                   atol=1e-7)
        rows = slice(first, first + n)
        for key, leaf in (("mu", jmoments.mu[str(i)]), ("nu", jmoments.nu[str(i)])):
            _close_codes(state[key][rows].numpy(), np.asarray(leaf.q))
            np.testing.assert_allclose(state[key + "_scale"][rows].numpy(),
                                       np.asarray(leaf.scale), rtol=1e-6)
    assert state["count"] == 10


def _torch_leaf(path) -> str:
    """The port's leaf name (`optim_int8.leaf_name`) of a JAX parameter
    path, as `convert.from_jax_variables` names its tensors."""
    name = {"kernel": "weight", "scale": "weight", "bias": "bias"}[path[-1]]
    if path[0] == "steps":                       # steps/head/…, stacked by step
        return ".".join(("steps", "*") + path[2:-1] + (name,))
    return ".".join(path[:-1] + (name,))


def _jax_blocks(state, tree):
    """A JAX moment tree's codes and scales, each leaf on the rows the
    port's state gives that leaf (`state["leaves"]`) → (codes, scales) as
    the port's buffers hold them, and the number of stacked head leaves."""
    rows = {leaf: slice(first, first + n) for leaf, first, n in state["leaves"]}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, joptim._Quantized))
    assert len(flat) == len(rows)
    codes = np.zeros((sum(n for *_, n in state["leaves"]), 256), np.int32)
    scales = np.zeros(codes.shape[0], np.float32)
    for path, leaf in flat:
        name = _torch_leaf(tuple(str(k.key) for k in path))
        codes[rows[name]] = np.asarray(leaf.q)
        scales[rows[name]] = np.asarray(leaf.scale)
    return codes, scales, sum(name.startswith("steps.*.") for name in rows)


def test_optimizer_blocks_the_detector_as_adamw_int8_does():
    """The tiny detector's own parameters, the per-step heads stacked by
    the scan in the JAX tree, through the port's optimizer and
    `adamw_int8` on the same gradients, three steps at lr 1e-2: each JAX
    leaf's blocks hold the same elements in the port's buffers (conv
    kernels DHWIO, Dense weights [in, out], the heads' steps concatenated,
    padded once), so the codes are within one level on at most 0.1% of
    the elements and the scales within 1e-6 relative after every step,
    the bounds of the 1-D test. The weights are within 1e-6 relative too,
    except where a code differed at an earlier step (PyTorch's float32
    `log` and XLA's differ by an ulp: 0 to 1 of 637,952 codes a step
    here, measured): Adam then reads that moment one level (at most 7.6%)
    apart, which moves the weight by at most that share of lr a step;
    those elements are at most 0.1% and within 0.25 lr. The
    gradients stay under the clip norm: the float32 sums of 308,923
    squares in XLA's order and in PyTorch's differ by up to 3e-6 relative
    (measured), and a clip would scale every gradient by that noise."""
    rng = np.random.RandomState(3)
    jcfg = JAX_PRESETS["ucf_3step"].replace(**TINY)
    jparams = init_detector_cpu(jcfg, jax.random.PRNGKey(0), JaxDetector(jcfg))["params"]
    cfg = PRESETS["ucf_3step"].replace(**TINY).replace(learning_rate=1e-2, warmup_steps=0)
    model = STEPDetector(cfg)
    model.load_state_dict(from_jax_variables({"params": jparams}, cfg), strict=False)
    names = [n for n, _ in model.named_parameters()]
    params = [p.detach().clone() for _, p in model.named_parameters()]
    schedule = make_schedule(cfg)
    tx = optax.chain(optax.clip_by_global_norm(10.0),
                     joptim.adamw_int8(lambda step: schedule(int(step)),
                                       weight_decay=cfg.weight_decay))
    jstate = tx.init(jparams)
    opt = Optimizer(cfg)
    state = opt.init(params, names)
    moved = np.zeros(state["mu"].numel(), bool)     # blocked places a code differed
    for _ in range(3):
        # the weights, before this step reads the moments
        excused = torch.from_numpy(moved)[opt.index.long()].numpy()
        jgrads = jax.tree_util.tree_map(
            lambda p: (rng.randn(*p.shape) * 10.0 ** rng.uniform(-5, -2)).astype(np.float32),
            jparams)
        assert float(optax.global_norm(jgrads)) < 10.0
        updates, jstate = tx.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        grads = from_jax_variables({"params": jgrads}, cfg)
        opt.update(params, [grads[n] for n in names], state)
        for key, tree in (("mu", jstate[1][0].mu), ("nu", jstate[1][0].nu)):
            codes, scales, stacked = _jax_blocks(state, tree)
            _close_codes(state[key].numpy(), codes)
            np.testing.assert_allclose(state[key + "_scale"].numpy(), scales, rtol=1e-6)
            moved |= (state[key].numpy().astype(np.int32) != codes).reshape(-1)
        want = from_jax_variables({"params": jparams}, cfg)
        got = np.concatenate([p.numpy().reshape(-1) for p in params])
        ref = np.concatenate([want[n].numpy().reshape(-1) for n in names])
        assert excused.mean() <= 1e-3
        np.testing.assert_allclose(got[~excused], ref[~excused], rtol=1e-6, atol=1e-7)
        assert np.abs(got[excused] - ref[excused]).max(initial=0.0) <= 0.25 * 1e-2
    assert stacked > 0 and state["count"] == 3


@pytest.fixture(scope="module")
def start():
    jcfg = JAX_PRESETS["ucf_3step"].replace(**TINY)
    variables = init_detector_cpu(jcfg, jax.random.PRNGKey(0), JaxDetector(jcfg))
    syn = SyntheticConfig(image_size=32, num_frames=jcfg.total_frames, num_classes=4,
                          max_boxes=2)
    batch = build_model_batch(make_batch(0, jcfg.batch_size, syn), jcfg, train=True)
    return jcfg, variables, {k: v for k, v in batch.items() if k != "meta"}


def test_three_train_steps_track_the_jax_package(start):
    jcfg, variables, batch = start
    cfg = PRESETS["ucf_3step"].replace(**TINY)
    tx = jax_make_optimizer(jcfg)
    jstate = JaxTrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    jmodel = JaxDetector(jcfg)
    jstep = jax.jit(lambda s, b, r: jax_train_step(s, b, r, jcfg, jmodel))
    model = STEPDetector(cfg)
    model.load_state_dict(from_jax_variables(variables, cfg))
    state = create_train_state(cfg, model=model, device="cpu")
    tbatch = batch_to_device(batch, "cpu")
    for _ in range(3):
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(1))
        state, m = train_step(state, tbatch, cfg)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    want = from_jax_variables({"params": jstate.params,
                               "batch_stats": jstate.batch_stats}, cfg)
    got = state.model.state_dict()
    lr = make_schedule(cfg)(2)
    d = torch.cat([(got[k] - w).abs().reshape(-1) for k, w in want.items()
                   if "running_" not in k])
    assert float(d.max()) <= 2 * lr
    assert float(d.quantile(0.99)) <= 0.15 * lr
    assert float(d.mean()) <= 0.03 * lr
    assert state.opt_state["mu"].dtype == torch.int8 and state.opt_state["count"] == 3


def test_checkpoint_round_trips_the_int8_state(start, tmp_path):
    _, _, batch = start
    cfg = PRESETS["ucf_3step"].replace(**TINY)
    state = create_train_state(cfg, seed=0, device="cpu")
    tbatch = batch_to_device(batch, "cpu")
    for _ in range(2):
        state, _ = train_step(state, tbatch, cfg)
    n = sum(p.numel() for p in state.trainable())
    size = optim_int8.state_bytes(state.opt_state)
    assert 2.03 * n <= size <= 2.03125 * (n + 256 * len(state.trainable()))
    save_checkpoint(str(tmp_path), state)
    fresh, _ = restore_checkpoint(str(tmp_path), create_train_state(cfg, seed=1, device="cpu"))
    assert fresh.opt_state["count"] == state.opt_state["count"] == 2
    for key in ("mu", "mu_scale", "nu", "nu_scale"):
        a, b = fresh.opt_state[key], state.opt_state[key]
        assert a.dtype == b.dtype and torch.equal(a, b), key
    assert int((state.opt_state["mu"] != 0).sum()) > 0
    # the restored run takes the same next step
    fresh, _ = train_step(fresh, tbatch, cfg)
    state, _ = train_step(state, tbatch, cfg)
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_checkpoint_refuses_int8_moments_blocked_in_the_old_layout(tmp_path):
    """A checkpoint written before the moments took the JAX package's
    blocking (the optimizer state without a layout) is refused with the
    reason, not restored into blocks that hold other elements."""
    cfg = PRESETS["ucf_3step"].replace(**TINY)
    state = create_train_state(cfg, seed=0, device="cpu")
    save_checkpoint(str(tmp_path), state)
    path = tmp_path / "0.pt"
    payload = torch.load(path)
    assert payload["opt_state"]["layout"] == optim_int8.LAYOUT
    assert "index" not in payload["opt_state"]
    payload["opt_state"] = {k: payload["opt_state"][k]
                            for k in ("count", "mu", "mu_scale", "nu", "nu_scale")}
    torch.save(payload, path)
    fresh = create_train_state(cfg, seed=1, device="cpu")
    with pytest.raises(ValueError, match="blocked in torch's own layout"):
        restore_checkpoint(str(tmp_path), fresh)
    # nothing was loaded: the fresh state keeps its own weights and moments
    assert fresh.opt_state["layout"] == optim_int8.LAYOUT and fresh.step == 0
