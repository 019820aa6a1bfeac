"""The JAX package's orbax checkpoints read by the port
(`step_tpu_torch/utils/jax_checkpoint.py`, `utils/checkpoint.py`) on the
CPU, at tiny depth in float32.

For float32 AdamW, `adam_moments="int8"` and SGD, the JAX package trains
one step (warmup-cosine applies lr 0 at step 0, so the step moves the
moments and the BatchNorm statistics) and writes its checkpoint with its
own `save_checkpoint`. The port's `restore_checkpoint` reads it into a
fresh state:

  * weights and BatchNorm statistics equal the JAX state's after
    `from_jax_variables` bit for bit; AdamW moments and the SGD trace
    likewise, through their parameter's transform; int8 codes and block
    scales equal per element (the port's gathered through its blocking
    index, the JAX package's leaf by leaf); the step counts, `step` and
    `data_iter` equal;
  * the port's optimizer and the JAX package's optax chain, each from its
    restored state, take one step on the same gradients to the same
    weights within 1e-6 (the same float32 operations);
  * one port `train_step` then matches the JAX package's next step at
    `test_torch_port_train_step.py`'s tolerances (losses 1e-5 relative,
    `grad_norm` 1e-4, BatchNorm statistics 5e-5, SGD weights 1e-6, Adam
    weights within 2 lr), but for the share of Adam weights beyond 1e-6,
    which is bound at 0.2% here, not 0.1%. Where a gradient is at the level
    of float noise between the two backends, Adam turns that noise into a
    step of up to lr either way. There each backend's own two steps agree
    in sign with themselves (step 0 has lr 0, so step 1 sees the same
    weights and batch); here the port steps on the JAX package's moments
    with its own gradient, which they do not fit: measured 402 of 308,923
    weights beyond 1e-6 with float32 moments (0.13%) and 568 with int8
    (0.18%), where the JAX moment `nu` is ~1e-13 against a median of
    ~1e-8. The optimizer check above holds the moments themselves.

`cli.test --ckpt-dir` on a JAX run's orbax directory prints what it prints
on the `<step>.pt` that `convert_jax_checkpoint` writes from it, and
without `tensorstore` the reader raises an ImportError that names it.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import contextlib
import io
import os
import pickle
import sys

import jax
import numpy as np
import pytest
import torch

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.data.pipeline import build_model_batch
from step_tpu.data.synthetic import SyntheticConfig, make_batch
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.train.trainer import TrainState as JaxTrainState
from step_tpu.train.trainer import create_train_state as jax_create_train_state
from step_tpu.train.trainer import make_optimizer as jax_make_optimizer
from step_tpu.train.trainer import train_step as jax_train_step
from step_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch import PRESETS
from step_tpu_torch.cli import test as cli_test
from step_tpu_torch.convert import from_jax_variables, to_jax_variables
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.train.optim_int8 import BLOCK
from step_tpu_torch.train.trainer import (batch_to_device, create_train_state,
                                          make_schedule, train_step)
from step_tpu_torch.utils import jax_checkpoint
from step_tpu_torch.utils.checkpoint import checkpoint_steps, restore_checkpoint
from tests.test_cli_e2e import TINY_SET

TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32, frames_per_chunk=2,
            compute_dtype="float32", batch_size=2, warmup_steps=2, total_steps=50,
            num_classes=4, max_gt_tubes=2, dropout_rate=0.0)
VARIANTS = {"adamw": {}, "int8": {"adam_moments": "int8"}, "sgd": {"optimizer": "sgd"}}
DATA_ITER = {"epoch": 1, "batch_index": 3}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """variant → the JAX package's run: its state after one step (saved
    as an orbax checkpoint) and after a second, the second step's metrics,
    the checkpoint directory and the batch. Each variant runs once."""
    jcfg0 = JAX_PRESETS["ucf_3step"].replace(**TINY)
    variables = init_detector_cpu(jcfg0, jax.random.PRNGKey(0), JaxDetector(jcfg0))
    syn = SyntheticConfig(image_size=32, num_frames=jcfg0.total_frames, num_classes=4,
                          max_boxes=2)
    batch = build_model_batch(make_batch(0, jcfg0.batch_size, syn), jcfg0, train=True)
    batch = {k: v for k, v in batch.items() if k != "meta"}
    runs = {}

    def run(variant):
        if variant not in runs:
            jcfg = JAX_PRESETS["ucf_3step"].replace(**TINY, **VARIANTS[variant])
            tx = jax_make_optimizer(jcfg)
            state = JaxTrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                                  params=variables["params"],
                                  batch_stats=variables["batch_stats"],
                                  opt_state=tx.init(variables["params"]), tx=tx)
            model = JaxDetector(jcfg)
            step = jax.jit(lambda s, b, r: jax_train_step(s, b, r, jcfg, model))
            first, _ = step(state, batch, jax.random.PRNGKey(1))
            ckpt = str(tmp_path_factory.mktemp(variant) / "ckpt")
            jax_save_checkpoint(ckpt, first, DATA_ITER)
            second, metrics = step(first, batch, jax.random.PRNGKey(1))
            runs[variant] = dict(first=first, second=second, ckpt=ckpt, batch=batch,
                                 metrics={k: np.asarray(v) for k, v in metrics.items()})
        return runs[variant]

    return run


def _restored(variant, jax_runs):
    cfg = PRESETS["ucf_3step"].replace(**TINY, **VARIANTS[variant])
    state = create_train_state(cfg, model=STEPDetector(cfg), device="cpu")
    run = jax_runs(variant)
    state, data_iter = restore_checkpoint(run["ckpt"], state)
    return cfg, state, data_iter, run


def _tree(state, what):
    return jax.tree.map(np.asarray, what(state))


def _jax_int8(params, quantized, what: str):
    """The JAX package's int8 moment (per leaf `{q, scale}`) element by
    element, in its parameters' shapes: each element's code ("q") or its
    block's scale ("scale")."""
    def expand(p, leaf):
        n = np.size(p)
        if what == "q":
            return np.asarray(leaf.q).reshape(-1)[:n].astype(np.float32).reshape(p.shape)
        return np.repeat(np.asarray(leaf.scale), BLOCK)[:n].reshape(p.shape)

    return jax.tree.map(expand, params, quantized)


def _port_int8(codes, scales, index, trainable):
    """The port's int8 moment element by element, one (codes, scales) pair
    a trainable tensor: the flat blocks gathered along the blocking
    index."""
    idx = index.long()
    sizes = [p.numel() for p in trainable]
    c = codes.reshape(-1)[idx].to(torch.float32).split(sizes)
    s = scales[idx // BLOCK].split(sizes)
    return [(a.view(p.shape), b.view(p.shape)) for a, b, p in zip(c, s, trainable)]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_orbax_checkpoint_restores_bit_for_bit(variant, jax_runs):
    cfg, state, data_iter, run = _restored(variant, jax_runs)
    first = run["first"]
    assert state.step == 1 and data_iter == DATA_ITER
    want = from_jax_variables({"params": _tree(first, lambda s: s.params),
                               "batch_stats": _tree(first, lambda s: s.batch_stats)}, cfg)
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    for key in want:
        assert torch.equal(got[key], want[key]), key
    names, trainable = state.trainable_names(), state.trainable()
    opt = state.opt_state
    assert opt["count"] == 1
    if variant == "sgd":
        trace = from_jax_variables({"params": _tree(first, lambda s: s.opt_state[1][1][0].trace)},
                                   cfg)
        assert not all(float(t.abs().max()) == 0 for t in opt["trace"])
        for name, t in zip(names, opt["trace"]):
            assert torch.equal(t, trace[name]), name
        return
    adam = first.opt_state[1][0]
    assert int(adam.count) == 1
    if variant == "adamw":
        for moment in ("mu", "nu"):
            tree = from_jax_variables({"params": _tree(adam, lambda a: getattr(a, moment))},
                                      cfg)
            assert not all(float(t.abs().max()) == 0 for t in opt[moment])
            for name, t in zip(names, opt[moment]):
                assert t.dtype == torch.float32 and torch.equal(t, tree[name]), \
                    (moment, name)
        return
    params = _tree(first, lambda s: s.params)
    for moment in ("mu", "nu"):
        quantized = getattr(adam, moment)
        codes = from_jax_variables({"params": _jax_int8(params, quantized, "q")}, cfg)
        scales = from_jax_variables({"params": _jax_int8(params, quantized, "scale")}, cfg)
        mine = _port_int8(opt[moment], opt[f"{moment}_scale"], state.optimizer.index,
                          trainable)
        assert any(bool((c != 0).any()) for c, _ in mine)
        for name, (c, s) in zip(names, mine):
            assert torch.equal(c, codes[name]) and torch.equal(s, scales[name]), \
                (moment, name)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_optimizer_step_after_restore_equals_optax(variant, jax_runs):
    import optax

    cfg, state, _, run = _restored(variant, jax_runs)
    first = run["first"]
    names, trainable = state.trainable_names(), state.trainable()
    rng = np.random.RandomState(7)
    grads = [torch.from_numpy((rng.randn(*p.shape) * 1e-3).astype(np.float32))
             for p in trainable]
    state.optimizer.update(trainable, grads, state.opt_state)
    jgrads = to_jax_variables(dict(zip(names, grads)))["params"]
    tx = first.tx

    @jax.jit
    def step(grads, opt_state, params):
        return optax.apply_updates(params, tx.update(grads, opt_state, params)[0])

    want = from_jax_variables(
        {"params": _tree(step(jgrads, first.opt_state, first.params), lambda t: t)}, cfg)
    before = from_jax_variables({"params": _tree(first, lambda s: s.params)}, cfg)
    moved = 0
    for name, p in zip(names, trainable):
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=0,
                                   atol=1e-6, err_msg=name)
        moved += int((want[name] != before[name]).sum())
    assert moved > 0


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_step_after_restore_matches_jax(variant, jax_runs):
    cfg, state, _, run = _restored(variant, jax_runs)
    state, m = train_step(state, batch_to_device(run["batch"], "cpu"), cfg)
    jm, tm = run["metrics"], {k: v.numpy() for k, v in m.items()}
    for key in ("loss", "cls_loss_per_step", "reg_loss_per_step"):
        np.testing.assert_allclose(tm[key], jm[key], rtol=1e-5, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(tm["num_positive_per_step"], jm["num_positive_per_step"])
    np.testing.assert_allclose(tm["grad_norm"], jm["grad_norm"], rtol=1e-4)
    second = run["second"]
    want = from_jax_variables({"params": _tree(second, lambda s: s.params),
                               "batch_stats": _tree(second, lambda s: s.batch_stats)}, cfg)
    got = state.model.state_dict()
    lr = make_schedule(cfg)(1)
    assert lr > 0 and state.step == 2
    far, total = 0, 0
    for key, w in want.items():
        g = got[key]
        if "running_" in key:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=5e-5, err_msg=key)
            continue
        d = (g - w).abs()
        if variant == "sgd":
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=key)
        else:
            assert float(d.max()) <= 2 * lr * (1 + 1e-3), key
            far += int((d > 1e-6).sum())
        total += d.numel()
    assert far <= 2e-3 * total, f"{far} of {total} weights beyond 1e-6"


CLI_SET = ["--set", "num_classes=2", "--set", "image_size=32", *TINY_SET]


def test_test_cli_reads_a_jax_run_as_its_conversion(tmp_path):
    """A fresh JAX train state of the CLI's config saved by the JAX package
    (the orbax directory), and that directory converted to the port's
    `<step>.pt`: `cli.test` prints the same on both."""
    from step_tpu.utils.cli import apply_overrides as jax_apply_overrides
    from step_tpu_torch.data.synthetic import write_ucf_layout
    from step_tpu_torch.utils.cli import apply_overrides

    root = str(tmp_path / "ucf")
    write_ucf_layout(root, 2, num_classes=2, image_size=32, frames_lo=8, frames_hi=10, seed=1)
    sets = [CLI_SET[i + 1] for i, a in enumerate(CLI_SET) if a == "--set"]
    tiny = dict(backbone_depth="tiny", feature_stride=8)
    jcfg = jax_apply_overrides(JAX_PRESETS["ucf_3step"].replace(**tiny), sets)
    cfg = apply_overrides(PRESETS["ucf_3step"].replace(**tiny), sets)
    orbax_dir, pt_dir = str(tmp_path / "orbax"), str(tmp_path / "pt")
    jax_save_checkpoint(orbax_dir, jax_create_train_state(jcfg, jax.random.PRNGKey(3)),
                        DATA_ITER)
    assert jax_checkpoint.convert_jax_checkpoint(orbax_dir, pt_dir, cfg) == 0
    assert checkpoint_steps(pt_dir) == [0] and not checkpoint_steps(orbax_dir)

    def test_cli(ckpt):
        buf = io.StringIO()
        dump = str(tmp_path / f"{os.path.basename(ckpt)}.pkl")
        with contextlib.redirect_stdout(buf):
            results = cli_test.main(["--data-root", root, "--ckpt-dir", ckpt, "--device",
                                     "cpu", "--dump", dump, "--set", "score_thresh=0.0",
                                     *CLI_SET])
        with open(dump, "rb") as f:
            return results, buf.getvalue(), pickle.load(f)["detections"]

    got, out, dets = test_cli(orbax_dir)
    want, out_pt, dets_pt = test_cli(pt_dir)
    assert f"restored step 0 from {orbax_dir}" in out
    assert got.keys() == want.keys() and len(dets) == len(dets_pt) > 0
    for key in set(want) - {"timings"}:                   # seconds differ
        assert got[key] == want[key] or (got[key] != got[key] and want[key] != want[key]), key
    for a, b in zip(dets, dets_pt):
        assert a[:3] == b[:3] and np.array_equal(a[3], b[3])


def test_reader_names_tensorstore_where_it_is_missing(jax_runs, monkeypatch):
    monkeypatch.setitem(sys.modules, "tensorstore", None)
    with pytest.raises(ImportError, match="tensorstore.*convert_jax_checkpoint"):
        jax_checkpoint.read_orbax_checkpoint(jax_runs("adamw")["ckpt"])
    with pytest.raises(FileNotFoundError):
        jax_checkpoint.read_orbax_checkpoint(os.path.dirname(jax_runs("adamw")["ckpt"]))
