"""The port's data-parallel pieces in one process: `process_shard`, the
loader's per-process slices and `pad_batch_to` against the JAX package's;
`create_mesh`'s refusals; and on a one-rank gloo mesh, `make_global_batch`,
the parallel detection (single stream and late fusion) against
`detect_clip`, the parallel train step against `train_step`, and a sharded
`evaluate_ucf` against the unsharded run. Two ranks:
`tests/test_torch_port_distributed.py`.

Tolerances: the copies of the JAX package's numpy code exactly; on one
rank the shard is the whole batch, so detection and evaluation equal the
plain run bit for bit; the one-rank train step normalizes with BatchNorm's
sums over the group where `train_step` takes means, so its loss, per-step
losses and `grad_norm` agree within 1e-6 relative and the BatchNorm
statistics within 1e-6, and the weights within the AdamW bound of
`tests/test_torch_port_train_step.py` (2 lr, at most 0.1% beyond 1e-6).
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import numpy as np
import pytest
import torch
import torch.distributed as dist

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.data.loader import DataLoader as JaxDataLoader
from step_tpu.inference import pad_batch_to as jax_pad_batch_to
from step_tpu.parallel.distributed import process_shard as jax_process_shard
from step_tpu_torch import PRESETS
from step_tpu_torch.data.loader import DataLoader
from step_tpu_torch.data.synthetic import SyntheticConfig, make_batch
from step_tpu_torch.evaluate import evaluate_ucf
from step_tpu_torch.inference import (detect_clip, detect_clip_late_fusion,
                                      make_parallel_detect_fn,
                                      make_parallel_late_fusion_detect_fn, pad_batch_to)
from step_tpu_torch.parallel import create_mesh, make_global_batch, process_shard
from step_tpu_torch.data.pipeline import build_model_batch
from step_tpu_torch.train.trainer import (batch_to_device, create_train_state,
                                          make_parallel_train_step, make_schedule,
                                          train_step)
from step_tpu_torch.train_eval_synth import SyntheticClips
import _torch_dist_worker as worker


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo mesh on the CPU; the group is left as found."""
    created = not dist.is_initialized()
    yield create_mesh(device_type="cpu")
    if created:
        dist.destroy_process_group()


@pytest.mark.parametrize("n,count", [(103, 4), (8, 2), (7, 2), (3, 4)])
def test_process_shard_equals_jax(n, count):
    for index in range(count):
        np.testing.assert_array_equal(process_shard(n, count, index),
                                      jax_process_shard(n, count, index))


@pytest.mark.parametrize("drop_last", [True, False])
def test_two_process_loaders_equal_jax(drop_last):
    """Each process's batches of a two-process epoch, as the JAX package's
    `DataLoader(process_count=2, ...)` gives them, and the same length on
    both."""
    over = dict(worker.FIT, gt_jitter_proposals=2)
    jcfg, cfg = JAX_PRESETS["ucf_3step"].replace(**over), PRESETS["ucf_3step"].replace(**over)
    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=cfg.max_gt_tubes)
    data = SyntheticClips(syn, 11, 0)
    lengths = set()
    for index in range(2):
        kw = dict(batch_size=2, seed=3, num_workers=1, drop_last=drop_last,
                  process_count=2, process_index=index)
        want = list(JaxDataLoader(data, jcfg, **kw).epoch(1))
        loader = DataLoader(data, cfg, **kw)
        got = list(loader.epoch(1))
        assert len(got) == len(want) == len(loader)
        lengths.add(len(loader))
        for g, w in zip(got, want):
            for k in w:
                if k != "meta":
                    np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert len(lengths) == 1


@pytest.mark.parametrize("b,multiple", [(5, 2), (8, 4), (1, 3)])
def test_pad_batch_to_equals_jax(b, multiple):
    x = np.random.RandomState(b).rand(b, 3, 2).astype(np.float32)
    np.testing.assert_array_equal(pad_batch_to(x, multiple), jax_pad_batch_to(x, multiple))


def test_create_mesh_refuses_what_the_world_cannot_hold(mesh):
    assert mesh.size() == 1 and mesh.mesh_dim_names == ("data",)
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        create_mesh((2,), device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device_type='cpu'"):
            create_mesh()


def test_make_global_batch_puts_the_rows_on_the_rank_device(mesh):
    batch = {"rgb": np.zeros((4, 3), np.uint8), "meta": ["x"] * 4}
    out = make_global_batch(batch, mesh)
    assert isinstance(out["rgb"], torch.Tensor) and out["rgb"].device.type == "cpu"
    assert out["rgb"].shape == (4, 3) and out["meta"] == ["x"] * 4


def _clips(cfg, B, flow=False):
    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=2)
    raw = make_batch(5, B, syn)
    batch = build_model_batch(raw, cfg, train=False)
    out = [torch.from_numpy(batch[k]) for k in ("rgb", "proposals", "prop_mask")]
    if flow:
        from step_tpu_torch.data.synthetic import make_flow

        out.append(torch.from_numpy(np.stack([make_flow(c) for c in raw["rgb"]])))
    return out


def test_parallel_detection_on_one_rank_equals_detect_clip(mesh):
    model, model_flow = worker.eval_models()
    rgb, props, pmask, flow = _clips(model.cfg, 3, flow=True)
    got = make_parallel_detect_fn(model.cfg, mesh)(model, rgb, props, pmask)
    want = detect_clip(model, rgb, props, pmask)
    got_lf = make_parallel_late_fusion_detect_fn(model.cfg, mesh)(
        model, model_flow, rgb, flow, props, pmask)
    want_lf = detect_clip_late_fusion(model, model_flow, rgb, flow, props, pmask)
    for g, w in ((got, want), (got_lf, want_lf)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].device.type == "cpu" and torch.equal(g[k], w[k]), k
    with pytest.raises(ValueError, match="two-stream"):
        make_parallel_detect_fn(model.cfg, mesh)(model, rgb, props, pmask, flow)


def test_parallel_train_step_on_one_rank_equals_train_step(mesh):
    cfg = worker.train_cfg("dropout")
    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=cfg.max_gt_tubes)
    batch = batch_to_device(build_model_batch(make_batch(0, 4, syn), cfg, train=True), "cpu")
    plain = create_train_state(cfg, seed=0, device="cpu")
    _, want = train_step(plain, batch, cfg)
    state = create_train_state(cfg, seed=0, device="cpu")
    _, got = make_parallel_train_step(cfg, state.model, mesh)(state, batch)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, err_msg=k)
    lr = make_schedule(cfg)(0)
    far, total = 0, 0
    for k, w in plain.model.state_dict().items():
        g = state.model.state_dict()[k]
        if "running_" in k:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-6, err_msg=k)
            continue
        d = (g - w).abs()
        assert float(d.max()) <= 2 * lr * (1 + 1e-3), k
        far += int((d > 1e-6).sum())
        total += d.numel()
    assert far <= 1e-3 * total
    assert all(m.batch_group is None for m in state.model.modules()
               if hasattr(m, "batch_group")) and state.model.data_shard is None


@pytest.mark.parametrize("device_linking", [False, True])
def test_sharded_evaluate_ucf_on_one_rank_equals_the_unsharded_run(mesh, device_linking):
    model, _ = worker.eval_models()
    data = worker.eval_data()
    want = evaluate_ucf(model, data, device_linking=device_linking)
    got = evaluate_ucf(model, data, device_linking=device_linking, mesh=mesh)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "timings":
            for c in ("n_detections", "n_tubes"):
                assert got[k][c] == want[k][c]
        else:
            assert got[k] == want[k] or (np.isnan(got[k]) and np.isnan(want[k])), k
