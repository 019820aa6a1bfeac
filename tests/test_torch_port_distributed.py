"""The port's data parallelism over two processes: a gloo group of two
ranks on the CPU (`tests/_torch_dist_worker.py`, spawned once for the
file, one torch thread each, importing no JAX), held against the port's
one-process runs on the same global batch and against the JAX package's
`make_parallel_train_step` over two of conftest's virtual CPU devices.

The global batch is 8 clips made from a numpy seed; rank r takes rows
r::2 (`process_shard`'s order). The weights are the JAX package's
training init, carried across by `from_jax_variables`. Tolerances:
- the two ranks: metrics and weights equal bit for bit (one all-reduce
  gives both the same sums, and both take the same optimizer step);
- against the one-process step of the port: loss, per-step losses and
  `grad_norm` within 1e-5 relative, positives exactly; BatchNorm running
  statistics within 1e-6 (sums of two halves against one mean); the
  weights after AdamW within 1e-6 but for at most 0.1% of them, and every
  one within 2 lr (`tests/test_torch_port_train_step.py` explains why);
- against the JAX package's parallel step: the same, with the BatchNorm
  statistics within `test_train_step_matches_jax`'s 5e-5.
`fit` over three steps: losses 1e-5 relative, BatchNorm statistics 1e-4
relative and 1e-5 absolute (the weights they follow differ by the AdamW
noise), weights
within 2 lr a step.
Evaluation over the two ranks returns what the unsharded run returns, the
padded rows of the last batch dropped: the same detections and tubes in
the same order, with the same keys and classes; scores within 1e-5 and
boxes within 1e-4 px, the float noise between the CPU's convolutions of a
batch of 4 rows and of 8 (`tests/test_torch_port_eval.py`'s bounds); mAPs
within 1e-6.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import os
import pickle
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.data.synthetic import SyntheticConfig, make_batch
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.parallel.mesh import create_mesh as jax_create_mesh
from step_tpu.parallel.mesh import replicated_sharding, shard_batch
from step_tpu.train.trainer import TrainState as JaxTrainState
from step_tpu.train.trainer import make_optimizer as jax_make_optimizer
from step_tpu.train.trainer import make_parallel_train_step as jax_parallel_step
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch.convert import from_jax_variables
from step_tpu_torch.data.pipeline import build_model_batch
from step_tpu_torch.evaluate import collect_detections, collect_video_tubes, evaluate_ucf
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.train.fit import fit
from step_tpu_torch.train.trainer import (batch_to_device, create_train_state,
                                          make_schedule, train_step)
import _torch_dist_worker as worker

WORLD = 2
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_torch_dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Ranks:
    """The two workers, started when the file's first test asks for them;
    `results()` waits for both and reads what each wrote."""

    def __init__(self, workdir):
        self.workdir = workdir
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = worker.REPO + os.pathsep + env.get("PYTHONPATH", "")
        port = _free_port()
        self.procs = [subprocess.Popen(
            [sys.executable, WORKER, str(port), str(r), str(WORLD), str(workdir)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]
        self._results = None

    def results(self):
        if self._results is None:
            for p in self.procs:
                out, _ = p.communicate(timeout=600)
                assert p.returncode == 0, out[-4000:]
            self._results = [torch.load(self.workdir / f"rank{r}.pt", weights_only=False)
                             for r in range(WORLD)]
        return self._results

    def close(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """(the JAX package's initial variables, the global batch, the workers)."""
    workdir = tmp_path_factory.mktemp("ranks")
    jcfg = JAX_PRESETS["ucf_3step"].replace(**worker.TRAIN)
    variables = init_detector_cpu(jcfg, jax.random.PRNGKey(0), JaxDetector(jcfg))
    torch.save(from_jax_variables(variables, worker.train_cfg("plain")), workdir / "init.pt")
    cfg = worker.train_cfg("plain")
    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=cfg.max_gt_tubes)
    batch = build_model_batch(make_batch(0, cfg.batch_size, syn), cfg, train=True)
    batch = {k: v for k, v in batch.items() if k != "meta"}
    np.savez(workdir / "batch.npz", **batch)
    ranks = Ranks(workdir)
    yield variables, batch, ranks
    ranks.close()


def _one_process(variant, start):
    """The port's one-process step of `variant` on the global batch →
    (metrics, state_dict)."""
    variables, batch, _ = start
    cfg = worker.train_cfg(variant)
    model = STEPDetector(cfg)
    model.load_state_dict(from_jax_variables(variables, cfg))
    state = create_train_state(cfg, model=model, device="cpu")
    state, metrics = train_step(state, batch_to_device(batch, "cpu"), cfg)
    return metrics, state.model.state_dict()


def _hold(got_metrics, got_state, want_metrics, want_state, cfg, stats_atol):
    """Two steps' results within the file's tolerances."""
    for key in ("loss", "cls_loss_per_step", "reg_loss_per_step", "grad_norm"):
        np.testing.assert_allclose(np.asarray(got_metrics[key]), np.asarray(want_metrics[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_array_equal(np.asarray(got_metrics["num_positive_per_step"]),
                                  np.asarray(want_metrics["num_positive_per_step"]))
    lr = make_schedule(cfg)(0)
    assert lr > 0
    far, total = 0, 0
    for key, w in want_state.items():
        g = got_state[key]
        if "running_" in key:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=stats_atol,
                                       err_msg=key)
            continue
        d = (g - w).abs()
        assert float(d.max()) <= 2 * lr * (1 + 1e-3), key
        far += int((d > 1e-6).sum())
        total += d.numel()
    assert far <= 1e-3 * total, f"{far} of {total} weights beyond 1e-6"


@pytest.mark.parametrize("variant", sorted(worker.VARIANTS))
def test_ranks_take_the_same_step(variant, start):
    """Both ranks report the same metrics and end on the same weights and
    BatchNorm statistics, bit for bit."""
    r0, r1 = (r[variant] for r in start[2].results())
    for k in r0["metrics"]:
        assert torch.equal(r0["metrics"][k], r1["metrics"][k]), k
    for k in r0["state"]:
        assert torch.equal(r0["state"][k], r1["state"][k]), k


@pytest.mark.parametrize("variant", sorted(worker.VARIANTS))
def test_two_ranks_take_the_one_process_step(variant, start):
    """The two-rank step is the one-process step on the global batch:
    BatchNorm's statistics are the global batch's, the dropout masks the
    global batch's rows `rank::2` ("dropout", rate 0.3), and with
    `grad_accum_steps=2` micro-batch i is every rank's i-th slice, rows
    [4i, 4i + 4) of the global batch ("accum2", ROADMAP §3)."""
    want = _one_process(variant, start)
    got = start[2].results()[0][variant]
    _hold(got["metrics"], got["state"], *want, worker.train_cfg(variant), 1e-6)


def test_two_ranks_take_the_jax_packages_parallel_step(start):
    """The two-rank step equals the JAX package's `make_parallel_train_step`
    on the same global batch over a 2-device mesh."""
    variables, batch, ranks = start
    jcfg = JAX_PRESETS["ucf_3step"].replace(**worker.TRAIN)
    tx = jax_make_optimizer(jcfg)
    jstate = JaxTrainState(step=jax.numpy.zeros((), jax.numpy.int32),
                           params=variables["params"], batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]), tx=tx)
    mesh = jax_create_mesh((WORLD,), devices=jax.devices()[:WORLD])
    pstep = jax_parallel_step(jcfg, JaxDetector(jcfg), mesh)
    jstate, jm = pstep(jax.device_put(jstate, replicated_sharding(mesh)),
                       shard_batch(batch, mesh), jax.random.PRNGKey(1))
    cfg = worker.train_cfg("plain")
    want = from_jax_variables({"params": jstate.params, "batch_stats": jstate.batch_stats},
                              cfg)
    got = ranks.results()[0]["plain"]
    _hold(got["metrics"], got["state"], {k: np.asarray(v) for k, v in jm.items()}, want,
          cfg, 5e-5)


class _GlobalBatches:
    """The loader of the one-process run: batch k is the ranks' batches k
    interleaved, row i of rank r at i·world + r, which is where
    `process_shard` took it from."""

    def __init__(self):
        self.loaders = [worker.fit_loader(WORLD, r) for r in range(WORLD)]

    def epoch(self, epoch, start=0):
        for parts in zip(*(ld.epoch(epoch, start) for ld in self.loaders)):
            out = {}
            for k in parts[0]:
                if k != "meta":
                    out[k] = np.stack(list(v[k] for v in parts), axis=1).reshape(
                        -1, *parts[0][k].shape[1:])
            yield out


def test_two_rank_fit_is_the_one_process_fit(start, tmp_path):
    """`fit(mesh=...)` over `DataLoader(process_count=2, ...)`: the same
    steps, losses (1e-5) and weights (the AdamW bound, three steps) as
    `fit` on the interleaved global batches; only rank 0 wrote checkpoints
    and metrics."""
    results = start[2].results()
    cfg = worker.fit_cfg()
    want = fit(cfg, _GlobalBatches(), device="cpu", seed=worker.FIT_SEED,
               log_dir=str(tmp_path))
    workdir = start[2].workdir
    assert [r["fit"]["step"] for r in results] == [worker.FIT_STEPS] * WORLD
    assert sorted(os.listdir(workdir / "fit")) == ["2.pt", "3.pt"]
    assert os.path.exists(workdir / "fit_log0" / "metrics.jsonl")
    assert not os.path.exists(workdir / "fit_log1")
    read = lambda p: [eval(line) for line in open(p)]  # noqa: E731
    for g, w in zip(read(workdir / "fit_log0" / "metrics.jsonl"),
                    read(tmp_path / "metrics.jsonl")):
        assert g["step"] == w["step"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
    lr = max(make_schedule(cfg)(s) for s in range(worker.FIT_STEPS))
    for k, w in want.model.state_dict().items():
        g = results[0]["fit"]["state"][k]
        assert torch.equal(g, results[1]["fit"]["state"][k]), k
        if "running_" in k:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
        else:
            assert float((g - w).abs().max()) <= 2 * worker.FIT_STEPS * lr * (1 + 1e-3), k


def test_sigterm_in_one_rank_stops_both_after_the_same_step(start):
    """SIGTERM raised in rank 1 alone: both ranks stop after the same step,
    short of the end, and rank 0's checkpoint is at that step."""
    results = start[2].results()
    stopped = {r["fit_stop"]["step"] for r in results}
    assert len(stopped) == 1
    step = stopped.pop()
    assert 1 <= step < worker.FIT_STEPS
    assert f"{step}.pt" in os.listdir(start[2].workdir / "fit_stop")


SCORE_TOL, BOX_TOL, MAP_TOL = 1e-5, 1e-4, 1e-6


def _same_detections(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        assert abs(g[2] - w[2]) <= SCORE_TOL
        np.testing.assert_allclose(g[3], w[3], rtol=0, atol=BOX_TOL)


def test_two_rank_evaluate_ucf_equals_the_unsharded_run(start):
    """15 windows, batches of 8 and 7 (padded to 8): the same detections in
    the same order, and the same mAPs."""
    results = start[2].results()
    model, _ = worker.eval_models()
    want_path = start[2].workdir / "dets_unsharded.pkl"
    want = evaluate_ucf(model, worker.eval_data(), dump_path=str(want_path))
    with open(want_path, "rb") as f:
        want_dets = pickle.load(f)["detections"]
    assert len(want_dets) > 0
    for r, res in enumerate(results):
        got = res["evaluate_ucf"]
        assert sorted(got) == sorted(want)
        for k in want:
            if k != "timings":
                np.testing.assert_allclose(got[k], want[k], rtol=0, atol=MAP_TOL, err_msg=k)
        assert got["timings"]["n_detections"] == want["timings"]["n_detections"]
        with open(start[2].workdir / f"dets{r}.pkl", "rb") as f:
            _same_detections(pickle.load(f)["detections"], want_dets)


def _same_tubes(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[:2] == w[:2] and sorted(g[3]) == sorted(w[3])
        assert abs(g[2] - w[2]) <= SCORE_TOL
        for f in w[3]:
            np.testing.assert_allclose(g[3][f], w[3][f], rtol=0, atol=BOX_TOL)


def test_two_rank_video_tubes_equal_the_unsharded_run(start):
    """`collect_video_tubes` over the two ranks (clip batch 16, 5 windows a
    video) links the tubes the unsharded run links."""
    results = start[2].results()
    model, _ = worker.eval_models()
    want = collect_video_tubes(model, worker.eval_data())
    for res in results:
        _same_tubes(res["video_tubes"], want)


def test_two_rank_late_fusion_equals_the_unsharded_run(start):
    """The late-fusion collector (`model_flow`) over the two ranks."""
    results = start[2].results()
    model, model_flow = worker.eval_models()
    want = collect_detections(model, worker.eval_data(with_flow=True), model_flow=model_flow)
    for res in results:
        _same_detections(res["late_fusion"], want)


def test_workers_import_nothing_of_the_jax_package(start):
    assert [r["imported"] for r in start[2].results()] == [[]] * WORLD
