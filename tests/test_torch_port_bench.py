"""The port's benches (`step_tpu_torch/bench.py`, `bench_train.py`,
`bench_stream.py`, `bench_linking_stream.py`) on the CPU, at tiny depth:

  * each `main(argv)` with `--device cpu` prints one JSON line with the JAX
    bench's fields, less the TPU-only ones (listed by name here), plus the
    port's own; the values are finite, `device` names the CPU and no device
    metric is written (`mfu` is null);
  * the workload is `bench.py`'s: the same `RandomState(0)` clip bit for
    bit, and the JAX package's initial proposals and mask;
  * three chained requests (each fed the previous tubes) of the port's
    `optimize_for_inference` tree against the JAX package's `detect_clip`
    on its `optimize_for_inference` tree, the weights bridged by
    `from_jax_variables`, in float32: tubes within 1e-3 px and scores
    within 1e-4, as `test_torch_port_detect.py` holds one request;
  * the FLOP count: the same in both serving configurations, linear in the
    batch, K3's registered formula equal to aten's convolution count, and a
    train step's count 2-4x the forward's;
  * the refusals of the TPU-only flags and of `--iters 2`, and that no bench
    runs (nor prints JSON) without a card unless `--device cpu`;
  * one `fit()` arm of `bench_train`.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import contextlib
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from step_tpu.config import PRESETS as JAX_PRESETS
from step_tpu.inference import detect_clip as jax_detect_clip
from step_tpu.models.detector import STEPDetector as JaxDetector
from step_tpu.models.optimize import optimize_for_inference as jax_optimize
from step_tpu.utils.init import init_detector_cpu
from step_tpu_torch import PRESETS, bench, bench_linking_stream, bench_stream, bench_train
from step_tpu_torch.convert import from_jax_variables
from step_tpu_torch.inference import detect_clip
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.models.optimize import optimize_for_inference
from step_tpu_torch.ops.conv3d import conv3x3x3_bn_relu
from step_tpu_torch.profile_request import build
from step_tpu_torch.train.trainer import batch_to_device, create_train_state

TINY_SET = "backbone_depth=tiny,feature_stride=8,image_size=32,compute_dtype=float32"
# The training runs are cut further: one refinement step over one chunk.
TRAIN_SET = (TINY_SET + ",frames_per_chunk=2,num_chunks=1,num_steps=1,"
             "iou_thresholds=(0.4,),step_loss_weights=(1.0,)")
TINY = PRESETS["ucf_3step"].replace(backbone_depth="tiny", feature_stride=8,
                                    image_size=32, compute_dtype="float32")

# The JAX benches' JSON fields (`bench.py:271-307`, `bench_train.py:284-307`,
# `scripts/bench_linking_stream.py:158-172`), the TPU-only ones, and the
# port's own additions. `scripts/bench_stream.py` prints no JSON: its
# lines' numbers are the port's fields.
JAX_FIELDS = {
    "bench": {"metric", "value", "unit", "vs_baseline", "vs_baseline_denominator", "mfu",
              "p50_latency_ms", "p90_latency_ms", "latency_chained_mean_ms",
              "latency_readback_overhead_ms", "latency_semantics", "batch",
              "compiler_options_applied", "latency_vmem_arm", "compile_s", "config",
              "device"},
    "bench_train": {"metric", "value", "unit", "step_ms", "timed_steps", "mfu",
                    "fit_clips_per_sec", "fit_step_ms", "fit_clips_per_sec_prefetch",
                    "batch", "overrides", "scan_unroll", "remat_steps",
                    "freeze_submodules", "vmem_limit_kib", "vmem_applied", "compile_s",
                    "config", "device"},
    "bench_stream": set(),
    "bench_linking_stream": {"metric", "clips", "clip_batch", "detect_ms_per_video",
                             "link_ms_per_video", "link_share_pct",
                             "clips_per_sec_end_to_end", "link_ms_by_bucket", "memory",
                             "config", "device"},
}
TPU_ONLY = {
    "bench": {"compiler_options_applied", "latency_vmem_arm"},
    "bench_train": {"scan_unroll", "vmem_limit_kib", "vmem_applied"},
    "bench_stream": set(),
    "bench_linking_stream": set(),
}
PORT_FIELDS = {
    "bench": {"request_flops", "request_ms_median", "iters", "peak_memory_gib",
              "cudnn_benchmark", "overrides"},
    "bench_train": {"step_flops", "peak_memory_gib"},
    "bench_stream": {"metric", "chunks", "clip_batch", "iters", "stream_ms_per_video",
                     "stream_clips_per_sec", "per_clip_ms_per_video",
                     "per_clip_clips_per_sec", "speedup", "stem_ms", "refine_nms_ms",
                     "config", "overrides", "device"},
    "bench_linking_stream": {"iters", "overrides"},
}
# Fields that hold a device metric, null on the CPU.
DEVICE_ONLY = {"mfu", "request_ms_median", "peak_memory_gib"}
MODULES = {"bench": bench, "bench_train": bench_train, "bench_stream": bench_stream,
           "bench_linking_stream": bench_linking_stream}
ARGV = {
    "bench": ["--batch", "2", "--iters", "3", "--set", TINY_SET],
    "bench_kernel": ["--config", "kernel", "--batch", "2", "--iters", "3",
                     "--set", TINY_SET],
    "bench_train": ["--batch", "2", "--iters", "3", "--skip-fit", "--set", TRAIN_SET],
    "bench_stream": ["--chunks", "4", "--clip-batch", "3", "--iters", "2", "--decompose",
                     "--set", TINY_SET],
    "bench_linking_stream": ["--clips", "5", "--clip-batch", "3", "--buckets", "4",
                             "--iters", "2", "--set", TINY_SET],
}


def run_main(module, argv):
    """(exit code, standard output) of `module.main(argv)`."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = module.main(argv)
    return rc, buf.getvalue()


@pytest.fixture(scope="module")
def results():
    """Each bench's JSON from one CPU run (both serving configurations)."""
    out = {}
    for key, argv in ARGV.items():
        rc, text = run_main(MODULES[key.split("_kernel")[0]], argv + ["--device", "cpu"])
        assert rc == 0, text
        out[key] = json.loads(text.strip().splitlines()[-1])
    return out


def _finite(v) -> bool:
    if isinstance(v, dict):
        return all(_finite(x) for x in v.values())
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return math.isfinite(v)
    return True


@pytest.mark.parametrize("key", list(ARGV))
def test_json_has_the_jax_fields_less_the_tpu_ones(results, key):
    name = key.split("_kernel")[0]
    rec = results[key]
    assert TPU_ONLY[name] <= JAX_FIELDS[name]
    assert set(rec) == (JAX_FIELDS[name] - TPU_ONLY[name]) | PORT_FIELDS[name]
    assert rec["device"]["name"] == "cpu" and rec["device"]["platform"] == "cpu"
    for field in DEVICE_ONLY & set(rec):
        assert rec[field] is None, field
    assert rec["metric"].endswith("_cpu")       # no device metric's name
    # every number is finite; only the device metrics (and, with --skip-fit,
    # the fit() arms) are null
    assert _finite(rec)
    nulls = {k for k, v in rec.items() if v is None}
    allowed = DEVICE_ONLY | {"overrides", "fit_clips_per_sec", "fit_step_ms",
                             "fit_clips_per_sec_prefetch"}
    assert nulls <= allowed, nulls - allowed
    if name == "bench_linking_stream":
        assert set(rec["link_ms_by_bucket"]) == {"4", "8"}    # 8 covers L=5
        assert rec["memory"] == {}


def test_configurations_count_the_same_flops(results):
    main, kernel = results["bench"], results["bench_kernel"]
    assert main["request_flops"] > 0
    assert main["request_flops"] == kernel["request_flops"]
    assert "K1-K5" in kernel["config"] and "K1, K2" in main["config"]


def test_flop_count_is_linear_in_the_batch():
    cfg, model = build("main", torch.device("cpu"), TINY)
    counts = []
    for b in (1, 2):
        rgb = bench.make_input(cfg, b, "cpu")
        props, pmask = STEPDetector.initial_proposals(cfg, b, device="cpu")
        counts.append(bench.count_flops(lambda: detect_clip(model, rgb, props, pmask)))
    assert counts[0] > 0 and counts[1] == 2 * counts[0]


@pytest.mark.parametrize("shape,K", [((2, 8, 3, 5, 5), 4), ((1, 24, 2, 7, 7), 64),
                                     ((3, 13, 4, 3, 6), 9)])
def test_k3_formula_equals_aten_convolution_count(shape, K):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).contiguous(
        memory_format=torch.channels_last_3d)
    w = torch.from_numpy(rng.randn(K, shape[1], 3, 3, 3).astype(np.float32))
    k3 = bench.count_flops(lambda: conv3x3x3_bn_relu(x, w, torch.ones(K), torch.zeros(K)))
    aten = bench.count_flops(lambda: F.conv3d(x, w, None, 1, 1))
    assert k3 == aten == 2 * math.prod(shape) * K * 27


def test_train_count_is_two_to_four_forwards():
    from step_tpu_torch.utils.cli import apply_overrides

    cfg = apply_overrides(PRESETS["ucf_3step"], [TRAIN_SET]).replace(batch_size=2)
    state = create_train_state(cfg, 0, device="cpu")
    batch = batch_to_device(bench_train.make_batches(cfg, 1)[0], "cpu")
    train = bench_train.step_flops(cfg, state.model, batch, torch.device("cpu"))
    with torch.no_grad():
        forward = bench.count_flops(
            lambda: state.model(batch["rgb"], batch["proposals"]))
    assert forward > 0 and 2 * forward < train < 4 * forward


def test_input_is_bench_py_clip_bit_for_bit():
    cfg, B = PRESETS["ucf_3step"], 2
    T, S = cfg.total_frames, cfg.image_size
    want = np.asarray(jnp.asarray(np.random.RandomState(0).rand(B, T, S, S, 3),
                                  jnp.float32))
    got = bench.make_input(cfg, B, "cpu").numpy()
    assert got.dtype == want.dtype and np.array_equal(got.view(np.uint32),
                                                      want.view(np.uint32))
    props, pmask = STEPDetector.initial_proposals(cfg, B, device="cpu")
    jprops, jmask = JaxDetector.initial_proposals(JAX_PRESETS["ucf_3step"], B)
    np.testing.assert_array_equal(props.numpy(), np.asarray(jprops))
    np.testing.assert_array_equal(pmask.numpy(), np.asarray(jmask))


def test_chained_requests_match_the_jax_bench_loop():
    """Three chained requests, each fed the previous request's tubes, as
    `bench.py::_chained_time` runs them, on both serving trees."""
    B, iters = 2, 3
    cfg = TINY.replace(image_size=64)
    variables = init_detector_cpu(cfg, jax.random.PRNGKey(0))
    rng = np.random.RandomState(1)
    params = jax.tree.map(np.asarray, variables["params"])
    reg = params["steps"]["head"]["reg"]        # so that the tubes move
    reg["kernel"] = (rng.randn(*reg["kernel"].shape) * 0.02).astype(np.float32)
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    rgb = bench.make_input(cfg, B, "cpu")
    props, pmask = JaxDetector.initial_proposals(cfg, B)

    jcfg, jvars = jax_optimize(cfg, variables)
    jmodel = JaxDetector(jcfg)
    detect = jax.jit(lambda v, r, p, m: jax_detect_clip(v, r, p, m, jcfg, jmodel))
    p = props
    for _ in range(iters):
        want = detect(jvars, jnp.asarray(rgb.numpy()), p, pmask)
        p = want["tubes"]

    pcfg, state = optimize_for_inference(cfg, from_jax_variables(variables, cfg))
    model = STEPDetector(pcfg).eval()
    model.load_state_dict(state)
    tprops, tmask = torch.tensor(np.asarray(props)), torch.tensor(np.asarray(pmask))
    _, _, got = bench.chained(lambda q: detect_clip(model, rgb, q, tmask), tprops, iters,
                              torch.device("cpu"))
    np.testing.assert_allclose(got["tubes"].numpy(), np.asarray(want["tubes"]),
                               rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["tube_scores"].numpy(), np.asarray(want["tube_scores"]),
                               rtol=0, atol=1e-4)
    assert float((got["tubes"] - tprops).abs().max()) > 1.0     # the chain moved


@pytest.mark.parametrize("name,argv,reason", [
    ("bench", ["--latency-vmem-kib", "0"], "scoped VMEM"),
    ("bench_train", ["--unroll"], "scan_unroll"),
    ("bench_train", ["--vmem-limit-kib", "32768"], "scoped VMEM"),
    ("bench_train", ["--donate-batch"], "buffer donation"),
    ("bench_train", ["--iters", "2"], "--iters must be >= 3"),
])
def test_tpu_only_flags_are_refused(name, argv, reason, capsys):
    with pytest.raises(SystemExit) as exc:
        MODULES[name].main(argv + ["--device", "cpu"])
    assert exc.value.code != 0
    captured = capsys.readouterr()
    assert reason in captured.err and captured.out == ""


@pytest.mark.parametrize("name", list(MODULES))
def test_no_card_no_run(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert MODULES[name].main([]) != 0
    captured = capsys.readouterr()
    assert captured.out == "" and "--device cpu" in captured.err


def test_fit_arm_reads_the_window_after_step_20(monkeypatch):
    from step_tpu_torch.utils.cli import apply_overrides

    monkeypatch.setattr(bench_train, "FIT_STEPS", 22)
    cfg = apply_overrides(PRESETS["ucf_3step"], [TRAIN_SET]).replace(batch_size=2)
    cps = bench_train.fit_clips_per_sec(cfg, torch.device("cpu"), prefetch_upload=True)
    assert cps is not None and cps > 0
    monkeypatch.setattr(bench_train, "FIT_STEPS", 20)   # no window after step 20
    assert bench_train.fit_clips_per_sec(cfg, torch.device("cpu"), False) is None
