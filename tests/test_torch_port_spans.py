"""The port's spans (`step_tpu_torch/utils/spans.py`) on the CPU, at tiny
depth in float32:

  * with no profiler `span()` returns the shared null context and builds
    no `record_function` (made to raise here) through a `detect_clip` and
    a `train_step`;
  * under the profiler a `detect_clip` opens `model.preprocess`,
    `model.backbone`, `model.refine` and `detect.nms` once each,
    `model.stem` once inside `model.backbone` (the I3D stem unit),
    `model.head` and `model.boxes` once a refinement step inside
    `model.refine`, and `model.context` once with the scene context and
    never without it; over the ViT backbone (`models/vit.py`)
    `model.attention` and `model.mlp` once a block inside `model.backbone`;
    over MViTv2 (`models/mvit.py`) `model.stem` once (the patch embedding)
    and `model.attn_pool`, `model.attention` and `model.mlp` once a block,
    in that order, inside `model.backbone`; over Video Swin
    (`models/swin.py`) `model.stem` once (the patch embedding and its
    norm), and a block's `model.window`, `model.attention`,
    `model.window` and `model.mlp`, in that order, inside `model.backbone`;
  * a `train_step` opens each `train.*` span once (`train.reduce` in the
    data-parallel step, which gives the step its reduction), and with
    `grad_accum_steps=2` `train.forward`, `train.loss` and
    `train.backward` twice;
  * `DataLoader.epoch` opens one `loader.wait` a batch;
  * `kernels.library()` opens `setup.kernels` once, and inside it
    `setup.kernels.build` where nvcc runs (stubbed here);
  * together they open every name of `SPANS` and no other;
  * under `spans.recording()`, with no profiler, each run records the
    spans, nesting and order the profiler sees, `detect.clip` once around
    a detection; with neither, nothing is recorded; under both, each span
    goes to both, and its recorded interval (`time.time_ns()`) holds the
    profiler's events opened inside it on the chrome trace's clock
    (`baseTimeNanoseconds + ts * 1000`); a span on another thread carries
    that thread's native id;
  * a detect program exported while a profiler records holds no profiler
    node;
  * `profile_request.span_ms` gives a span the device time launched
    while it was open, on any thread (autograd's backward thread too, and
    a launch no operator holds, as a ctypes launch), and the host time it
    was open; `profile_request.idle_by_span` puts each idle stretch down to
    the innermost span open over it, and its parts sum to the stretches;
  * a request of `profile_request`'s `train_dp` path opens `loader.wait`
    and `train.reduce`, which no other path opens.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import collections
import sys
import threading
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from step_tpu_torch import PRESETS, kernels, profile_request
from step_tpu_torch.data.loader import DataLoader
from step_tpu_torch.data.pipeline import build_model_batch
from step_tpu_torch.data.synthetic import SyntheticConfig, make_batch
from step_tpu_torch.inference import detect_clip
from step_tpu_torch.models.detector import STEPDetector
from step_tpu_torch.models import mvit, swin
from step_tpu_torch.models.vit import WIDTHS
from step_tpu_torch.parallel import create_mesh
from step_tpu_torch.train.trainer import (batch_to_device, create_train_state,
                                          make_parallel_train_step, train_step)
from step_tpu_torch.train_eval_synth import SyntheticClips
from step_tpu_torch.utils import export, spans
from step_tpu_torch.utils.init import init_detector_

TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32, frames_per_chunk=2,
            compute_dtype="float32")
# Training: one refinement step over one chunk, as the benches' tests cut it.
TRAIN = dict(TINY, num_chunks=1, num_steps=1, iou_thresholds=(0.4,),
             step_loss_weights=(1.0,), num_classes=4, max_gt_tubes=2, dropout_rate=0.0,
             batch_size=2, warmup_steps=0, total_steps=10)
B = 2


def _detect_inputs(cfg, seed=0):
    g = torch.Generator().manual_seed(seed)
    rgb = torch.randint(0, 256, (B, cfg.total_frames, cfg.image_size, cfg.image_size, 3),
                        dtype=torch.uint8, generator=g)
    props, mask = STEPDetector.initial_proposals(cfg, B, device="cpu")
    return rgb, props, mask


def _detect(preset, **over):
    cfg = PRESETS[preset].replace(**TINY, **over)
    model = init_detector_(STEPDetector(cfg), seed=0).eval()
    return cfg, lambda: detect_clip(model, *_detect_inputs(cfg))


def _train(**over):
    cfg = PRESETS["ucf_3step"].replace(**dict(TRAIN, **over))
    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=cfg.max_gt_tubes)
    batch = build_model_batch(make_batch(0, cfg.batch_size, syn), cfg, train=True)
    batch = batch_to_device(batch, "cpu")
    state = create_train_state(cfg, 0, device="cpu")
    return cfg, state, batch


PREFIXES = ("model.", "detect.", "train.", "loader.", "setup.")


def _traced(fn):
    """The span events `fn()` opens under the CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return [e for e in prof.events() if e.name in spans.SPANS or e.name.startswith(PREFIXES)]


def _recorded(fn):
    """The spans `fn()` records with no profiler: (name, start, end, thread)."""
    assert not torch.autograd._profiler_enabled()
    with spans.recording() as recorded:
        fn()
    return list(recorded)


def _nesting(intervals):
    """[(name, the innermost span holding it)] of `(name, start, end)` in
    the order they opened."""
    out, stack = [], []
    for name, a, b in sorted(intervals, key=lambda s: (s[1], -s[2])):
        while stack and not (stack[-1][1] <= a and b <= stack[-1][2]):
            stack.pop()
        out.append((name, stack[-1][0] if stack else None))
        stack.append((name, a, b))
    return out


class _Library:
    """A loaded library's stand-in: any symbol, its argtypes settable."""

    def __getattr__(self, name):
        symbol = types.SimpleNamespace()
        setattr(self, name, symbol)
        return symbol


def _stubbed_library(tmp, built: bool):
    """`kernels.library()` with nvcc and the loader stubbed, its library in
    `tmp`: found there where `built`, else compiled and linked by nvcc runs
    that succeed and write nothing but the library."""
    def link(cmd, **kwargs):
        open(cmd[cmd.index("-o") + 1], "wb").close()
        return types.SimpleNamespace(returncode=0, stdout="", stderr="")

    target = tmp / "libstep_kernels_stub.so"
    if built:
        target.touch()
    elif target.exists():
        target.unlink()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kernels, "BUILD_DIR", tmp)
        mp.setattr(kernels, "library_path", lambda: target)
        mp.setattr(kernels, "nvcc_path", lambda: "nvcc")
        mp.setattr(kernels.subprocess, "Popen", lambda cmd, **kwargs: types.SimpleNamespace(
            communicate=lambda: ("", None), returncode=0))
        mp.setattr(kernels.subprocess, "run", link)
        mp.setattr(kernels.ctypes, "CDLL", lambda path: _Library())
        kernels.library.cache_clear()
        try:
            return kernels.library()
        finally:
            kernels.library.cache_clear()


def _loader_run():
    cfg = PRESETS["ucf_3step"].replace(**TRAIN)
    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=cfg.max_gt_tubes)
    loader = DataLoader(SyntheticClips(syn, 6, 0), cfg, batch_size=2, num_workers=1)
    epoch = loader.epoch(0)
    try:
        return [next(epoch) for _ in range(len(loader))]
    finally:
        epoch.close()


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo mesh on the CPU; the group is left as found."""
    created = not dist.is_initialized()
    yield create_mesh(device_type="cpu")
    if created:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(mesh, tmp_path_factory):
    """Each run, by name."""
    tmp = tmp_path_factory.mktemp("kernels")
    runs = {"ucf": _detect("ucf_3step")[1], "ava": _detect("ava_3step")[1],
            "no_context": _detect("ucf_3step", use_context=False)[1],
            "vit": _detect("ava_3step", backbone="videomae_vit_b16")[1],
            "mvit": _detect("ava_3step", backbone=mvit.NAME)[1],
            "swin": _detect("ava_3step", backbone=swin.NAME)[1]}
    for name, over in (("train", {}), ("accum2", {"grad_accum_steps": 2})):
        cfg, state, batch = _train(**over)
        runs[name] = (lambda s, b, c: lambda: train_step(s, b, c))(state, batch, cfg)
    cfg, state, batch = _train()
    step = make_parallel_train_step(cfg, state.model, mesh)
    runs["parallel"] = lambda: step(state, batch)
    runs["loader"] = _loader_run
    runs["kernels"] = lambda: _stubbed_library(tmp, built=False)
    return runs


@pytest.fixture(scope="module")
def opened(runs):
    """The span events of each run under the profiler, by run."""
    return {name: _traced(fn) for name, fn in runs.items()}


@pytest.fixture(scope="module")
def recorded(runs, opened):
    """The spans each run records with no profiler, by run (after `opened`:
    each run has run once before)."""
    return {name: _recorded(fn) for name, fn in runs.items()}


def _counts(events):
    return collections.Counter(e.name for e in events)


def test_without_a_profiler_a_span_builds_nothing(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    assert spans.span("model.head") is spans.span("detect.nms") is spans._OFF
    _, run = _detect("ava_3step")
    out = run()
    assert torch.isfinite(out["tubes"]).all()
    cfg, state, batch = _train()
    _, metrics = train_step(state, batch, cfg)
    assert torch.isfinite(metrics["loss"])
    assert len(_loader_run()) == 3


@pytest.mark.parametrize("run,context", [("ucf", True), ("ava", True), ("no_context", False)])
def test_a_detection_opens_each_stage_once_and_each_step_inside_refine(opened, run, context):
    events = opened[run]
    counts = _counts(events)
    steps = PRESETS["ucf_3step"].num_steps
    assert counts == {"detect.clip": 1, "model.preprocess": 1, "model.backbone": 1,
                      "model.stem": 1, "model.refine": 1, "detect.nms": 1, "model.head": steps,
                      "model.boxes": steps, **({"model.context": 1} if context else {})}
    backbone = next(e.time_range for e in events if e.name == "model.backbone")
    stem = next(e.time_range for e in events if e.name == "model.stem")
    assert backbone.start <= stem.start <= stem.end <= backbone.end
    refine = next(e.time_range for e in events if e.name == "model.refine")
    for e in events:
        if e.name in ("model.head", "model.boxes", "model.context"):
            assert refine.start <= e.time_range.start <= e.time_range.end <= refine.end
    order = [e.name for e in sorted(events, key=lambda e: e.time_range.start)
             if e.name in ("model.preprocess", "model.backbone", "model.refine", "detect.nms")]
    assert order == ["model.preprocess", "model.backbone", "model.refine", "detect.nms"]


def test_a_vit_detection_opens_attention_and_mlp_once_a_block_inside_the_backbone(opened):
    events = opened["vit"]
    blocks = WIDTHS["tiny"][1]
    steps = PRESETS["ava_3step"].num_steps
    assert _counts(events) == {"detect.clip": 1, "model.preprocess": 1, "model.backbone": 1,
                               "model.refine": 1, "model.context": 1, "detect.nms": 1,
                               "model.head": steps, "model.boxes": steps,
                               "model.attention": blocks, "model.mlp": blocks}
    backbone = next(e.time_range for e in events if e.name == "model.backbone")
    inner = sorted((e for e in events if e.name in ("model.attention", "model.mlp")),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in inner] == ["model.attention", "model.mlp"] * blocks
    assert all(backbone.start <= e.time_range.start <= e.time_range.end <= backbone.end
               for e in inner)


def test_an_mvit_detection_opens_the_pools_attention_and_mlp_once_a_block(opened):
    events = opened["mvit"]
    blocks = len(mvit.block_plan("tiny"))
    steps = PRESETS["ava_3step"].num_steps
    assert _counts(events) == {"detect.clip": 1, "model.preprocess": 1, "model.backbone": 1,
                               "model.stem": 1, "model.refine": 1, "model.context": 1,
                               "detect.nms": 1, "model.head": steps, "model.boxes": steps,
                               "model.attn_pool": blocks, "model.attention": blocks,
                               "model.mlp": blocks}
    backbone = next(e.time_range for e in events if e.name == "model.backbone")
    inner = sorted((e for e in events if e.name in ("model.stem", "model.attn_pool",
                                                    "model.attention", "model.mlp")),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in inner] == ["model.stem"] + ["model.attn_pool", "model.attention",
                                                        "model.mlp"] * blocks
    assert all(backbone.start <= e.time_range.start <= e.time_range.end <= backbone.end
               for e in inner)


def test_a_swin_detection_opens_two_window_moves_attention_and_mlp_a_block(opened):
    events = opened["swin"]
    blocks = sum(swin.WIDTHS["tiny"][2])
    steps = PRESETS["ava_3step"].num_steps
    assert _counts(events) == {"detect.clip": 1, "model.preprocess": 1, "model.backbone": 1,
                               "model.stem": 1, "model.refine": 1, "model.context": 1,
                               "detect.nms": 1, "model.head": steps, "model.boxes": steps,
                               "model.window": 2 * blocks, "model.attention": blocks,
                               "model.mlp": blocks}
    backbone = next(e.time_range for e in events if e.name == "model.backbone")
    inner = sorted((e for e in events if e.name in ("model.stem", "model.window",
                                                    "model.attention", "model.mlp")),
                   key=lambda e: e.time_range.start)
    assert [e.name for e in inner] == ["model.stem"] + ["model.window", "model.attention",
                                                        "model.window", "model.mlp"] * blocks
    assert all(backbone.start <= e.time_range.start <= e.time_range.end <= backbone.end
               for e in inner)


@pytest.mark.parametrize("run,twice", [("train", ()), ("parallel", ()),
                                       ("accum2", ("train.forward", "train.loss",
                                                   "train.backward"))])
def test_a_train_step_opens_each_train_span(opened, run, twice):
    counts = _counts(e for e in opened[run] if e.name.startswith("train."))
    names = ["train.forward", "train.loss", "train.backward", "train.optimizer",
             "train.bn_commit"] + (["train.reduce"] if run == "parallel" else [])
    assert counts == {n: 2 if n in twice else 1 for n in names}


def test_the_loader_opens_one_wait_a_batch(opened):
    assert _counts(opened["loader"]) == {"loader.wait": 3}


def test_every_span_is_opened_and_none_other(opened):
    names = set().union(*(_counts(events) for events in opened.values()))
    assert names == set(spans.SPANS)
    assert len(spans.SPANS) == len(set(spans.SPANS))


def test_a_program_exported_under_a_profiler_holds_no_profiler_node():
    cfg = PRESETS["ucf_3step"].replace(**TINY)
    model = init_detector_(STEPDetector(cfg), seed=0).eval()
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd._profiler_enabled()
        blob = export.export_detect_fn(cfg, B, model=model, device="cpu")
    program = export.load_program(blob)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t or "record_function" in t]
    rgb, props, mask = _detect_inputs(cfg, seed=1)
    got = export.load_detect_fn(blob)(export.serving_weights(model.state_dict(), cfg, "cpu"),
                                      rgb, props, mask)
    want = detect_clip(model, rgb, props, mask)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy(), err_msg=key)


def test_a_span_gets_the_work_launched_on_any_thread_while_it_was_open():
    from step_tpu_torch.profile_request import span_ms

    corr = iter(range(1, 100))

    def ev(cat, name, ts, dur, tid=1, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
                "args": args}

    def launch(ts, us, tid=1):
        c = next(corr)
        return [ev("cuda_runtime", "cudaLaunchKernel", ts, 1, tid, correlation=c),
                ev("kernel", "k", 1000 + ts, us, 7, correlation=c)]

    events = [ev("user_annotation", "train.forward", 0, 100),
              ev("user_annotation", "model.head", 20, 40),
              ev("cpu_op", "aten::convolution", 25, 5), *launch(26, 400),
              *launch(40, 30),                              # a ctypes launch: no operator
              ev("cpu_op", "aten::add", 70, 1), *launch(70, 50),
              ev("gpu_user_annotation", "model.head", 1020, 40, 7),  # its range on the device
              ev("user_annotation", "train.backward", 100, 100),
              *launch(130, 700, tid=2),                     # on autograd's thread
              ev("user_annotation", "train.backward", 300, 100), *launch(250, 5)]
    assert span_ms(events) == {"train.forward": (0.48, 0.1, 1), "model.head": (0.43, 0.04, 1),
                               "train.backward": (0.7, 0.2, 2)}


def test_idle_stretches_go_to_the_innermost_span_open_over_them():
    from step_tpu_torch.profile_request import idle_by_span

    spans_ = [("request", 0, 100), ("detect.clip", 10, 80), ("model.backbone", 20, 40),
              ("model.refine", 50, 70), ("model.boxes", 60, 65)]
    gaps = [(5, 15), (30, 45), (55, 62), (64, 90), (120, 130)]
    idle = idle_by_span(spans_, gaps)
    assert idle == {"request": 5 + 10, "detect.clip": 5 + 5 + 10, "model.backbone": 10,
                    "model.refine": 5 + 5, "model.boxes": 2 + 1, "outside spans": 10}
    assert sum(idle.values()) == sum(b - a for a, b in gaps)
    assert idle_by_span([], gaps) == {"outside spans": 68}


def test_the_profiled_data_parallel_step_opens_the_loader_wait_and_the_reduce(mesh):
    dev = torch.device("cpu")
    cfg, state = profile_request.build("train_dp", dev,
                                       PRESETS["ucf_3step"].replace(**TRAIN))
    run, make = profile_request.request_fn("train_dp", cfg, state, 2, dev)
    run(make())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, metrics = run(make())
    assert torch.isfinite(metrics["loss"]) and state.step == 2
    times = profile_request.span_ms(profile_request.chrome_trace(prof)[0])
    for name in ("loader.wait", "train.reduce", "train.forward", "train.backward"):
        device_ms, host_ms, calls = times[name]
        assert calls == 1 and device_ms == 0.0 and host_ms > 0, (name, times[name])


def test_with_neither_a_profiler_nor_a_recording_a_span_records_nothing():
    assert not torch.autograd._profiler_enabled() and not spans._OPEN
    assert spans.span("detect.clip") is spans._OFF
    with spans.recording() as outer:
        with spans.span("detect.clip"):
            with spans.recording() as inner:
                with spans.span("model.head"):
                    pass
        assert spans.span("model.head") is not spans._OFF
    with spans.span("model.boxes"):
        pass
    assert spans.span("model.boxes") is spans._OFF and not spans._OPEN
    assert [r[0] for r in outer] == ["model.head", "detect.clip"]
    assert [r[0] for r in inner] == ["model.head"]
    name, start, end, thread = outer[1]
    assert start <= outer[0][1] <= outer[0][2] <= end and thread == threading.get_native_id()


@pytest.mark.parametrize("run", ["ucf", "ava", "no_context", "vit", "mvit", "swin", "train",
                                 "accum2", "parallel", "loader", "kernels"])
def test_a_recording_holds_the_spans_nesting_and_order_the_profiler_sees(opened, recorded, run):
    seen = [(e.name, e.time_range.start, e.time_range.end) for e in opened[run]]
    kept = [(name, start, end) for name, start, end, _ in recorded[run]]
    assert _nesting(kept) == _nesting(seen)
    if run not in ("train", "accum2", "parallel", "loader", "kernels"):
        assert _nesting(kept)[0] == ("detect.clip", None)
        assert [name for name, _, _ in kept].count("detect.clip") == 1


@pytest.mark.parametrize("built", [False, True])
def test_the_kernel_librarys_build_and_load_open_setup_kernels(tmp_path, built):
    with spans.recording() as kept:
        _stubbed_library(tmp_path, built)
    names = [name for name, *_ in sorted(kept, key=lambda r: r[1])]
    assert names == ["setup.kernels"] + ([] if built else ["setup.kernels.build"])
    _, start, end, _ = kept[-1]
    assert all(start <= a <= b <= end for _, a, b, _ in kept)
    with spans.recording() as again:
        kernels.library.cache_clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kernels, "_load", lambda: "loaded")
            assert kernels.library() == kernels.library() == "loaded"
        kernels.library.cache_clear()
    assert [r[0] for r in again] == ["setup.kernels"]


def test_recorded_spans_hold_the_profilers_events_on_one_clock():
    """A span under a profiler and a recording goes to both; on the chrome
    trace's clock each recorded interval holds the span's range and every
    operator opened in it, within 20 µs."""
    _, run = _detect("ucf_3step")
    run()
    with spans.recording() as kept:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
    events, base = profile_request.chrome_trace(prof)
    ranges = sorted((e for e in events if e.get("cat") == "user_annotation"
                     and e["name"] in spans.SPANS), key=lambda e: e["ts"])
    ops = [e for e in events if e.get("cat") == "cpu_op"]
    kept = sorted(kept, key=lambda r: r[1])
    assert [e["name"] for e in ranges] == [r[0] for r in kept] and len(kept) > 10
    slack = 20.0
    for e, (name, start, end, thread) in zip(ranges, kept):
        a, b = (start - base) / 1e3, (end - base) / 1e3
        assert e["tid"] == thread
        assert a - slack <= e["ts"] and e["ts"] + e["dur"] <= b + slack, (name, a, b, e)
        inside = [o for o in ops if o["tid"] == thread
                  and e["ts"] <= o["ts"] <= e["ts"] + e["dur"]]
        assert all(a - slack <= o["ts"] and o["ts"] + o["dur"] <= b + slack for o in inside)


def test_a_span_on_another_thread_carries_that_thread():
    def wait():
        with spans.span("loader.wait"):
            pass

    with spans.recording() as kept:
        worker = threading.Thread(target=wait)
        worker.start()
        worker.join(timeout=30)
        with spans.span("detect.clip"):
            pass
    assert not worker.is_alive()
    threads = {name: thread for name, _, _, thread in kept}
    assert threads == {"loader.wait": worker.native_id, "detect.clip": threading.get_native_id()}
    assert worker.native_id != threading.get_native_id()


def test_recordings_opened_and_closed_on_many_threads_at_once():
    """Sixteen threads each open and close 200 recordings around a span of
    their own, switching every microsecond: each recording holds its
    thread's span, and none is left open after."""
    lost = []

    def work():
        me = threading.get_native_id()
        for _ in range(200):
            with spans.recording() as mine:
                with spans.span("loader.wait"):
                    pass
            if not any(thread == me for _, _, _, thread in mine):
                lost.append(me)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(w.is_alive() for w in workers)
    assert not lost and spans._OPEN == ()
