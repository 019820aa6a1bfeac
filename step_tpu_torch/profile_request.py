"""Where the device time of one serving request or training step goes,
on the card.

    python3 -m step_tpu_torch.profile_request
        [--path main|kernel|video|stream|train|train_dp|train_two_stream|two_stream|ava]
        [--backbone i3d|videomae_vit_b16|mvitv2_b|swin3d_b] [--batch 8] [--requests 10]
        [--out profile.json]

Builds the detector at full width and depth with seeded weights (seed 0),
in bfloat16, in one of the serving configurations that `chip_smoke.py`
drives:

  main    `ucf_3step`, BN folded and the Inception 1x1x1 convs fused
          (`optimize_for_inference`): cuDNN convs, K1, K2, and the pool
          kernels (K5 and `ops/pool.py::max_pool3d_same`), which every
          path runs on the card;
  kernel  `ucf_3step`, weights left unfolded, `fused_bn_relu=True`: K3
          and K4 as well;
  video   `streaming` on the main path's tree: a request is one video of
          `--batch` chunks (6 frames each) tiled into as many windows one
          chunk apart, through `detect_video` (tiling_stride 6), linking
          included;
  stream  the same video through `detect_video_stream_batched` with chunk
          stems (`chunk_stem=True`), 16 windows a refinement batch;
  train   one `train_step` of `ucf_3step` (the training init, float32
          weights, bf16 compute, remat "dots", AdamW) on `--batch`
          synthetic uint8 clips already on the card;
  train_dp  the same step through a one-rank data-parallel mesh
          (`make_parallel_train_step`: NCCL on the card), each step's
          batch taken from a `DataLoader` of synthetic clips (two worker
          threads, three batches ahead) and uploaded, so that the
          `loader.wait` and `train.reduce` spans open;
  train_two_stream  the same for `two_stream_train`, both stems and the
          fusion unit trained, each clip with its int8 flow (`make_flow`);
  two_stream  `two_stream_train` on the main path's tree (both stems and
          the fusion unit folded): uint8 RGB and int8 flow;
  ava     `ava_3step` on the main path's tree: 60 sigmoid classes, the
          context branch.

`--backbone` swaps the path's preset's backbone (`cfg.backbone`): `--path
ava --backbone videomae_vit_b16` is the benchmark's `ava_videomae_b16`
detector, the ViT-B/16 of `models/vit.py` on the main path's tree,
`--backbone mvitv2_b` its `ava_mvitv2_b`, MViTv2-B of `models/mvit.py`,
and `--backbone swin3d_b` its `ava_swin3d_b`, Video Swin-B of
`models/swin.py`.

A request of `main`, `kernel` and `ava` uploads `--batch` uint8 clips,
one of `two_stream` the clips and their int8 flow, one of `video` and
`stream` a uint8 video; then it detects. For `train` it also
prints the device time under each plain backward (the stride-1 pool's and
ROI-align's autograd Functions, children included). The script serves two
warm-up requests, times `--requests` more (host clock around each
synchronized request) and prints each, their median and the peak memory
allocated from the warm-ups on, then profiles one
more with `torch.profiler` and prints that request's wall time (the
profiler adds to it), the summed device time, the busy share (device time
/ wall time), the number of kernels, how many max pools ran on each
hand-written pool kernel and on PyTorch and how many inputs the pool
kernels had to copy into `channels_last_3d` (`kernels.ndhwc.copies`), how
many Inception blocks ran as `step::inception_block` and head reductions
as `step::conv1x1x1_bias_relu` (`kernel_op.LAUNCHES`), the
device time by layer (each hand-written kernel, the tube conv and the
1x1x1 GEMM of the heads' blocks among them, cuDNN convolutions,
PyTorch pools, layout conversions, copies, other elementwise work), the
device time launched under each of the port's spans (`utils/spans.SPANS`, which any profiler
session turns on: a span's time holds the spans nested in it; a kernel belongs to the
spans open when its launch was made, so a ctypes launch counts too) beside the
host ms it was open, and the heaviest kernels by name. Last it serves one
more request under the profiler of the device alone with the spans recorded
(`spans.recording()`), a host that runs as an unprofiled one does, and prints
that request's idle device time by the innermost span the host was in
(`idle_gaps_untraced`). Needs a CUDA device; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from step_tpu_torch.utils import spans as program_spans
from step_tpu_torch.utils.spans import SPANS

# Kernel name fragments → layer, first match wins.
LAYERS = (
    ("K1 nms (csrc/nms.cu)", ("nms_groups_kernel", "nms_many_kernel")),
    ("K2 roi_align (csrc/roi_align.cu)", ("tube_roi_align_kernel",)),
    ("stem conv (csrc/stem_conv.cu)", ("stem_conv_kernel",)),
    ("tube conv (csrc/conv3d.cu)", ("tube_conv_kernel",)),
    ("1x1x1 GEMM (csrc/gemm.cu)", ("true, 1>",)),
    ("K3 conv3x3x3 (csrc/conv3d.cu)", ("igemm_kernel", "conv_f32_kernel")),
    ("K4 bn_relu (csrc/bn_relu.cu)", ("scale_bias_relu_kernel",)),
    ("K5 max_pool3x3 (csrc/pool3d.cu)", ("max_pool3x3_kernel",)),
    ("strided max pool (csrc/pool3d_same.cu)", ("max_pool3d_same_kernel",)),
    ("PyTorch pools", ("max_pool", "pool3d", "pool2d")),
    ("layout conversions", ("nhwcToNchw", "nchwToNhwc")),
    ("attention (SDPA)", ("flash", "fmha", "sdpa")),
    ("LayerNorm", ("layer_norm",)),
    ("cuDNN / cuBLAS conv and matmul", ("xmma", "implicit_gemm", "conv", "cudnn",
                                        "cutlass", "gemm", "sm90_", "sm80_")),
    ("copies", ("Memcpy", "Memset", "copy_kernel")),
)


PRESET_OF = {"main": "ucf_3step", "kernel": "ucf_3step", "train": "ucf_3step",
             "train_dp": "ucf_3step",
             "train_two_stream": "two_stream_train",
             "video": "streaming", "stream": "streaming",
             "two_stream": "two_stream_train", "ava": "ava_3step"}


def layer_of(name: str) -> str:
    for layer, keys in LAYERS:
        if any(k in name for k in keys):
            return layer
    return "other elementwise / reductions"


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def chrome_trace(prof) -> tuple[list, int]:
    """(events, baseTimeNanoseconds) of a finished profile's chrome trace:
    an event's `ts` is µs after the base."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return data["traceEvents"], int(data.get("baseTimeNanoseconds", 0))


def span_ms(events, names=SPANS) -> dict:
    """{span: (device ms, host ms, times opened)} of the spans `names` in a
    chrome trace's `events`: the device time of the work launched (the
    runtime call of the same correlation id), on any thread, while each was
    open (so a backward's, which autograd runs on a thread of its own, and a
    ctypes launch's, which no operator holds), that of the spans nested in
    it included; and the time it was open on the host (a wait launches
    nothing, so only its host ms tells)."""
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    launched = [(launch[c], e["dur"]) for e in events if e.get("cat") in DEVICE_CATS
                and (c := e.get("args", {}).get("correlation")) in launch]
    out = {}
    for s in events:
        if s.get("cat") == "user_annotation" and s["name"] in names:
            a, b = s["ts"], s["ts"] + s["dur"]
            ms, host, n = out.get(s["name"], (0.0, 0.0, 0))
            out[s["name"]] = (ms + sum(us for t, us in launched if a <= t <= b) / 1e3,
                              host + (b - a) / 1e3, n + 1)
    return out


def idle_by_span(spans, gaps) -> dict:
    """{name: time} of `gaps` (disjoint `(start, end)` pairs) put down to the
    innermost of `spans` (`(name, start, end)` of one thread, so nested, on
    the gaps' clock) open over each part of them, "outside spans" where
    none is."""
    bounds = sorted({t for _, a, b in spans for t in (a, b)} | {t for g in gaps for t in g})
    opened = sorted(spans, key=lambda s: (s[1], -s[2]))
    gaps = sorted(gaps)
    out, stack, i, k = {}, [], 0, 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(opened) and opened[i][1] <= a:
            stack.append(opened[i])
            i += 1
        while stack and stack[-1][2] <= a:
            stack.pop()
        while k < len(gaps) and gaps[k][1] <= a:
            k += 1
        if k < len(gaps) and gaps[k][0] <= a:
            inside = [s for s in stack if s[2] > a]
            name = inside[-1][0] if inside else "outside spans"
            out[name] = out.get(name, 0) + (b - a)
    return out


def recorded_idle(run, x, dev: torch.device) -> dict:
    """{span: idle device ms} of one request `run(x)` under the profiler of
    the device alone, its spans recorded on this thread: the window runs
    from a marker operation on the idle device to another after the
    request, and each idle stretch in it goes to the innermost span the
    host was in."""
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
    with program_spans.recording() as recorded:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            marker.add_(1)
            run(x)
            torch.cuda.synchronize(dev)
            marker.add_(1)
            torch.cuda.synchronize(dev)
    events, base = chrome_trace(prof)
    device = sorted(((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") in DEVICE_CATS), key=lambda ab: ab[0])
    start, end = device[0][0], max(b for _, b in device)
    gaps, t = [], start
    for a, b in device:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    main = threading.get_native_id()
    spans = [(n, (a - base) / 1e3, (b - base) / 1e3) for n, a, b, tid in recorded
             if tid == main]
    idle = idle_by_span(spans, gaps)
    return {"window_ms": (end - start) / 1e3,
            "idle_gaps_untraced": {k: v / 1e3 for k, v in
                                   sorted(idle.items(), key=lambda kv: -kv[1])}}


def build(path: str, dev: torch.device, cfg=None):
    """(config, model) of `path` on `dev`, from `cfg` where given, else the
    path's preset."""
    from step_tpu_torch import PRESETS
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.models.optimize import optimize_for_inference
    from step_tpu_torch.utils.init import init_detector_

    cfg = cfg or PRESETS[PRESET_OF[path]]
    if path.startswith("train"):
        from step_tpu_torch.train.trainer import create_train_state

        cfg = cfg.replace(dataset="synthetic", warmup_steps=2, total_steps=1000)
        return cfg, create_train_state(cfg, 0, device=dev)
    cfg = cfg.replace(chunk_stem=path == "stream")
    seeded = init_detector_(STEPDetector(cfg).eval(), 0).state_dict()
    if path == "kernel":
        cfg_run = cfg.replace(fused_bn_relu=True)
        model = STEPDetector(cfg_run).eval()
        model.load_state_dict(seeded)
        return cfg, model.to(dev)      # float32 parameters, bf16 activations
    cfg_run, state = optimize_for_inference(cfg, seeded)
    model = STEPDetector(cfg_run).eval()
    model.load_state_dict(state)
    return cfg, model.to(device=dev, dtype=getattr(torch, cfg.compute_dtype))


def request_fn(path: str, cfg, model, batch: int, dev: torch.device):
    """(one request on an input, a function making one input)."""
    from step_tpu_torch.inference import (detect_clip, detect_video,
                                          detect_video_stream_batched, window_centers)
    from step_tpu_torch.models.detector import STEPDetector

    rng = np.random.RandomState(0)
    c, S = cfg.frames_per_chunk, cfg.image_size
    if path.startswith("train"):
        from step_tpu_torch.data.pipeline import build_model_batch
        from step_tpu_torch.data.synthetic import SyntheticConfig, make_batch, make_flow
        from step_tpu_torch.train.trainer import batch_to_device, train_step

        cfg = cfg.replace(batch_size=batch)
        syn = SyntheticConfig(image_size=S, num_frames=cfg.total_frames,
                              num_classes=cfg.num_classes, max_boxes=4)
        seeds = iter(range(0, 10 ** 6, batch))

        def make():
            raw = make_batch(next(seeds), batch, syn)
            if cfg.two_stream:
                raw["flow"] = np.stack([make_flow(rgb) for rgb in raw["rgb"]])
            return batch_to_device(build_model_batch(raw, cfg, train=True,
                                                     emit_uint8=True), dev)
        if path == "train_dp":
            return data_parallel_steps(cfg, model, syn, batch, dev), lambda: None
        return (lambda b: train_step(model, b, cfg), make)
    if path in ("main", "kernel", "ava", "two_stream"):
        props, pmask = STEPDetector.initial_proposals(cfg, batch, device=dev)
        shape = (batch, cfg.total_frames, S, S)

        def clip():
            rgb = torch.from_numpy(rng.randint(0, 256, shape + (3,)).astype(np.uint8))
            if path != "two_stream":
                return rgb, None
            return rgb, torch.from_numpy(rng.randint(-127, 128, shape + (2,)).astype(np.int8))
        return (lambda x: detect_clip(model, x[0].to(dev), props, pmask,
                                      None if x[1] is None else x[1].to(dev)), clip)
    make = lambda: torch.from_numpy(  # noqa: E731
        rng.randint(0, 256, (batch * c, S, S, 3)).astype(np.uint8))
    if path == "stream":
        return (lambda x: detect_video_stream_batched(model, x.to(dev), clip_batch=16),
                make)
    centers = window_centers(batch, cfg, device=dev)

    def video(x):
        chunks = x.to(dev).reshape(batch, c, S, S, 3)
        windows = chunks[centers].reshape(batch, cfg.total_frames, S, S, 3)
        return detect_video(model, windows, tiling_stride=c)
    return video, make


def data_parallel_steps(cfg, state, syn, batch: int, dev: torch.device):
    """A request of `train_dp`: the next batch of an endless `DataLoader`
    over synthetic clips (seeded from 0), uploaded, then one step of
    `make_parallel_train_step` on a one-rank mesh of `dev`'s kind. The
    request's argument is unused."""
    from step_tpu_torch.data.loader import DataLoader
    from step_tpu_torch.parallel import create_mesh
    from step_tpu_torch.train.trainer import batch_to_device, make_parallel_train_step
    from step_tpu_torch.train_eval_synth import SyntheticClips

    step = make_parallel_train_step(cfg, state.model, create_mesh(device_type=dev.type))
    loader = DataLoader(SyntheticClips(syn, 4 * batch, 0), cfg, batch_size=batch,
                        num_workers=2, prefetch=3, emit_uint8=True)
    batches = itertools.chain.from_iterable(map(loader.epoch, itertools.count()))
    return lambda _: step(state, batch_to_device(next(batches), dev))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=tuple(PRESET_OF), default="main")
    ap.add_argument("--backbone", default=None,
                    help="the preset's backbone swapped for this one (cfg.backbone)")
    ap.add_argument("--batch", type=int, default=8,
                    help="clips a request (main, kernel) or chunks a video (video, stream)")
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None, help="also write the result as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this profile runs only on the card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from step_tpu_torch.kernels import ndhwc
    from step_tpu_torch.ops.kernel_op import LAUNCHES

    def pool_counts():
        return (LAUNCHES["max_pool3x3_same"], LAUNCHES["max_pool3d_same"], ndhwc.copies,
                LAUNCHES["inception_block"], LAUNCHES["conv1x1x1_bias_relu"])

    from step_tpu_torch import PRESETS

    dev = torch.device("cuda", 0)
    cfg = PRESETS[PRESET_OF[args.path]]
    cfg, model = build(args.path, dev, cfg.replace(backbone=args.backbone or cfg.backbone))
    run, make = request_fn(args.path, cfg, model, args.batch, dev)
    inputs = [make() for _ in range(3)]
    request_ms = []
    torch.cuda.reset_peak_memory_stats(dev)
    with contextlib.nullcontext() if args.path.startswith("train") else torch.no_grad():
        for x in inputs[:2]:
            run(x)
        for i in range(args.requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(inputs[i % 3])
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
        peak = torch.cuda.max_memory_allocated(dev)
        before = pool_counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(inputs[2])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        after = pool_counts()
        spans = span_ms(chrome_trace(prof)[0])     # before another profile clears it
        recorded = recorded_idle(run, inputs[2], dev)

    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        # a span's range on the device (`is_user_annotation`) is no kernel
        if (us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA
                and not evt.is_user_annotation):
            ms, n = kernels.get(evt.key, (0.0, 0))
            kernels[evt.key] = (ms + us / 1e3, n + evt.count)
    device_ms = sum(ms for ms, _ in kernels.values())
    backwards = {}
    for evt in prof.key_averages():
        for fn in ("_MaxPoolS1SepGradBackward", "_TubeRoiAlignBackward"):
            if fn in evt.key and evt.device_type == torch.autograd.DeviceType.CPU:
                us = getattr(evt, "device_time_total", None)
                if us is None:
                    us = evt.cuda_time_total
                ms, n = backwards.get(fn, (0.0, 0))
                backwards[fn] = (ms + us / 1e3, n + evt.count)
    if device_ms == 0.0:
        print("the profiler recorded no device time", file=sys.stderr)
        return 1
    layers = {}
    for name, (ms, n) in kernels.items():
        ms0, n0 = layers.get(layer_of(name), (0.0, 0))
        layers[layer_of(name)] = (ms0 + ms, n0 + n)
    k5, strided, copies, blocks, reductions = (a - b for a, b in zip(after, before))
    pools = {"max_pool3x3_same": k5, "max_pool3d_same": strided,
             "pytorch": sum(n for name, (_, n) in kernels.items()
                            if layer_of(name) == "PyTorch pools"),
             "ndhwc_copies": copies}
    operators = {"inception_block": blocks, "conv1x1x1_bias_relu": reductions}
    result = {
        "device": torch.cuda.get_device_name(0), "path": args.path, "backbone": cfg.backbone,
        "batch": args.batch, "request_ms": request_ms,
        "request_ms_median": float(np.median(request_ms)) if request_ms else None,
        "memory_peak_bytes": peak, "wall_ms": wall_ms, "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "kernels": sum(n for _, n in kernels.values()),
        "pools": pools,
        "operators": operators,
        "backwards": {k: {"ms": ms, "calls": n} for k, (ms, n) in backwards.items()},
        "spans": {k: {"ms": spans[k][0], "host_ms": spans[k][1], "calls": spans[k][2]}
                  for k in SPANS if k in spans},
        "layers": {k: {"ms": ms, "calls": n, "share": ms / device_ms}
                   for k, (ms, n) in sorted(layers.items(), key=lambda kv: -kv[1][0])},
        "top": [{"name": k[:120], "ms": ms, "calls": n}
                for k, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:args.top]],
        "recorded": recorded,
    }
    if request_ms:
        print(f"{args.path} path, B={args.batch}: request wall ms "
              f"{', '.join(f'{t:.2f}' for t in request_ms)}; median "
              f"{result['request_ms_median']:.2f}; peak memory {peak / 2**30:.2f} GiB")
    print(f"{args.path} path ({cfg.backbone}), B={args.batch}, {result['device']}: "
          f"wall {wall_ms:.2f} ms (profiled), device {device_ms:.2f} ms, "
          f"busy {result['busy_share']:.1%}, {result['kernels']} kernels")
    print(f"  max pools of the request: {pools['max_pool3x3_same']} on K5, "
          f"{pools['max_pool3d_same']} on the strided kernel, {pools['pytorch']} on PyTorch; "
          f"{pools['ndhwc_copies']} inputs copied into channels_last_3d for a kernel; "
          f"{blocks} Inception blocks on step::inception_block, {reductions} head "
          f"reductions on step::conv1x1x1_bias_relu")
    for layer, v in result["layers"].items():
        print(f"  {v['ms']:9.3f} ms {v['share']:6.1%} {v['calls']:5d}  {layer}")
    for fn, v in result["backwards"].items():
        print(f"  {v['ms']:9.3f} ms        {v['calls']:5d}  under {fn} (children included)")
    if result["spans"]:
        print("  device time launched under the port's spans (host ms open):")
    for name, v in result["spans"].items():
        print(f"  {v['ms']:9.3f} ms {v['ms'] / device_ms:6.1%} {v['calls']:5d}  {name} "
              f"({v['host_ms']:.3f} ms)")
    print("  heaviest kernels:")
    for k in result["top"]:
        print(f"  {k['ms']:9.3f} ms {k['calls']:5d}  {k['name']}")
    idle = recorded["idle_gaps_untraced"]
    print(f"  one request with the spans recorded, no host profiled: window "
          f"{recorded['window_ms']:.3f} ms, idle {sum(idle.values()):.3f} ms by innermost span:")
    for name, ms in idle.items():
        print(f"  {ms:9.3f} ms  {name}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
