"""Where the device time of one serving request or training step goes,
on the card.

    python3 -m step_tpu_torch.profile_request
        [--path main|kernel|video|stream|train|train_two_stream|two_stream|ava]
        [--batch 8] [--requests 10] [--out profile.json]

Builds the detector at full width and depth with seeded weights (seed 0),
in bfloat16, in one of the serving configurations that `chip_smoke.py`
drives:

  main    `ucf_3step`, BN folded and the Inception 1x1x1 convs fused
          (`optimize_for_inference`): cuDNN convs, PyTorch pools, K1, K2;
  kernel  `ucf_3step`, weights left unfolded, `fused_bn_relu=True` and
          `STEP_TPU_POOL3D=pallas`: K3, K4 and K5 as well;
  video   `streaming` on the main path's tree: a request is one video of
          `--batch` chunks (6 frames each) tiled into as many windows one
          chunk apart, through `detect_video` (tiling_stride 6), linking
          included;
  stream  the same video through `detect_video_stream_batched` with chunk
          stems (`chunk_stem=True`), 16 windows a refinement batch;
  train   one `train_step` of `ucf_3step` (the training init, float32
          weights, bf16 compute, remat "dots", AdamW) on `--batch`
          synthetic uint8 clips already on the card;
  train_two_stream  the same for `two_stream_train`, both stems and the
          fusion unit trained, each clip with its int8 flow (`make_flow`);
  two_stream  `two_stream_train` on the main path's tree (both stems and
          the fusion unit folded): uint8 RGB and int8 flow;
  ava     `ava_3step` on the main path's tree: 60 sigmoid classes, the
          context branch.

A request of `main`, `kernel` and `ava` uploads `--batch` uint8 clips,
one of `two_stream` the clips and their int8 flow, one of `video` and
`stream` a uint8 video; then it detects. For `train` it also
prints the device time under each plain backward (the stride-1 pool's and
ROI-align's autograd Functions, children included). The script serves two
warm-up requests, times `--requests` more (host clock around each
synchronized request) and prints each and their median, then profiles one
more with `torch.profiler` and prints that request's wall time (the
profiler adds to it), the summed device time, the busy share (device time
/ wall time), the number of kernels, the device time by layer (each
hand-written kernel, cuDNN convolutions, PyTorch pools, layout
conversions, copies, other elementwise work) and the heaviest kernels by
name. Needs a CUDA device; without one it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

# Kernel name fragments → layer, first match wins.
LAYERS = (
    ("K1 nms (csrc/nms.cu)", ("nms_groups_kernel", "nms_many_kernel")),
    ("K2 roi_align (csrc/roi_align.cu)", ("tube_roi_align_kernel",)),
    ("K3 conv3x3x3 (csrc/conv3d.cu)", ("conv_bf16_kernel", "conv_f32_kernel",
                                       "conv3x3x3_bn_relu_kernel")),
    ("K4 bn_relu (csrc/bn_relu.cu)", ("scale_bias_relu_kernel",)),
    ("K5 max_pool3x3 (csrc/pool3d.cu)", ("max_pool3x3_kernel",)),
    ("PyTorch pools", ("max_pool", "pool3d", "pool2d")),
    ("layout conversions", ("nhwcToNchw", "nchwToNhwc")),
    ("cuDNN / cuBLAS conv and matmul", ("xmma", "implicit_gemm", "conv", "cudnn",
                                        "cutlass", "gemm", "sm90_", "sm80_")),
    ("copies", ("Memcpy", "Memset", "copy_kernel")),
)


PRESET_OF = {"main": "ucf_3step", "kernel": "ucf_3step", "train": "ucf_3step",
             "train_two_stream": "two_stream_train",
             "video": "streaming", "stream": "streaming",
             "two_stream": "two_stream_train", "ava": "ava_3step"}


def layer_of(name: str) -> str:
    for layer, keys in LAYERS:
        if any(k in name for k in keys):
            return layer
    return "other elementwise / reductions"


def build(path: str, dev: torch.device, cfg=None):
    """(config, model) of `path` on `dev`, from `cfg` where given, else the
    path's preset. Sets `STEP_TPU_POOL3D` for the serving paths."""
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
        os.environ["STEP_TPU_POOL3D"] = "pallas"
        cfg_run = cfg.replace(fused_bn_relu=True)
        model = STEPDetector(cfg_run).eval()
        model.load_state_dict(seeded)
        return cfg, model.to(dev)      # float32 parameters, bf16 activations
    os.environ["STEP_TPU_POOL3D"] = "direct"
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=tuple(PRESET_OF), default="main")
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

    dev = torch.device("cuda", 0)
    cfg, model = build(args.path, dev)
    run, make = request_fn(args.path, cfg, model, args.batch, dev)
    inputs = [make() for _ in range(3)]
    request_ms = []
    with contextlib.nullcontext() if args.path.startswith("train") else torch.no_grad():
        for x in inputs[:2]:
            run(x)
        for i in range(args.requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(inputs[i % 3])
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(inputs[2])
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        if us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
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
    result = {
        "device": torch.cuda.get_device_name(0), "path": args.path,
        "batch": args.batch, "request_ms": request_ms,
        "request_ms_median": float(np.median(request_ms)) if request_ms else None,
        "wall_ms": wall_ms, "device_ms": device_ms,
        "busy_share": device_ms / wall_ms,
        "kernels": sum(n for _, n in kernels.values()),
        "backwards": {k: {"ms": ms, "calls": n} for k, (ms, n) in backwards.items()},
        "layers": {k: {"ms": ms, "calls": n, "share": ms / device_ms}
                   for k, (ms, n) in sorted(layers.items(), key=lambda kv: -kv[1][0])},
        "top": [{"name": k[:120], "ms": ms, "calls": n}
                for k, (ms, n) in sorted(kernels.items(), key=lambda kv: -kv[1][0])[:args.top]],
    }
    if request_ms:
        print(f"{args.path} path, B={args.batch}: request wall ms "
              f"{', '.join(f'{t:.2f}' for t in request_ms)}; median "
              f"{result['request_ms_median']:.2f}")
    print(f"{args.path} path, B={args.batch}, {result['device']}: wall {wall_ms:.2f} ms "
          f"(profiled), device {device_ms:.2f} ms, busy {result['busy_share']:.1%}, "
          f"{result['kernels']} kernels")
    for layer, v in result["layers"].items():
        print(f"  {v['ms']:9.3f} ms {v['share']:6.1%} {v['calls']:5d}  {layer}")
    for fn, v in result["backwards"].items():
        print(f"  {v['ms']:9.3f} ms        {v['calls']:5d}  under {fn} (children included)")
    print("  heaviest kernels:")
    for k in result["top"]:
        print(f"  {k['ms']:9.3f} ms {k['calls']:5d}  {k['name']}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
