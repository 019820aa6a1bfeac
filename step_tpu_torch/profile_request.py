"""Where the device time of one serving request goes, on the card.

    python3 -m step_tpu_torch.profile_request [--path main|kernel]
        [--batch 8] [--requests 10] [--out profile.json]

Builds `ucf_3step` at full width and depth with seeded weights (seed 0), in
bfloat16, in one of the two serving configurations that `chip_smoke.py`
drives:

  main    BN folded and the Inception 1x1x1 convs fused
          (`optimize_for_inference`): cuDNN convs, PyTorch pools, K1, K2;
  kernel  weights left unfolded, `fused_bn_relu=True` and
          `STEP_TPU_POOL3D=pallas`: K3, K4 and K5 as well.

It serves two warm-up requests of uint8 clips through `detect_clip`, times
`--requests` more (host clock around each synchronized request) and prints
each and their median, then profiles one more with `torch.profiler` and
prints that request's wall time (the profiler adds to it), the
summed device time, the busy share (device time / wall time), the number
of kernels, the device time by layer (each hand-written kernel, cuDNN
convolutions, PyTorch pools, layout conversions, copies, other
elementwise work) and the heaviest kernels by name. Needs a CUDA device;
without one it exits non-zero.
"""

from __future__ import annotations

import argparse
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


def layer_of(name: str) -> str:
    for layer, keys in LAYERS:
        if any(k in name for k in keys):
            return layer
    return "other elementwise / reductions"


def build(path: str, dev: torch.device):
    from step_tpu_torch import PRESETS
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.models.optimize import optimize_for_inference
    from step_tpu_torch.utils.init import init_detector_

    cfg = PRESETS["ucf_3step"]
    seeded = init_detector_(STEPDetector(cfg).eval(), 0).state_dict()
    if path == "main":
        os.environ["STEP_TPU_POOL3D"] = "direct"
        cfg_run, state = optimize_for_inference(cfg, seeded)
        model = STEPDetector(cfg_run).eval()
        model.load_state_dict(state)
        model = model.to(device=dev, dtype=getattr(torch, cfg.compute_dtype))
    else:
        os.environ["STEP_TPU_POOL3D"] = "pallas"
        cfg_run = cfg.replace(fused_bn_relu=True)
        model = STEPDetector(cfg_run).eval()
        model.load_state_dict(seeded)
        model = model.to(dev)      # float32 parameters, bf16 activations
    return cfg, model


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", choices=("main", "kernel"), default="main")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--out", default=None, help="also write the result as JSON here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: this profile runs only on the card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from step_tpu_torch.inference import detect_clip
    from step_tpu_torch.models.detector import STEPDetector

    dev = torch.device("cuda", 0)
    cfg, model = build(args.path, dev)
    rng = np.random.RandomState(0)
    props, pmask = STEPDetector.initial_proposals(cfg, args.batch, device=dev)
    clips = [torch.from_numpy(rng.randint(
        0, 256, (args.batch, cfg.total_frames, cfg.image_size, cfg.image_size, 3)
    ).astype(np.uint8)) for _ in range(3)]
    request_ms = []
    with torch.no_grad():
        for clip in clips[:2]:
            detect_clip(model, clip.to(dev), props, pmask)
        for i in range(args.requests):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            detect_clip(model, clips[i % 3].to(dev), props, pmask)
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            detect_clip(model, clips[2].to(dev), props, pmask)
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
