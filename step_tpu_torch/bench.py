"""Serving benchmark on one card: clips/s, MFU and B=1 latency of the
`ucf_3step` detector (I3D, 3 refinement steps, 18 frames, 224 px). The
twin of the JAX package's `bench.py`.

    python -m step_tpu_torch.bench [--config main|kernel] [--batch 128]
        [--iters 30] [--device cuda|cpu] [--set KEY=VALUE ...]

Prints one JSON line (`bench.py:271-307`'s fields that mean something on
the card, and a few of the port's own):

  metric, value, unit  clips/s at `--batch`: `iters` requests chained, each
                       fed the previous request's `tubes` as its proposals,
                       then one value readback (`float(tube_scores.sum())`),
                       which waits for the card; batch / (wall / iters) on
                       the host clock (`_chained_time`, `bench.py:44-64`)
  vs_baseline          value / (5 x 20 clips/s), the JAX bench's documented
                       proxy for the reference; no measured number
  mfu                  one request's FLOPs / the median request time / the
                       H100 SXM's dense bf16 peak, 989 TFLOP/s. The FLOPs
                       are counted by `torch.utils.flop_counter` on the
                       timed program at the timed batch (`request_flops`);
                       the request times are CUDA events between the
                       chained requests (`request_ms_median`)
  p50/p90_latency_ms   B=1, each request ending in its own value readback
                       (`_measure_latency`, `bench.py:219-239`)
  latency_chained_mean_ms       B=1, `iters` chained requests, one readback
  latency_readback_overhead_ms  mean per-request latency less that
  compile_s            the first request's wall time: the nvcc build of the
                       kernels where this process has not built them, and
                       cuDNN's first calls
  peak_memory_gib      `torch.cuda.max_memory_allocated()` over the run
  cudnn_benchmark      `torch.backends.cudnn.benchmark` as the run had it
                       (the port's serving paths leave it off)
  device               the card's name, its power limit as nvidia-smi reads
                       it, the device count and the peak used

Workload (`bench.py:86-100`): weights from seed 0 (`utils/init.py`), the
input `RandomState(0).rand(B, 18, 224, 224, 3)` as float32 in [0, 1] on the
card, and `STEPDetector.initial_proposals`. `--config main` serves the
tree `bench.py` serves: `optimize_for_inference` (BN folded, the Inception
1x1x1 convs fused), bf16, cuDNN convs, K1 and K2, and every max pool on
a hand-written kernel (K5 and `ops/pool.py::max_pool3d_same`, as on any
path on the card); `--config kernel` the unfolded weights with
`fused_bn_relu=True`: K3 and K4 as well
(`profile_request.build`).
Both count the same FLOPs: K3's operator carries aten's convolution count
(`ops/conv3d.py`), K1, K2, K4, K5 and the strided pool count none, as
aten's pools and elementwise ops count none. The block-diagonal 3x3x3 merge
(`fuse_inception3`) would add the products with its zero blocks, so the
bench does not serve it.

Not carried, each a TPU compiler's knob: the JSON's
`compiler_options_applied` and `latency_vmem_arm`, and the flag
`--latency-vmem-kib`, which is refused (ROADMAP M12).

On the card unless `--device cpu`; without a card it exits non-zero. A run
whose outputs are not finite or not of their documented shapes exits
non-zero and prints no JSON.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

REF_CLIPS_PER_SEC = 20.0        # the JAX bench's documented proxy
TARGET_MULTIPLE = 5.0
# The H100 SXM's dense bf16 tensor-core peak (NVIDIA's data sheet, 700 W).
BF16_TENSOR_FLOPS = 989e12
BATCH = 128
ITERS = 30
CONFIGS = {
    "main": "optimize_for_inference: BN folded, Inception 1x1x1 fused, cuDNN convs, "
            "K1, K2, K5 and the strided pool kernel",
    "kernel": "unfolded, fused_bn_relu: K1-K5",
}
M12 = "(ROADMAP M12: the port does not carry the TPU compiler's options)"


class BadOutput(RuntimeError):
    """A run's outputs are not finite or not of their documented shapes."""


def resolve_device(name: str) -> torch.device | None:
    """The bench's device, or None (with the reason on stderr) when it asks
    for a card and there is none: a bench never falls back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: this bench runs on the card; pass --device cpu "
              "to run it on the CPU", file=sys.stderr)
        return None
    return dev


def device_info(dev: torch.device) -> dict:
    """What a result names its device by: the card's name, its power limit
    as nvidia-smi reads it, the device count and the peak the MFU uses."""
    if dev.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None, "count": 1,
                "peak_bf16_flops": None}
    index = dev.index or 0
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader", "-i", str(index)],
                             capture_output=True, text=True, timeout=60)
        limit = smi.stdout.strip() if smi.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired):
        limit = "not read"
    return {"platform": "gpu", "name": torch.cuda.get_device_name(index),
            "power_limit": limit, "count": torch.cuda.device_count(),
            "peak_bf16_flops": BF16_TENSOR_FLOPS}


def count_flops(fn) -> int:
    """The FLOPs `torch.utils.flop_counter` counts in one call of `fn`."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def chained_timer(step, carry, iters: int, readback) -> float:
    """The JAX package's `utils/profiling.py::chained_timer`: seconds per
    application of `step(carry) -> carry`, `iters` of them continued from
    one warm-up application, then `readback` of the last carry (a value
    read, which waits for the card) inside the clock."""
    carry = step(carry)
    readback(carry)
    t0 = time.perf_counter()
    for _ in range(iters):
        carry = step(carry)
    readback(carry)
    return (time.perf_counter() - t0) / iters


def make_input(cfg, batch: int, device) -> torch.Tensor:
    """`bench.py:96-100`'s clip: `RandomState(0).rand(B, T, S, S, 3)` as
    float32, drawn a clip at a time (the same stream) and moved to
    `device` a clip at a time."""
    rng = np.random.RandomState(0)
    S = cfg.image_size
    out = torch.empty((batch, cfg.total_frames, S, S, 3), dtype=torch.float32,
                      device=device)
    for b in range(batch):
        clip = rng.rand(1, cfg.total_frames, S, S, 3).astype(np.float32)
        out[b:b + 1].copy_(torch.from_numpy(clip))
    return out


def check_output(out: dict, cfg, batch: int) -> None:
    P, T, C = cfg.max_proposals, cfg.total_frames, cfg.num_classes
    for key, shape in (("tube_scores", (batch, P, C)), ("tubes", (batch, P, T, 4))):
        x = out[key]
        if tuple(x.shape) != shape:
            raise BadOutput(f"{key} has shape {tuple(x.shape)}, not {shape}")
        if not bool(torch.isfinite(x).all()):
            raise BadOutput(f"{key} holds values that are not finite")


def chained(run, proposals, iters: int, dev: torch.device):
    """`bench.py::_chained_time`: one request to settle, then `iters`
    requests, each fed the previous request's tubes, then one value
    readback → (wall seconds, per-request device ms between CUDA events
    recorded between the requests (empty on the CPU), the last output)."""
    float(run(proposals)["tube_scores"].sum())      # settle
    events = ([torch.cuda.Event(enable_timing=True) for _ in range(iters + 1)]
              if dev.type == "cuda" else [])
    props = proposals
    t0 = time.perf_counter()
    if events:
        events[0].record()
    for i in range(iters):
        out = run(props)
        props = out["tubes"]
        if events:
            events[i + 1].record()
    float(out["tube_scores"].sum())
    wall = time.perf_counter() - t0
    return wall, [a.elapsed_time(b) for a, b in zip(events, events[1:])], out


def measure_latency(run, proposals, iters: int, dev: torch.device, cfg):
    """`bench.py::_measure_latency` at B=1 → (p50, p90, chained mean, mean
    per-request less chained mean), all ms."""
    wall, _, out = chained(run, proposals, iters, dev)
    check_output(out, cfg, 1)
    chained_ms = wall / iters * 1e3
    out = run(proposals)
    float(out["tube_scores"].sum())         # settle
    props, lats = out["tubes"], []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = run(props)
        float(out["tube_scores"].sum())     # each request's own readback
        lats.append((time.perf_counter() - t0) * 1e3)
        props = out["tubes"]
    check_output(out, cfg, 1)
    lats = np.asarray(lats)
    return (float(np.percentile(lats, 50)), float(np.percentile(lats, 90)),
            chained_ms, float(lats.mean() - chained_ms))


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=tuple(CONFIGS), default="main")
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--iters", type=int, default=ITERS,
                    help="chained requests timed (default %(default)s)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE", help="StepConfig override (repeatable)")
    ap.add_argument("--latency-vmem-kib", type=int, default=None,
                    help="refused: a TPU compiler option " + M12)
    args = ap.parse_args(argv)
    if args.latency_vmem_kib is not None:
        ap.error("--latency-vmem-kib sets the TPU compiler's scoped VMEM, which "
                 "has no counterpart on the card " + M12)
    if args.iters < 1 or args.batch < 1:
        ap.error("--iters and --batch must be >= 1")
    return args


def run_bench(args, dev: torch.device) -> dict:
    from step_tpu_torch import PRESETS
    from step_tpu_torch.inference import detect_clip
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.profile_request import build
    from step_tpu_torch.utils.cli import apply_overrides

    cfg = apply_overrides(PRESETS["ucf_3step"], args.overrides)
    if cfg.fused_inception3 != "none":
        raise ValueError("the bench does not serve fuse_inception3: its zero blocks "
                         "would count as FLOPs")
    B = args.batch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, model = build(args.config, dev, cfg)
    rgb = make_input(cfg, B, dev)
    proposals, prop_mask = STEPDetector.initial_proposals(cfg, B, device=dev)

    with torch.inference_mode():
        def request(props):
            return detect_clip(model, rgb, props, prop_mask)

        t0 = time.perf_counter()
        first = request(proposals)
        float(first["tube_scores"].sum())
        compile_s = time.perf_counter() - t0
        check_output(first, cfg, B)
        wall, request_ms, out = chained(request, proposals, args.iters, dev)
        check_output(out, cfg, B)
        flops = count_flops(lambda: request(proposals))

        rgb1, pmask1 = rgb[:1], prop_mask[:1]
        p50, p90, lat_chained, overhead = measure_latency(
            lambda p: detect_clip(model, rgb1, p, pmask1), proposals[:1], args.iters,
            dev, cfg)

    clips_per_sec = B / (wall / args.iters)
    median_ms = float(np.median(request_ms)) if request_ms else None
    on_card = dev.type == "cuda"
    mfu = flops / (median_ms * 1e-3) / BF16_TENSOR_FLOPS if on_card else None
    return {
        "metric": "clips_per_sec_per_chip" if on_card else "clips_per_sec_cpu",
        "value": round(clips_per_sec, 2),
        "unit": "clips/s",
        "vs_baseline": round(clips_per_sec / (TARGET_MULTIPLE * REF_CLIPS_PER_SEC), 3),
        "vs_baseline_denominator": "proxy: 5 x 20 clips/s assumed reference"
                                   " (unmeasured; see BASELINE.md)",
        "mfu": round(mfu, 4) if mfu is not None else None,
        "request_flops": flops,
        "request_ms_median": round(median_ms, 3) if median_ms is not None else None,
        "p50_latency_ms": round(p50, 2),
        "p90_latency_ms": round(p90, 2),
        "latency_chained_mean_ms": round(lat_chained, 2),
        "latency_readback_overhead_ms": round(overhead, 2),
        "latency_semantics": "p50/p90: per-request end-to-end at B=1, each request "
                             "ending in its own value readback, on a PCIe-attached "
                             "card with no relay; latency_chained_mean_ms: iters "
                             "chained requests, one readback",
        "batch": B,
        "iters": args.iters,
        "compile_s": round(compile_s, 1),
        "peak_memory_gib": (round(torch.cuda.max_memory_allocated(dev) / 2 ** 30, 2)
                            if on_card else None),
        "cudnn_benchmark": bool(torch.backends.cudnn.benchmark),
        "config": f"ucf_3step {args.config} ({CONFIGS[args.config]}; 3-step "
                  f"refinement, {cfg.total_frames} frames, {cfg.image_size}px, I3D "
                  f"{cfg.backbone_depth}, {cfg.compute_dtype})",
        "overrides": ",".join(args.overrides) or None,
        "device": device_info(dev),
    }


def report(name: str, args, run) -> int:
    """`run(args, device)` on `args.device`, its JSON line printed → the
    exit code: 1, with the reason on stderr, where there is no card (and
    no `--device cpu`) or an output is bad."""
    dev = resolve_device(args.device)
    if dev is None:
        return 1
    try:
        result = run(args, dev)
    except BadOutput as e:
        print(f"{name}: {e}", file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


def main(argv=None) -> int:
    return report("bench", parse_args(argv), run_bench)


if __name__ == "__main__":
    sys.exit(main())
