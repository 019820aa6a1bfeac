"""Video-scale streaming on one card: the cost of linking on the card
against detection, for an L-clip video. The twin of the JAX package's
`scripts/bench_linking_stream.py`.

    python -m step_tpu_torch.bench_linking_stream [--clips 64] [--clip-batch 64]
        [--buckets 64 128] [--iters 10] [--device cuda|cpu] [--set KEY=VALUE ...]

For a video of L sliding-window clips (384 frames at L=64) at the
`streaming` preset's P=16 proposals, K=4 tubes a class and C=24 classes:

  * detection: L clips through the serving tree (`optimize_for_inference`,
    bf16; `profile_request.build("video")`) in batches of `--clip-batch`
    (the shape of `collect_video_tubes`' inner loop), `iters` x the
    batches a video chained through their tubes, one value readback;
  * linking: `tubes/linking.py::link_tubes_multiclass_k` on random valid
    tubes `[L_b, P, T, 4]` and scores `[L_b, P, C]` at each bucket length
    L_b (the `--buckets`, and the power of two that covers L), the clips
    past L masked out by `clip_mask` as a padded bucket is; `iters` calls
    chained through the scores (each scaled by the previous call's mean
    tube score), one value readback;
  * the detect:link ratio, end-to-end clips/s at the bucket that covers
    L, and the card's memory (`torch.cuda.memory_stats`).

Prints a line per bucket, then one JSON line with the JAX script's fields
(`memory` holds the allocator's bytes in use and peak, and the card's
total). On the card unless `--device cpu`; without a card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from step_tpu_torch.bench import BadOutput, chained_timer, device_info, report

ITERS = 10


def finite_sum(x: torch.Tensor) -> float:
    s = float(x.float().sum())
    if not np.isfinite(s):
        raise BadOutput("values that are not finite")
    return s


def memory(dev: torch.device) -> dict:
    if dev.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats["allocated_bytes.all.current"]),
            "peak_bytes_in_use": int(stats["allocated_bytes.all.peak"]),
            "bytes_limit": int(torch.cuda.get_device_properties(dev).total_memory)}


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clips", type=int, default=64,
                    help="video length in sliding-window clips (L)")
    ap.add_argument("--buckets", type=int, nargs="*", default=(64, 128),
                    help="bucketed link lengths to time, in this order")
    ap.add_argument("--clip-batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE", help="StepConfig override (repeatable)")
    args = ap.parse_args(argv)
    if min(args.clips, args.clip_batch, args.iters, *(args.buckets or [1])) < 1:
        ap.error("--clips, --clip-batch, --iters and --buckets must be >= 1")
    return args


def run_bench(args, dev: torch.device) -> dict:
    from step_tpu_torch import PRESETS
    from step_tpu_torch.inference import detect_clip
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.profile_request import build
    from step_tpu_torch.tubes.linking import link_tubes_multiclass_k
    from step_tpu_torch.utils.cli import apply_overrides

    cfg, model = build("video", dev, apply_overrides(PRESETS["streaming"],
                                                     args.overrides))
    L, B = args.clips, args.clip_batch
    T, P, C, S = cfg.total_frames, cfg.max_proposals, cfg.num_classes, cfg.image_size
    rng = np.random.RandomState(0)
    rgb = torch.from_numpy(rng.rand(B, T, S, S, 3).astype(np.float32)).to(dev)
    props, pmask = STEPDetector.initial_proposals(cfg, B, device=dev)

    n_batches = -(-L // B)
    with torch.inference_mode():
        detect_s = n_batches * chained_timer(
            lambda p: detect_clip(model, rgb, p, pmask)["tubes"], props,
            args.iters * n_batches, finite_sum)

        def time_link(Lb: int):
            # valid (x1, y1, x1 + w, y1 + h) boxes: independent uniforms would
            # leave ~3/4 of them degenerate and the IoU surfaces near zero
            xy1 = rng.rand(Lb, P, T, 2).astype(np.float32) * (S - 24)
            wh = 16.0 + rng.rand(Lb, P, T, 2).astype(np.float32) * (S / 3)
            tubes = torch.from_numpy(np.concatenate(
                [xy1, np.minimum(xy1 + wh, S - 1.0)], axis=-1)).to(dev)
            scores = torch.from_numpy(rng.rand(Lb, P, C).astype(np.float32)).to(dev)
            prop_mask = pmask[:1].expand(Lb, P)
            clip_mask = (torch.arange(Lb, device=dev) < L).to(torch.float32)

            def link(s):
                return link_tubes_multiclass_k(
                    tubes, s, prop_mask, cfg.link_iou_weight, cfg.link_tubes_per_class,
                    cfg.link_trim_thresh, clip_mask, stride=cfg.frames_per_chunk,
                    suppress_iou=(cfg.link_suppress_iou if cfg.link_suppress_iou > 0
                                  else None))

            t0 = time.perf_counter()
            finite_sum(link(scores)["tube_scores"])
            first_s = time.perf_counter() - t0

            def step(s):
                # chained: the scores scaled by the previous call's mean
                return s * (1.0 + link(s)["tube_scores"].mean() * 1e-3)

            return chained_timer(step, scores, args.iters, finite_sum), first_s

        buckets = list(args.buckets or ())
        covering = max(1 << (L - 1).bit_length(), 1)
        if covering not in buckets:
            buckets.append(covering)
        link_times = {}
        for i, Lb in enumerate(buckets):
            link_times[Lb], first_s = time_link(Lb)
            print(f"link L={Lb} (pos {i}): {link_times[Lb] * 1e3:.2f} ms/video "
                  f"(first call {first_s:.1f}s)", flush=True)

    link_s = link_times[min(b for b in buckets if b >= L)]
    total_s = detect_s + link_s
    on_card = dev.type == "cuda"
    return {
        "metric": ("streaming_video_clips_per_sec" if on_card
                   else "streaming_video_clips_per_sec_cpu"),
        "clips": L,
        "clip_batch": B,
        "iters": args.iters,
        "detect_ms_per_video": round(detect_s * 1e3, 2),
        "link_ms_per_video": round(link_s * 1e3, 2),
        "link_share_pct": round(100 * link_s / total_s, 2),
        "clips_per_sec_end_to_end": round(L / total_s, 2),
        "link_ms_by_bucket": {str(k): round(v * 1e3, 2) for k, v in link_times.items()},
        "memory": memory(dev),
        "config": f"streaming preset ({C} cls, P={P}, K={cfg.link_tubes_per_class}, "
                  f"{T}f, {S}px, I3D {cfg.backbone_depth}, BN folded, "
                  f"{cfg.compute_dtype})",
        "overrides": ",".join(args.overrides) or None,
        "device": device_info(dev),
    }


def main(argv=None) -> int:
    return report("bench_linking_stream", parse_args(argv), run_bench)


if __name__ == "__main__":
    sys.exit(main())
