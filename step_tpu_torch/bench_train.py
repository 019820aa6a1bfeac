"""Training benchmark on one card: clips/s of the full train step (forward,
backward, AdamW) of `ucf_3step`, and of the `fit()` loop with its loader.
The twin of the JAX package's `bench_train.py`.

    python -m step_tpu_torch.bench_train [--batch 32] [--remat|--no-remat]
        [--freeze NAME ...] [--skip-fit] [--set KEY=VALUE ...] [--iters N]
        [--device cuda|cpu]

Prints one JSON line (`bench_train.py:284-307`'s fields that mean something
on the card, and a few of the port's own):

  value, step_ms     `--iters` steps (default 10, fewer where the resident
                     input would pass ~2 GB), each on its own synthetic batch
                     uploaded before timing and each ending in
                     `float(metrics["loss"])`; the first two are discarded and
                     step_ms is the mean of the rest (`:178-197`); value =
                     batch / step time
  mfu                the step's useful FLOPs / step time / 989 TFLOP/s (the
                     H100 SXM's dense bf16 peak): forward and backward counted
                     by `torch.utils.flop_counter` on one step with
                     `remat_steps=False` at a reference batch min(B, 16), then
                     scaled linearly to B (`:203-240`), so a remat recompute
                     does not count (`step_flops`)
  fit_clips_per_sec, fit_step_ms, fit_clips_per_sec_prefetch
                     `fit()` for 30 steps over 4·B in-memory synthetic clips
                     through `DataLoader(num_workers=2, prefetch=3)`, with
                     `prefetch_upload` False, then True; clips/s of the last
                     log window after step 20 in `metrics.jsonl` (`:242-281`)
  compile_s          the first step's wall time (the nvcc build of the kernels
                     where this process has not built them, cuDNN's first calls)
  peak_memory_gib    `torch.cuda.max_memory_allocated()` over the timed steps
  device             the card's name, power limit, the device count and peak

The step is `train/trainer.py::train_step` on the one-device state of
`create_train_state` (seed 0), which computes what the JAX bench's
one-device mesh computes. Not carried (ROADMAP M12): `--unroll` (the port
has no `scan_unroll`: its refinement loop is Python), `--vmem-limit-kib`
(a TPU compiler option) and `--donate-batch` (XLA buffer donation), each
refused; the JSON's `scan_unroll`, `vmem_limit_kib` and `vmem_applied`.

On the card unless `--device cpu`; without a card it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from step_tpu_torch.bench import (BF16_TENSOR_FLOPS, BadOutput, count_flops,
                                  device_info, report)

BATCH = 32
ITERS = 10
# 30 steps: one 20-step log window (which absorbs the first step's build)
# and a clean 10-step window; the parser keeps the last window's clips/s.
FIT_STEPS = 30
INPUT_BYTES_CAP = 2e9
M12 = "(ROADMAP M12)"


def make_batches(cfg, n: int, seed: int = 0) -> list:
    """`bench_train.py::make_batches`: n host batches of synthetic clips."""
    from step_tpu_torch.data.pipeline import build_model_batch
    from step_tpu_torch.data.synthetic import SyntheticConfig, make_batch

    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=cfg.max_gt_tubes)
    return [build_model_batch(make_batch(seed + i * cfg.batch_size, cfg.batch_size, syn),
                              cfg, train=True, seed=i, emit_uint8=cfg.uint8_transfer)
            for i in range(n)]


def step_flops(cfg, model, batch: dict, dev: torch.device) -> int:
    """The useful FLOPs of one train step at batch B: one step of a copy of
    `model` with `remat_steps=False` (and no gradient accumulation) at the
    reference batch min(B, 16), counted, scaled by B / that batch."""
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.train.trainer import create_train_state, train_step

    B = batch["rgb"].shape[0]
    bref = min(B, 16)
    ucfg = cfg.replace(remat_steps=False, batch_size=bref, grad_accum_steps=1)
    copy = STEPDetector(ucfg)
    copy.load_state_dict(model.state_dict())
    state = create_train_state(ucfg, 0, copy, dev)
    part = {k: v[:bref] for k, v in batch.items()}
    flops = count_flops(lambda: train_step(state, part, ucfg))
    return flops * B // bref


class _Cached:
    """An in-memory dataset of prepared clips (an object: the loader sets
    its `_epoch`)."""

    def __init__(self, clips: list):
        self.clips = clips

    def __len__(self):
        return len(self.clips)

    def __getitem__(self, i):
        return self.clips[i]


def fit_clips_per_sec(cfg, dev: torch.device, prefetch_upload: bool):
    """`fit()` for FIT_STEPS steps over 4·B in-memory synthetic clips →
    the clips/s of the last log window after step 20 (None if none)."""
    from step_tpu_torch.data.loader import DataLoader
    from step_tpu_torch.data.synthetic import SyntheticConfig, make_clip
    from step_tpu_torch.train.fit import fit

    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=cfg.max_gt_tubes)
    data = _Cached([make_clip(i, syn) for i in range(4 * cfg.batch_size)])
    fit_cfg = cfg.replace(total_steps=FIT_STEPS, warmup_steps=2)
    loader = DataLoader(data, fit_cfg, num_workers=2, prefetch=3)
    with tempfile.TemporaryDirectory() as log_dir:
        with contextlib.redirect_stdout(sys.stderr):     # fit's log lines
            fit(fit_cfg, loader, num_epochs=100, log_dir=log_dir,
                handle_signals=False, prefetch_upload=prefetch_upload, device=dev)
        cps = None
        with open(os.path.join(log_dir, "metrics.jsonl")) as f:
            for line in f:
                rec = json.loads(line)
                if "clips_per_sec" in rec and rec["step"] > 20:
                    cps = rec["clips_per_sec"]      # the last (clean) window
    return cps


def _phase(msg: str) -> None:
    """Progress on stderr: the JSON line owns stdout."""
    print(f"[bench_train {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def parse_args(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction, default=None,
                    help="checkpoint each refinement step (cfg.remat_steps; "
                         "default: the config's, on)")
    ap.add_argument("--freeze", nargs="*", default=(),
                    help="freeze_submodules names, e.g. --freeze features")
    ap.add_argument("--skip-fit", action="store_true", help="the step alone")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="KEY=VALUE", help="StepConfig override (repeatable)")
    ap.add_argument("--iters", type=int, default=None,
                    help="timed steps (default 10, fewer for large batches to cap "
                         "the resident input at ~2 GB)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--unroll", action="store_true", help="refused " + M12)
    ap.add_argument("--vmem-limit-kib", type=int, default=None, help="refused " + M12)
    ap.add_argument("--donate-batch", action="store_true", help="refused " + M12)
    args = ap.parse_args(argv)
    if args.unroll:
        ap.error("--unroll: the port does not carry scan_unroll; its refinement "
                 "steps are a Python loop " + M12)
    if args.vmem_limit_kib is not None:
        ap.error("--vmem-limit-kib sets the TPU compiler's scoped VMEM, which has "
                 "no counterpart on the card " + M12)
    if args.donate_batch:
        ap.error("--donate-batch: the port does not carry XLA buffer donation " + M12)
    if args.iters is not None and args.iters < 3:
        ap.error("--iters must be >= 3 (steps 1-2 are discarded as settle)")
    return args


def run_bench(args, dev: torch.device) -> dict:
    from step_tpu_torch import PRESETS
    from step_tpu_torch.train.trainer import (batch_to_device, create_train_state,
                                              train_step)
    from step_tpu_torch.utils.cli import apply_overrides

    cfg = PRESETS["ucf_3step"].replace(batch_size=args.batch,
                                       freeze_submodules=tuple(args.freeze))
    if args.remat is not None:
        cfg = cfg.replace(remat_steps=args.remat)
    cfg = apply_overrides(cfg, args.overrides)
    batch_bytes = (cfg.batch_size * cfg.total_frames * cfg.image_size ** 2 * 3
                   * (1 if cfg.uint8_transfer else 4))
    iters = args.iters or max(4, min(ITERS, int(INPUT_BYTES_CAP // batch_bytes) - 1))
    _phase(f"making host batches ({iters} timed steps)")
    host = make_batches(cfg, iters + 1)
    _phase("uploading batches")
    batches = [batch_to_device(b, dev) for b in host]
    state = create_train_state(cfg, 0, device=dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _phase("first step")
    t0 = time.perf_counter()
    state, metrics = train_step(state, batches[-1], cfg)
    float(metrics["loss"])
    compile_s = time.perf_counter() - t0
    _phase(f"first step in {compile_s:.1f} s; timing {iters} steps")
    times = []
    for i in range(iters):
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[i], cfg)
        loss = float(metrics["loss"])
        times.append(time.perf_counter() - t0)
        if not np.isfinite(loss):
            raise BadOutput(f"step {i}: loss {loss}")
    dt = float(np.mean(times[2:]))
    on_card = dev.type == "cuda"
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30 if on_card else None
    _phase(f"steps done ({dt * 1e3:.0f} ms a step); counting FLOPs")
    flops = step_flops(cfg, state.model, batches[0], dev)
    del state, batches
    if args.skip_fit:
        fit_cps = fit_cps_pf = None
    else:
        _phase("fit() arm: prefetch_upload=False")
        fit_cps = fit_clips_per_sec(cfg, dev, False)
        _phase("fit() arm: prefetch_upload=True")
        fit_cps_pf = fit_clips_per_sec(cfg, dev, True)
    _phase("done")
    mfu = flops / dt / BF16_TENSOR_FLOPS if on_card else None
    return {
        "metric": ("train_clips_per_sec_per_chip" if on_card
                   else "train_clips_per_sec_cpu"),
        "value": round(cfg.batch_size / dt, 2),
        "unit": "clips/s",
        "step_ms": round(dt * 1e3, 1),
        "timed_steps": iters,
        "mfu": round(mfu, 4) if mfu is not None else None,
        "step_flops": flops,
        "fit_clips_per_sec": round(fit_cps, 2) if fit_cps else None,
        "fit_step_ms": round(1e3 * cfg.batch_size / fit_cps, 1) if fit_cps else None,
        "fit_clips_per_sec_prefetch": round(fit_cps_pf, 2) if fit_cps_pf else None,
        "batch": cfg.batch_size,
        "overrides": ",".join(args.overrides) or None,
        "remat_steps": cfg.remat_steps,
        "freeze_submodules": list(cfg.freeze_submodules),
        "compile_s": round(compile_s, 1),
        "peak_memory_gib": round(peak, 2) if peak is not None else None,
        "config": f"ucf_3step train (3 steps, {cfg.total_frames} frames, "
                  f"{cfg.image_size}px, I3D {cfg.backbone_depth}, AdamW, "
                  f"{cfg.compute_dtype} compute)",
        "device": device_info(dev),
    }


def main(argv=None) -> int:
    return report("bench_train", parse_args(argv), run_bench)


if __name__ == "__main__":
    sys.exit(main())
