"""Smoke test of the PyTorch port (`step_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. the device, and its name and power limit from nvidia-smi;
  2. build the CUDA kernels from step_tpu_torch/csrc with nvcc (sm_90a);
  3. K1, batched NMS: kernel against its plain PyTorch version at the
     serving shape (B=8 → 8*18*24 problems, P=16, K=16), with exact ties,
     zero-area boxes, all-invalid problems and problems that run out
     before K — required exactly equal;
  4. K2, tube ROI-align: kernel against its plain version on features
     [8, 5, 14, 14, 832] with boxes partly and wholly outside the map, in
     float32 (tolerance 1e-4) and bfloat16 (one bf16 rounding step);
  5. a tiny float32 detector on the card against the same detector on the
     CPU (plain versions of both kernels);
  6. the main path: `ucf_3step` at full width and depth, seeded weights,
     BN folded, bfloat16, serving uint8 clips through `detect_clip` at
     B=1 and B=8 — output shapes, finite values, and both kernels'
     launch counters above zero.

The second-to-last line is a JSON object describing each kernel; the last
is {"ok": true, "device": {...}}. Without a CUDA device, or run outside the
repository, it exits non-zero and prints no result.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
SERVE_BATCHES = (1, 8)
REQUESTS_PER_BATCH = 4          # the first of each batch size warms up
ROI_BF16_RTOL = 2.0 ** -7       # one bf16 rounding step (8-bit significand)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def nms_inputs(rng, N: int, P: int):
    """Boxes [N, P, 4], scores [N, P] and valid [N, P] that exercise every
    rule: exact ties, zero-area boxes, all-invalid problems, problems that
    exhaust before K, duplicate boxes."""
    xy = rng.uniform(0.0, 200.0, (N, P, 2))
    wh = rng.uniform(0.0, 60.0, (N, P, 2))
    wh[rng.rand(N, P) < 0.1] = 0.0                       # zero-area boxes
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    dup = rng.rand(N, P) < 0.05                          # exact duplicates
    boxes[dup] = boxes[:, :1].repeat(P, axis=1)[dup]
    scores = (rng.randint(0, 8, (N, P)) / 8.0).astype(np.float32)  # ties
    smooth = rng.rand(N) < 0.5
    scores[smooth] = rng.rand(int(smooth.sum()), P).astype(np.float32)
    valid = (rng.rand(N, P) > 0.2).astype(np.float32)
    valid[::7] = 0.0                                     # all-invalid problems
    valid[3::11, 2:] = 0.0                               # at most 2 live boxes
    return boxes, scores, valid


def roi_inputs(rng, B: int, Tp: int, H: int, C: int, N: int, T: int, image: int):
    feat = rng.randn(B, Tp, H, H, C).astype(np.float32)
    base = rng.uniform(-0.2, 1.0, (B, N, 1, 2)) * image
    size = rng.uniform(0.0, 0.7, (B, N, 1, 2)) * image
    tubes = np.concatenate([base, base + size], axis=-1)
    tubes = tubes + rng.randn(B, N, T, 4) * 4.0           # per-frame jitter
    tubes[:, 0] = [-100.0, -100.0, -20.0, -20.0]          # wholly outside
    tubes[:, 1] = [image + 40.0, 30.0, image + 90.0, 80.0]
    tubes[:, 2] = [-30.0, -30.0, 60.0, 60.0]              # partly outside
    tubes[:, 3] = [100.0, 100.0, 100.0, 100.0]            # zero-area
    return feat, tubes.astype(np.float32)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the card")
    from step_tpu_torch import PRESETS, kernels
    from step_tpu_torch.inference import detect_clip, nms_surface
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.models.optimize import optimize_for_inference
    from step_tpu_torch.ops.nms import nms_many, nms_many_plain, premask_scores
    from step_tpu_torch.ops.roi_align import tube_roi_align, tube_roi_align_plain
    from step_tpu_torch.utils.init import init_detector_

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"[1] device {kind} (count {count}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi name, power limit:", flush=True)
    print(smi.stdout.strip(), flush=True)

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    path, log = kernels.build()
    kernels.library()
    print(f"[2] kernels built in {time.time() - t0:.1f} s → {path.name}", flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("    " + line.strip())

    rng = np.random.RandomState(SEED)
    results = {}

    # ---- 3. K1: NMS ------------------------------------------------------
    cfg = PRESETS["ucf_3step"]
    B, T, C, P = 8, cfg.total_frames, cfg.num_classes, cfg.max_proposals
    K = min(cfg.max_detections, P)
    boxes, scores, valid = (torch.from_numpy(a).to(dev)
                            for a in nms_inputs(rng, B * T * C, P))
    thr, sthr = cfg.nms_thresh, cfg.score_thresh
    idx_k, mask_k = nms_many(boxes, scores, thr, K, sthr, valid)
    live = premask_scores(scores, sthr, valid)
    idx_p, mask_p = nms_many_plain(boxes, live, thr, K)
    torch.cuda.synchronize()
    check(torch.equal(idx_k, idx_p) and torch.equal(mask_k, mask_p),
          f"K1 nms kernel differs from plain: "
          f"{int((idx_k != idx_p).sum())} idx, {int((mask_k != mask_p).sum())} mask")
    kept = mask_k.sum(dim=1)
    nms_ms = cuda_ms(lambda: nms_many(boxes, scores, thr, K, sthr, valid))
    nms_plain_ms = cuda_ms(lambda: nms_many_plain(
        boxes, premask_scores(scores, sthr, valid), thr, K))
    print(f"[3] K1 nms exact on {B * T * C} problems (P={P}, K={K}): "
          f"{int((kept == 0).sum())} empty, {int(((kept > 0) & (kept < K)).sum())} "
          f"exhausted before K, {int((kept == K).sum())} full; "
          f"kernel {nms_ms:.4f} ms, plain {nms_plain_ms:.4f} ms", flush=True)
    results["nms_many"] = dict(max_abs_err=0.0, ms=nms_ms, plain_ms=nms_plain_ms)

    # ---- 4. K2: tube ROI-align ------------------------------------------
    Tp, Hf = 5, cfg.image_size // cfg.feature_stride
    feat_np, tubes_np = roi_inputs(rng, B, Tp, Hf, 832, P, T, cfg.image_size)
    feat32 = torch.from_numpy(feat_np).to(dev)
    tubes = torch.from_numpy(tubes_np).to(dev)
    roi = lambda f: tube_roi_align(f, tubes, cfg.pooled_size,  # noqa: E731
                                   1.0 / cfg.feature_stride, cfg.sampling_ratio)
    plain = lambda f: tube_roi_align_plain(f, tubes, cfg.pooled_size,  # noqa: E731
                                           1.0 / cfg.feature_stride,
                                           cfg.sampling_ratio)
    out_k, out_p = roi(feat32), plain(feat32)
    torch.cuda.synchronize()
    err32 = float((out_k - out_p).abs().max())
    check(out_k.shape == (B, P, Tp, 7, 7, 832), f"K2 shape {tuple(out_k.shape)}")
    check(torch.allclose(out_k, out_p, rtol=1e-4, atol=1e-4),
          f"K2 roi_align float32 differs from plain: max |err| {err32}")
    check(float(out_p[:, 0].abs().max()) == 0.0,
          "K2 box outside the map pooled non-zero")
    feat16 = feat32.to(torch.bfloat16)
    out_k, out_p = roi(feat16), plain(feat16)
    torch.cuda.synchronize()
    check(out_k.dtype == torch.bfloat16, f"K2 bf16 output dtype {out_k.dtype}")
    err16 = float((out_k.float() - out_p.float()).abs().max())
    check(torch.allclose(out_k.float(), out_p.float(), rtol=ROI_BF16_RTOL, atol=1e-5),
          f"K2 roi_align bfloat16 differs from plain: max |err| {err16}")
    roi_ms = cuda_ms(lambda: roi(feat16))
    roi_plain_ms = cuda_ms(lambda: plain(feat16))
    print(f"[4] K2 roi_align on [{B},{Tp},{Hf},{Hf},832]: max |err| f32 {err32:.3g} "
          f"(tol 1e-4), bf16 {err16:.3g} (rtol 2^-7); bf16 kernel {roi_ms:.4f} ms, "
          f"plain {roi_plain_ms:.4f} ms", flush=True)
    results["tube_roi_align"] = dict(max_abs_err=err16, ms=roi_ms,
                                     plain_ms=roi_plain_ms)

    # ---- 5. tiny float32 detector: card against CPU ---------------------
    tiny = cfg.replace(backbone_depth="tiny", feature_stride=8, image_size=64,
                       compute_dtype="float32")
    model_cpu = init_detector_(STEPDetector(tiny).eval(), SEED)
    model_gpu = init_detector_(STEPDetector(tiny).eval(), SEED).to(dev)
    props, pmask = STEPDetector.initial_proposals(tiny, 2)
    clip = torch.from_numpy(rng.randint(0, 256, (2, T, 64, 64, 3)).astype(np.uint8))
    ref = detect_clip(model_cpu, clip, props, pmask)
    got = detect_clip(model_gpu, clip.to(dev), props.to(dev), pmask.to(dev))
    d_tubes = float((got["tubes"].cpu() - ref["tubes"]).abs().max())
    d_scores = float((got["tube_scores"].cpu() - ref["tube_scores"]).abs().max())
    check(d_tubes <= 1e-3 and d_scores <= 1e-4,
          f"tiny detector card vs CPU: tubes {d_tubes} px, scores {d_scores}")
    surf = nms_surface(ref["tubes"].to(dev), ref["tube_scores"].to(dev),
                       pmask.to(dev), tiny)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        check(torch.equal(surf[key].cpu(), ref[key]),
              f"tiny detector NMS surface on the card differs in {key}")
    print(f"[5] tiny f32 detector card vs CPU: tubes {d_tubes:.3g} px, "
          f"scores {d_scores:.3g}; NMS surface equal", flush=True)

    # ---- 6. the main path: full-width ucf_3step, bf16 -------------------
    t0 = time.time()
    model = init_detector_(STEPDetector(cfg).eval(), SEED)
    cfg_opt, folded = optimize_for_inference(cfg, model.state_dict())
    model = STEPDetector(cfg_opt).eval()
    model.load_state_dict(folded)
    model = model.to(device=dev, dtype=getattr(torch, cfg.compute_dtype))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[6] ucf_3step {cfg.backbone_depth}, {n_params} params, BN folded, "
          f"{cfg.compute_dtype}: built in {time.time() - t0:.1f} s", flush=True)
    clips = {b: [torch.from_numpy(rng.randint(0, 256, (b, T, cfg.image_size,
                                                       cfg.image_size, 3)
                                              ).astype(np.uint8))
                 for _ in range(REQUESTS_PER_BATCH)] for b in SERVE_BATCHES}
    nms_many.launches = 0
    tube_roi_align.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    for b in SERVE_BATCHES:
        props, pmask = STEPDetector.initial_proposals(cfg, b, device=dev)
        times = []
        for clip in clips[b]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = detect_clip(model, clip.to(dev), props, pmask)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            shapes = {"tubes": (b, P, T, 4), "tube_scores": (b, P, C),
                      "frame_boxes": (b, T, C, K, 4), "frame_scores": (b, T, C, K),
                      "frame_mask": (b, T, C, K)}
            for key, shape in shapes.items():
                check(tuple(out[key].shape) == shape,
                      f"{key} shape {tuple(out[key].shape)}, expected {shape}")
                check(bool(torch.isfinite(out[key]).all()), f"{key} not finite")
            check(float(out["tube_scores"][:, cfg.num_proposals:].abs().max()) == 0.0,
                  "padding proposals scored")
            check(bool(((out["tubes"] >= 0) & (out["tubes"] <= cfg.image_size)).all()),
                  "tubes outside the image")
        print(f"    B={b}: request wall ms {', '.join(f'{t:.2f}' for t in times)} "
              f"(first warms up); {int(out['frame_mask'].sum())} survivors in the "
              f"last", flush=True)
    launches = {"nms_many": nms_many.launches,
                "tube_roi_align": tube_roi_align.launches}
    print(f"    launches during serving: {launches}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")

    meta = {
        "nms_many": ("step_tpu_torch/csrc/nms.cu", "step_tpu/ops/nms_pallas.py:38"),
        "tube_roi_align": ("step_tpu_torch/csrc/roi_align.cu",
                           "step_tpu/ops/roi_align_pallas.py:55"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in meta.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
