"""Smoke test of the PyTorch port (`step_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. the device, and its name and power limit from nvidia-smi;
  2. build the CUDA kernels from step_tpu_torch/csrc with nvcc (sm_90a),
     and count the HGMMA (tensor-core) instructions in K3's SASS;
  3. K1, batched NMS: kernel against its plain PyTorch version at the
     serving shape (B=8 → 8*18*24 problems, P=16, K=16), with exact ties,
     zero-area boxes, all-invalid problems and problems that run out
     before K — required exactly equal;
  4. K2, tube ROI-align: kernel against its plain version on features
     [8, 5, 14, 14, 832] with boxes partly and wholly outside the map, in
     float32 (tolerance 1e-4) and bfloat16 (one bf16 rounding step), at
     sampling_ratio 2 and at 0 (adaptive, with boxes larger than the map so
     that the sample cap bites);
  5. a tiny float32 detector on the card against the same detector on the
     CPU (plain versions of both kernels);
  6. the main path: `ucf_3step` at full width and depth, seeded weights,
     made ready for serving by `optimize_for_inference` (BN folded, the
     Inception 1x1x1 convs fused, as the JAX package serves it), bfloat16,
     serving uint8 clips through `detect_clip` at B=1 and B=8 — output
     shapes, finite values, and both kernels' launch counters above zero;
  7. K5, 3x3x3 max pool: kernel against its plain version at the Mixed_3b,
     Mixed_4b and tail Mixed_5b pool shapes, float32 and bfloat16 — exactly
     equal;
  8. K4, BN + ReLU: at the Conv3d_1a output and a tail shape — float32
     within 1e-6, bfloat16 within one rounding step;
  9. K3, 3x3x3 conv + BN + ReLU: at Conv3d_2c_3x3, the tail's Mixed_5b
     b1b, Mixed_4c b2b (C = 24) and Mixed_4b b1b (K = 208) — float32 within
     1e-4, bfloat16 (the tensor-core kernel, which must hold HGMMA
     instructions) within one rounding step and 2^-15 (K3_BF16_ATOL); times
     against cuDNN in bf16 and the bound, and the per-call weight
     re-layout;
 10. the kernel path: the same `ucf_3step` at full width and depth, seeded
     weights left unfolded, `fused_bn_relu=True` and
     `STEP_TPU_POOL3D=pallas`, bfloat16, serving B=1 and B=8 — the checks of
     phase 6, and all five launch counters above zero;
 11. the same weights in float32 at B=1: the kernel path against the main
     path (folded, cuDNN, PyTorch pools) — tube scores within 1e-3, tubes
     within 1e-2 px.

At the end it checks that nothing of JAX or of the JAX package was
imported. The second-to-last line is a JSON object describing each kernel:
launches counted on the path that runs it (K1 and K2 on the main path,
phase 6; K3, K4 and K5 on the kernel path, phase 10), max error, kernel and
plain times, the bound (the larger of the bytes it must move over 3.35 TB/s
and its operations over the peak rate for their type) and the time of one
PyTorch call for the same function where there is one. The last is
{"ok": true, "device": {...}}. Without a CUDA device, or run outside the
repository, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
SERVE_BATCHES = (1, 8)
REQUESTS_PER_BATCH = 4          # the first of each batch size warms up
KERNEL_PATH_REQUESTS = 3        # the kernel path is slower: fewer requests
BF16_RTOL = 2.0 ** -7           # one bf16 rounding step (8-bit significand)
# K3's tensor cores add each 16-deep group of products into the float32
# accumulator aligned to the largest exponent and truncated, so over 27 * C
# terms the sum drifts from the plain version's rounded float32 sum. Where
# BN and ReLU bring the output near 0 that drift is more than one bf16 step
# of the output: about 1e-5 beyond it at the Inception widths on an H100
# (step_tpu_torch/conv_tune.py measures it). Hence an absolute floor of
# 2^-15 for K3 in bf16, and 1e-5 elsewhere.
K3_BF16_ATOL = 2.0 ** -15
PATH_SCORE_TOL, PATH_TUBE_TOL = 1e-3, 1e-2
# The H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12               # float32 outside the tensor cores


def bound(nbytes: float, ops: float, peak_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate for their type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def hgmma_count(library, nvcc: str) -> int:
    """HGMMA instructions in the SASS of the bf16 conv kernels, read with
    the cuobjdump beside nvcc."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()}")
    n, in_conv = 0, False
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            in_conv = "conv_bf16_kernel" in line
        elif in_conv and "HGMMA" in line:
            n += 1
    return n


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


def randn_cl(rng, shape, dev) -> torch.Tensor:
    """A float32 NCDHW tensor on the card from `rng`, in channels_last_3d
    order, as the backbone keeps its activations."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    return x.contiguous(memory_format=torch.channels_last_3d)


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


def serve(model, cfg, clips, dev, label: str) -> None:
    """Serve each batch size's clips through `detect_clip`, timing each
    request, and check the outputs as a client would read them."""
    from step_tpu_torch.inference import detect_clip
    from step_tpu_torch.models.detector import STEPDetector

    T, C, P = cfg.total_frames, cfg.num_classes, cfg.max_proposals
    K = min(cfg.max_detections, P)
    for b, batch in clips.items():
        props, pmask = STEPDetector.initial_proposals(cfg, b, device=dev)
        times = []
        for clip in batch:
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
                      f"{label}: {key} shape {tuple(out[key].shape)}, expected {shape}")
                check(bool(torch.isfinite(out[key]).all()), f"{label}: {key} not finite")
            check(float(out["tube_scores"][:, cfg.num_proposals:].abs().max()) == 0.0,
                  f"{label}: padding proposals scored")
            check(bool(((out["tubes"] >= 0) & (out["tubes"] <= cfg.image_size)).all()),
                  f"{label}: tubes outside the image")
        print(f"    B={b}: request wall ms {', '.join(f'{t:.2f}' for t in times)} "
              f"(first warms up); {int(out['frame_mask'].sum())} survivors in the "
              f"last", flush=True)


def bf16_close(got: torch.Tensor, want: torch.Tensor, atol: float = 1e-5) -> bool:
    """Within one bf16 rounding step of each other."""
    return torch.allclose(got.float(), want.float(), rtol=BF16_RTOL, atol=atol)


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the card")
    from step_tpu_torch import PRESETS, kernels
    from step_tpu_torch.inference import detect_clip, nms_surface
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.models.optimize import optimize_for_inference
    from step_tpu_torch.ops.conv3d import (conv3x3x3_bn_relu, conv3x3x3_bn_relu_plain,
                                           pack_conv3x3x3_weight)
    from step_tpu_torch.ops.fused_bn_relu import (fused_scale_bias_relu,
                                                  fused_scale_bias_relu_plain)
    from step_tpu_torch.ops.nms import nms_many, nms_many_plain, premask_scores
    from step_tpu_torch.ops.pool import max_pool3x3_same, max_pool3x3_same_plain
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
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "wgmma" in line):
            print("    " + line.strip())
    n_hgmma = hgmma_count(path, kernels.nvcc_path())
    print(f"    HGMMA instructions in K3's bf16 kernels: {n_hgmma}", flush=True)

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
    # Bytes: boxes, scores and valid read, indices and mask written; each
    # kept box takes one IoU pass over the problem's P boxes (~13 f32 ops).
    results["nms_many"] = dict(
        max_abs_err=0.0, ms=nms_ms, plain_ms=nms_plain_ms, library_ms=None,
        **bound(B * T * C * P * 4 * 6 + B * T * C * K * 8,
                float(kept.sum()) * P * 13, F32_FLOPS))

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
    check(bf16_close(out_k, out_p),
          f"K2 roi_align bfloat16 differs from plain: max |err| {err16}")
    roi_ms = cuda_ms(lambda: roi(feat16))
    roi_plain_ms = cuda_ms(lambda: plain(feat16))
    # Bytes: the feature map and the boxes read once, the output written
    # once; operations: 4 corners x 2 f32 ops per sample per output element.
    roi_bound = bound(feat16.numel() * 2 + tubes.numel() * 4 + out_k.numel() * 2,
                      out_k.numel() * cfg.sampling_ratio ** 2 * 8, F32_FLOPS)
    print(f"[4] K2 roi_align on [{B},{Tp},{Hf},{Hf},832]: max |err| f32 {err32:.3g} "
          f"(tol 1e-4), bf16 {err16:.3g} (rtol 2^-7); bf16 kernel {roi_ms:.4f} ms, "
          f"plain {roi_plain_ms:.4f} ms, bound {roi_bound['bound_ms']:.4f} ms "
          f"({roi_bound['bound_ms'] / roi_ms:.1%} of it)", flush=True)
    results["tube_roi_align"] = dict(max_abs_err=err16, ms=roi_ms,
                                     plain_ms=roi_plain_ms, library_ms=None,
                                     **roi_bound)
    # The adaptive branch: boxes up to 800 px wide, 50 feature cells, so
    # ceil(50 / 7) = 8 samples per axis are capped at adaptive_max_ratio = 2.
    big = tubes.clone()
    big[:, 4:8] = torch.tensor([-300.0, -200.0, 500.0, 450.0], device=dev)
    for f, tol in ((feat32, 1e-4), (feat16, None)):
        got = tube_roi_align(f, big, cfg.pooled_size, 1.0 / cfg.feature_stride, 0)
        want = tube_roi_align_plain(f, big, cfg.pooled_size, 1.0 / cfg.feature_stride, 0)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = (torch.allclose(got, want, rtol=tol, atol=tol) if tol
              else bf16_close(got, want))
        check(ok and got.dtype == f.dtype,
              f"K2 roi_align {f.dtype} sampling_ratio=0 differs from plain: "
              f"max |err| {err}")
        print(f"    sampling_ratio=0, {f.dtype}: max |err| {err:.3g}", flush=True)
    roi0_ms = cuda_ms(lambda: tube_roi_align(feat16, big, cfg.pooled_size,
                                             1.0 / cfg.feature_stride, 0))
    print(f"    sampling_ratio=0, bf16 kernel {roi0_ms:.4f} ms", flush=True)

    # ---- 5. tiny float32 detector: card against CPU ---------------------
    tiny = cfg.replace(backbone_depth="tiny", feature_stride=8, image_size=64,
                       compute_dtype="float32")
    model_cpu = init_detector_(STEPDetector(tiny).eval(), SEED)
    model_gpu = init_detector_(STEPDetector(tiny).eval(), SEED).to(dev)
    props, pmask = STEPDetector.initial_proposals(tiny, 2, device="cpu")
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
          f"fused_inception={cfg_opt.fused_inception}, {cfg.compute_dtype}: built "
          f"in {time.time() - t0:.1f} s", flush=True)

    def new_clips(batches, n):
        return {b: [torch.from_numpy(rng.randint(0, 256, (b, T, cfg.image_size,
                                                          cfg.image_size, 3)
                                                 ).astype(np.uint8))
                    for _ in range(n)] for b in batches}

    os.environ["STEP_TPU_POOL3D"] = "direct"
    counters = {"nms_many": nms_many, "tube_roi_align": tube_roi_align,
                "max_pool3x3_same": max_pool3x3_same,
                "fused_scale_bias_relu": fused_scale_bias_relu,
                "conv3x3x3_bn_relu": conv3x3x3_bn_relu}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    serve(model, cfg, new_clips(SERVE_BATCHES, REQUESTS_PER_BATCH), dev, "main path")
    main_launches = {name: fn.launches for name, fn in counters.items()}
    print(f"    launches during serving: {main_launches}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    for name in ("nms_many", "tube_roi_align"):
        check(main_launches[name] > 0, f"kernel {name} never launched on the main path")
    del model

    # ---- 7. K5: 3x3x3 max pool ------------------------------------------
    for shape in ((8, 192, 9, 28, 28), (8, 480, 5, 14, 14), (128, 832, 5, 7, 7)):
        x32 = randn_cl(rng, shape, dev)
        x32[0, 0, 0, 0, :3] = float("nan")
        for x in (x32, x32.to(torch.bfloat16)):
            got, want = max_pool3x3_same(x), max_pool3x3_same_plain(x)
            torch.cuda.synchronize()
            check(torch.equal(got.isnan(), want.isnan()), f"K5 NaN differ at {shape}")
            ok = ~want.isnan()
            check(torch.equal(got[ok], want[ok]),
                  f"K5 pool {x.dtype} {shape} differs from plain: "
                  f"{int((got[ok] != want[ok]).sum())} elements")
        x16 = x32.to(torch.bfloat16)
        pool_ms = cuda_ms(lambda: max_pool3x3_same(x16))
        pool_plain_ms = cuda_ms(lambda: max_pool3x3_same_plain(x16))
        print(f"[7] K5 max_pool3x3 {list(shape)}: exact in f32 and bf16; bf16 kernel "
              f"{pool_ms:.4f} ms, plain {pool_plain_ms:.4f} ms", flush=True)
    # The plain version is one PyTorch call, F.max_pool3d, so it is also
    # the library's time. Bytes: x read once, out written once; 26 compares
    # per element.
    results["max_pool3x3_same"] = dict(
        max_abs_err=0.0, ms=pool_ms, plain_ms=pool_plain_ms,
        library_ms=cuda_ms(lambda: F.max_pool3d(x16, 3, 1, 1)),
        **bound(2 * x16.numel() * 2, 26 * x16.numel(), F32_FLOPS))

    # ---- 8. K4: BN + ReLU -----------------------------------------------
    for shape in ((8, 64, 9, 112, 112), (128, 384, 5, 7, 7)):
        x32 = randn_cl(rng, shape, dev)
        scale = torch.rand(shape[1], device=dev) * 2 + 0.1
        bias = torch.randn(shape[1], device=dev)
        got, want = fused_scale_bias_relu(x32, scale, bias), \
            fused_scale_bias_relu_plain(x32, scale, bias)
        torch.cuda.synchronize()
        err32 = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
              f"K4 bn_relu f32 {shape} differs from plain: max |err| {err32}")
        x16 = x32.to(torch.bfloat16)
        got, want = fused_scale_bias_relu(x16, scale, bias), \
            fused_scale_bias_relu_plain(x16, scale, bias)
        torch.cuda.synchronize()
        err16 = float((got.float() - want.float()).abs().max())
        check(got.dtype == torch.bfloat16 and bf16_close(got, want),
              f"K4 bn_relu bf16 {shape} differs from plain: max |err| {err16}")
        bn_ms = cuda_ms(lambda: fused_scale_bias_relu(x16, scale, bias))
        bn_plain_ms = cuda_ms(lambda: fused_scale_bias_relu_plain(x16, scale, bias))
        print(f"[8] K4 bn_relu {list(shape)}: max |err| f32 {err32:.3g} (tol 1e-6), "
              f"bf16 {err16:.3g} (one bf16 step); bf16 kernel {bn_ms:.4f} ms, "
              f"plain {bn_plain_ms:.4f} ms", flush=True)
        if shape[0] == 8:
            results["fused_scale_bias_relu"] = dict(
                max_abs_err=err16, ms=bn_ms, plain_ms=bn_plain_ms, library_ms=None,
                **bound(2 * x16.numel() * 2 + 2 * shape[1] * 4, 3 * x16.numel(),
                        F32_FLOPS))

    # ---- 9. K3: 3x3x3 conv + BN + ReLU -----------------------------------
    check(n_hgmma > 0, "K3's bf16 kernels hold no HGMMA instruction")
    for shape, K in (((8, 64, 9, 56, 56), 192), ((128, 160, 5, 7, 7), 320),
                     ((8, 24, 5, 14, 14), 64), ((8, 96, 5, 14, 14), 208)):
        x32 = randn_cl(rng, shape, dev)
        w = torch.randn(K, shape[1], 3, 3, 3, device=dev) / (27 * shape[1]) ** 0.5
        scale = torch.rand(K, device=dev) + 0.5
        bias = torch.randn(K, device=dev) * 0.1
        got, want = conv3x3x3_bn_relu(x32, w, scale, bias), \
            conv3x3x3_bn_relu_plain(x32, w, scale, bias)
        torch.cuda.synchronize()
        err32 = float((got - want).abs().max())
        check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
              f"K3 conv f32 {shape}->{K} differs from plain: max |err| {err32}")
        x16, w16 = x32.to(torch.bfloat16), w.to(torch.bfloat16)
        got, want = conv3x3x3_bn_relu(x16, w16, scale, bias), \
            conv3x3x3_bn_relu_plain(x16, w16, scale, bias)
        torch.cuda.synchronize()
        err16 = float((got.float() - want.float()).abs().max())
        check(got.dtype == torch.bfloat16 and bf16_close(got, want, K3_BF16_ATOL),
              f"K3 conv bf16 {shape}->{K} differs from plain: max |err| {err16}")
        # As a Unit3D calls it: the float32 parameter, its bf16 layout cached.
        cache = {}
        conv_ms = cuda_ms(lambda: conv3x3x3_bn_relu(x16, w, scale, bias,
                                                    weight_cache=cache), iters=10)
        conv_plain_ms = cuda_ms(lambda: conv3x3x3_bn_relu_plain(x16, w, scale, bias),
                                iters=10)
        # The library's yardstick: cuDNN's bf16 conv with the BN affine
        # folded into its weight and bias (as the main path serves a unit),
        # then an in-place ReLU.
        w_fold = (w * scale.view(-1, 1, 1, 1, 1)).to(torch.bfloat16)
        b_fold = bias.to(torch.bfloat16)
        cudnn_ms = cuda_ms(lambda: F.relu_(F.conv3d(x16, w_fold, b_fold, 1, 1)),
                           iters=10)
        pack_ms = cuda_ms(lambda: pack_conv3x3x3_weight(w, torch.bfloat16))
        M = shape[0] * int(np.prod(shape[2:]))
        flop = 2 * M * 27 * shape[1] * K
        conv_bound = bound(x16.numel() * 2 + w16.numel() * 2 + M * K * 2 + 2 * K * 4,
                           flop, BF16_TENSOR_FLOPS)
        print(f"[9] K3 conv3x3x3_bn_relu {list(shape)}->{K}: max |err| f32 "
              f"{err32:.3g} (tol 1e-4), bf16 {err16:.3g} (one bf16 step); bf16 "
              f"kernel {conv_ms:.4f} ms ({flop / conv_ms / 1e9:.1f} TFLOP/s, "
              f"{conv_bound['bound_ms'] / conv_ms:.1%} of the "
              f"{conv_bound['bound_ms']:.4f} ms bound); weight re-layout from the "
              f"f32 parameter (cached per unit) {pack_ms:.4f} ms; cuDNN bf16 (BN "
              f"folded) + ReLU {cudnn_ms:.4f} ms; "
              f"plain (f32 conv) {conv_plain_ms:.4f} ms", flush=True)
        if shape[0] == 128:
            results["conv3x3x3_bn_relu"] = dict(
                max_abs_err=err16, ms=conv_ms, plain_ms=conv_plain_ms,
                library_ms=cudnn_ms, **conv_bound)

    # ---- 10. the kernel path: unfolded, fused_bn_relu, K5 pools, bf16 ----
    os.environ["STEP_TPU_POOL3D"] = "pallas"
    kcfg = cfg.replace(fused_bn_relu=True)
    t0 = time.time()
    seeded = init_detector_(STEPDetector(cfg).eval(), SEED).state_dict()
    kmodel = STEPDetector(kcfg).eval()
    kmodel.load_state_dict(seeded)
    kmodel = kmodel.to(dev)        # float32 parameters, bf16 activations
    print(f"[10] ucf_3step {cfg.backbone_depth}, unfolded, fused_bn_relu, "
          f"STEP_TPU_POOL3D=pallas, {cfg.compute_dtype}: built in "
          f"{time.time() - t0:.1f} s", flush=True)
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats(dev)
    serve(kmodel, kcfg, new_clips(SERVE_BATCHES, KERNEL_PATH_REQUESTS), dev,
          "kernel path")
    kernel_launches = {name: fn.launches for name, fn in counters.items()}
    print(f"    launches during serving: {kernel_launches}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    for name, n in kernel_launches.items():
        check(n > 0, f"kernel {name} never launched on the kernel path")

    # ---- 11. float32, B=1: the kernel path against the main path ---------
    del kmodel
    cfg32 = cfg.replace(compute_dtype="float32")
    kmodel = STEPDetector(cfg32.replace(fused_bn_relu=True)).eval()
    kmodel.load_state_dict(seeded)
    kmodel = kmodel.to(dev)
    cfg_opt32, folded32 = optimize_for_inference(cfg32, seeded)
    mmodel = STEPDetector(cfg_opt32).eval()
    mmodel.load_state_dict(folded32)
    mmodel = mmodel.to(dev)
    props, pmask = STEPDetector.initial_proposals(cfg, 1, device=dev)
    clip = new_clips((1,), 1)[1][0].to(dev)
    got = detect_clip(kmodel, clip, props, pmask)
    os.environ["STEP_TPU_POOL3D"] = "direct"
    want = detect_clip(mmodel, clip, props, pmask)
    torch.cuda.synchronize()
    d_scores = float((got["tube_scores"] - want["tube_scores"]).abs().max())
    d_tubes = float((got["tubes"] - want["tubes"]).abs().max())
    print(f"[11] f32 B=1 kernel path vs main path: tube scores max |d| "
          f"{d_scores:.3g} (tol {PATH_SCORE_TOL}), tubes {d_tubes:.3g} px "
          f"(tol {PATH_TUBE_TOL})", flush=True)
    check(d_scores <= PATH_SCORE_TOL and d_tubes <= PATH_TUBE_TOL,
          f"kernel path differs from the main path: scores {d_scores}, "
          f"tubes {d_tubes} px")

    launches = {**{k: main_launches[k] for k in ("nms_many", "tube_roi_align")},
                **{k: kernel_launches[k] for k in ("max_pool3x3_same",
                                                   "fused_scale_bias_relu",
                                                   "conv3x3x3_bn_relu")}}
    meta = {
        "nms_many": ("step_tpu_torch/csrc/nms.cu", "step_tpu/ops/nms_pallas.py:38"),
        "tube_roi_align": ("step_tpu_torch/csrc/roi_align.cu",
                           "step_tpu/ops/roi_align_pallas.py:55"),
        "max_pool3x3_same": ("step_tpu_torch/csrc/pool3d.cu",
                             "step_tpu/ops/pool_pallas.py:42"),
        "fused_scale_bias_relu": ("step_tpu_torch/csrc/bn_relu.cu",
                                  "step_tpu/ops/fused_bn_relu.py:32"),
        "conv3x3x3_bn_relu": ("step_tpu_torch/csrc/conv3d.cu",
                              "step_tpu/ops/conv3d_pallas.py:45"),
    }
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] == "step_tpu" or m.startswith("jax"))
    check(not foreign, f"JAX or the JAX package was imported: {foreign[:5]}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[name]}
        for name, (src, rep) in meta.items()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
