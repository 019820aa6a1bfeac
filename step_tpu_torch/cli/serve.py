"""Serve an exported detect program over frame directories.

Port of the JAX package's `serve.py`. A serving process needs:

  * the program, `cli/export.py --out detect.pt2` (`torch.export`),
  * a directory of the port's checkpoints (`<step>.pt`, `utils/
    checkpoint.py`): the weights are not in the program,
  * frame images per video.

No model is built and nothing is traced at serving time: the program is
loaded and called on the newest checkpoint's weights, folded by
`models/optimize.py` when the program was exported with `--optimized`
(pass the same preset, `--optimized` and `--set` flags as to the export).
A program of the kernel configuration (exported with `--set
fused_bn_relu=True`, `cli/export.py`) holds its K3 and K4 nodes beside the
pool kernels' (K5 and the strided `step::max_pool3d_same`, in every
program) and is served with `--set fused_bn_relu=True`. `--ckpt-dir` takes the
port's checkpoints or, where `tensorstore` is installed, the JAX
package's orbax directories (`utils/checkpoint.py::load_model_state`).

    python -m step_tpu_torch.cli.serve --program detect.pt2 --preset ucf_3step \\
        --optimized --ckpt-dir runs/ucf/ckpt --frames-dir /data/frames/video1 \\
        --out dets.pkl

By default it detects with the evaluation's ownership protocol (windows of
`total_frames` one chunk apart, each frame scored by the clip whose
central chunk owns it), so its detections equal `cli.test --dump`'s on
the same frames; `--fast-tiling` tiles without overlap. The next video's
frames decode on a worker thread while the current one is served. It runs
on the card unless `--device cpu` is given; the program must have been
exported for that device. The JAX package's `--vmem-limit-kib` is a TPU
compiler option and is not carried over.
"""

from __future__ import annotations

import argparse
import os
import pickle


def parse_args(argv=None):
    from step_tpu_torch.utils.cli import add_common_args

    p = argparse.ArgumentParser(description="Serve an exported detect program "
                                            "(PyTorch port)")
    p.add_argument("--program", required=True, help="the program from cli.export")
    p.add_argument("--preset", default="ucf_3step")
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--frames-dir", required=True,
                   help="directory of frame images (sorted order), or a directory "
                        "of such per-video directories")
    p.add_argument("--out", default="detections.pkl")
    p.add_argument("--batch-size", type=int, default=8,
                   help="must match the exported program's batch dimension")
    p.add_argument("--optimized", action="store_true",
                   help="the program was exported with --optimized; fold the "
                        "checkpoint to match")
    p.add_argument("--fast-tiling", action="store_true",
                   help="detect on non-overlapping total_frames windows (3x fewer "
                        "clips) instead of the evaluation's ownership protocol; 2/3 "
                        "of the frames are then scored from extension positions")
    p.add_argument("--tiny", action="store_true")
    add_common_args(p)
    return p.parse_args(argv)


def _video_dirs(root):
    entries = sorted(os.listdir(root))
    subdirs = [os.path.join(root, e) for e in entries
               if os.path.isdir(os.path.join(root, e))]
    return subdirs if subdirs else [root]


def _sliding_windows(F, cfg):
    """The ownership tiling of an F-frame video → (idx `[L, T]`, the
    clamped 0-based frame indices of each window, owned `[F]` bool).

    Windows start one chunk apart and are centred at `start + fpc // 2`,
    as `UCFDataset.clip_frame_indices` samples them; a frame is owned when
    the central chunk of some window covers it, taken from the windows'
    real (clamped) indices, as `evaluate.collect_detections` owns frames."""
    import numpy as np

    fpc, T = cfg.frames_per_chunk, cfg.total_frames
    starts = np.arange(0, max(F - fpc + 1, 1), fpc)
    offsets = np.arange(T) - T // 2
    idx = np.clip(starts[:, None] + fpc // 2 + offsets[None, :], 0, F - 1)
    tc0 = (T - fpc) // 2
    owned = np.zeros(F, bool)
    owned[idx[:, tc0: tc0 + fpc].ravel()] = True
    return idx, owned


def _load_clips(frames_dir, cfg, fast_tiling=False):
    """Frame images → (clips `[L, T, S, S, 3]` float in [0, 1], idx `[L, T]`
    frame indices, owned `[F]` bool or None).

    By default the evaluation's ownership protocol (`_sliding_windows`):
    the serving loop keeps a detection only from its owning clip's
    central positions, and from extension positions for frames no clip
    owns. `fast_tiling=True` tiles non-overlapping T-frame windows, the
    tail padded by repeating the last frame (idx -1 marks the padding),
    every position emitted, and owned is None."""
    import cv2
    import numpy as np

    names = sorted(f for f in os.listdir(frames_dir)
                   if f.lower().endswith((".jpg", ".jpeg", ".png")))
    if not names:
        raise FileNotFoundError(f"no frames under {frames_dir}")
    S, T = cfg.image_size, cfg.total_frames
    frames = []
    for n in names:
        img = cv2.imread(os.path.join(frames_dir, n), cv2.IMREAD_COLOR)
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
        frames.append(cv2.resize(img, (S, S)))
    F = len(frames)
    if fast_tiling:
        L = max(1, -(-F // T))
        frames = np.stack(frames + [frames[-1]] * (L * T - F))
        idx = np.arange(L * T).reshape(L, T)
        idx[idx >= F] = -1
        return frames.reshape(L, T, S, S, 3), idx, None
    if cfg.temporal_stride != 1:
        # collect_detections' guard: the ownership protocol samples every
        # frame and tiles clips one chunk apart
        raise SystemExit("the serve ownership protocol requires temporal_stride == 1 "
                         f"(got {cfg.temporal_stride}); use --fast-tiling for strided "
                         "programs")
    frames = np.stack(frames)
    idx, owned = _sliding_windows(F, cfg)
    return frames[idx], idx, owned


def serve_video(run, weights, cfg, clips, idx, owned, props, pmask, B, video, wire):
    """Detect one video's clips → [((video, frame), class, score, box)].

    `run(weights, rgb, props, pmask)` is the detect program
    (`utils/export.py::load_detect_fn`); `clips`, `idx` and `owned` come
    from `_load_clips`; `wire` turns a float batch into the program's
    input tensor. With `owned`, each frame keeps the detections of the
    clip whose central chunk owns it, and a frame no clip owns those of
    the extension positions, as `evaluate.collect_detections` keeps them.
    Dedupe is the caller's (`main` dedupes across videos, as `cli.test
    --dump` does)."""
    import numpy as np

    T, fpc = cfg.total_frames, cfg.frames_per_chunk
    tc0 = (T - fpc) // 2
    detections = []
    for s in range(0, clips.shape[0], B):
        chunk = clips[s: s + B]
        n = chunk.shape[0]
        if n < B:  # pad the final batch; the padded rows are dropped below
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], B - n, axis=0)])
        out = run(weights, wire(chunk), props, pmask)
        boxes = out["frame_boxes"][:n].cpu().numpy()
        scores = out["frame_scores"][:n].cpu().numpy()
        mask = out["frame_mask"][:n].cpu().numpy()
        for b in range(n):
            for t, c, k in np.argwhere((mask[b] > 0) & (scores[b] > cfg.score_thresh)):
                fi = int(idx[s + b, t])
                if fi < 0:  # the repeated tail's padding, not a frame
                    continue
                if owned is not None and not (tc0 <= t < tc0 + fpc) and owned[fi]:
                    continue
                detections.append(((video, fi + 1), int(c), float(scores[b, t, c, k]),
                                   boxes[b, t, c, k]))
    return detections


def main(argv=None) -> list:
    args = parse_args(argv)
    import numpy as np
    import torch

    from step_tpu_torch.config import PRESETS
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.utils.checkpoint import load_model_state
    from step_tpu_torch.utils.cli import apply_overrides
    from step_tpu_torch.utils.export import (detect_fn_input_specs, load_detect_fn,
                                             load_program, serving_weights)

    cfg = PRESETS[args.preset]
    if args.tiny:
        cfg = cfg.replace(backbone_depth="tiny", feature_stride=8)
    cfg = apply_overrides(cfg, args.overrides)
    if cfg.input_stream != "rgb":
        # _load_clips decodes RGB images; a flow-stream program takes int8
        # flow, which cannot be made from the frames here
        raise SystemExit("cli.serve serves RGB-stream programs only "
                         f"(input_stream={cfg.input_stream!r})")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cli.serve runs on a CUDA card and none is available; pass "
                           "--device cpu (device='cpu') to serve a CPU program")
    state_dict = load_model_state(args.ckpt_dir)
    if args.optimized:
        from step_tpu_torch.models.optimize import optimize_for_inference_cli

        # the --set serving flags must be those the program was exported with
        cfg, state_dict = optimize_for_inference_cli(cfg, args.overrides, state_dict)
    weights = serving_weights(state_dict, cfg, device)

    exported = load_program(args.program)       # read once, for both uses
    run = load_detect_fn(exported)
    print(f"loaded program {args.program} ({os.path.getsize(args.program)} bytes)",
          flush=True)
    # The program's input spec was fixed at export; check the config's wire
    # format against it before the first batch.
    rgb_dtype = detect_fn_input_specs(exported)[0][1]
    want = torch.uint8 if cfg.uint8_transfer else torch.float32
    if rgb_dtype != want:
        raise SystemExit(
            f"program expects {rgb_dtype} frames but the config's wire format is "
            f"{want} (uint8_transfer={cfg.uint8_transfer}); rerun with --set "
            f"uint8_transfer={not cfg.uint8_transfer} to match the program")

    B = args.batch_size
    props, pmask = STEPDetector.initial_proposals(cfg, B, device=device)
    if cfg.uint8_transfer:
        from step_tpu_torch.data.pipeline import rgb_to_uint8_wire as quantize
    else:
        def quantize(x):
            return np.asarray(x, np.float32)

    def wire(chunk):
        return torch.from_numpy(quantize(chunk)).to(device)

    # Decode the next video's images on a worker thread while the current
    # one is served (cv2 releases the GIL while it decodes).
    from concurrent.futures import ThreadPoolExecutor

    detections = []
    vdirs = _video_dirs(args.frames_dir)
    pool = ThreadPoolExecutor(1)
    try:
        pending = pool.submit(_load_clips, vdirs[0], cfg, args.fast_tiling)
        for i, vdir in enumerate(vdirs):
            video = os.path.basename(vdir.rstrip("/"))
            clips, idx, owned = pending.result()
            if i + 1 < len(vdirs):
                pending = pool.submit(_load_clips, vdirs[i + 1], cfg, args.fast_tiling)
            detections.extend(serve_video(run, weights, cfg, clips, idx, owned, props,
                                          pmask, B, video, wire))
            print(f"{video}: {clips.shape[0]} clips served", flush=True)
    finally:
        # a failing serve does not wait for the decode in flight
        pool.shutdown(wait=False, cancel_futures=True)

    if not args.fast_tiling:
        # the clamped windows revisit the edge frames: collapse the
        # duplicates as the evaluation's dump does
        from step_tpu_torch.evaluate import dedupe_frame_detections

        detections = dedupe_frame_detections(detections)
    with open(args.out, "wb") as f:
        pickle.dump({"detections": detections}, f)
    print(f"wrote {len(detections)} detections -> {args.out}")
    return detections


if __name__ == "__main__":
    main()
