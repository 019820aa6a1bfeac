"""Run the detector on a video and write it back with the linked action
tubes drawn on it.

Port of the JAX package's `demo.py`: decode the video (`utils/vis.py`),
tile it into clips of `total_frames` (the tail padded by repeating the
last frame), detect every clip in one batch and link the clips' tubes into
video tubes on the device (`inference.detect_video`), draw each linked
tube above `--score-thresh` on the frames it is active (`annotate`), and
write the annotated video:

    python -m step_tpu_torch.cli.demo --video in.mp4 --output out.mp4 \\
        --ckpt-dir runs/ucf/ckpt --class-names Run,Jump

Without `--ckpt-dir` the detector has random weights from seed 0 (a smoke
test). It runs on the card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    from step_tpu_torch.utils.cli import add_common_args

    p = argparse.ArgumentParser(description="Run the STEP detector on a video "
                                            "(PyTorch port)")
    p.add_argument("--video", required=True)
    p.add_argument("--output", default="out.mp4")
    p.add_argument("--preset", default="streaming")
    p.add_argument("--ckpt-dir", default=None,
                   help="the port's checkpoints, or the JAX package's orbax "
                        "directories where tensorstore is installed (random weights "
                        "if absent)")
    p.add_argument("--score-thresh", type=float, default=0.3)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--class-names", default=None, help="comma-separated names")
    p.add_argument("--tiny", action="store_true")
    add_common_args(p)
    return p.parse_args(argv)


def annotate(frames, det, cfg, class_names=None):
    """The frames `[F, H, W, 3]` with the linked tubes of `det` (numpy:
    tubes `[L, P, T, 4]` at the model's resolution, link_paths and
    link_trim `[C, K, L]`, link_tube_scores `[C, K]`) drawn on them: on
    frame f, of clip f // T, every video tube whose score is at least
    `cfg.score_thresh` and which is active in that clip, its box scaled to
    the frame → a list of F uint8 frames."""
    import numpy as np

    from step_tpu_torch.utils.vis import draw_detections

    tubes, paths = det["tubes"], det["link_paths"]
    trim, tube_scores = det["link_trim"], det["link_tube_scores"]
    T, S = cfg.total_frames, cfg.image_size
    H, W = frames.shape[1:3]
    scale = np.asarray([W / S, H / S, W / S, H / S])
    annotated = []
    for fi in range(frames.shape[0]):
        l, t = fi // T, fi % T
        boxes, labels, scores = [], [], []
        for c in range(paths.shape[0]):
            for k in range(paths.shape[1]):
                s = tube_scores[c, k]
                if s >= cfg.score_thresh and trim[c, k, l] > 0:
                    boxes.append(tubes[l, paths[c, k, l], t] * scale)
                    labels.append(c)
                    scores.append(float(s))
        annotated.append(draw_detections(frames[fi], np.asarray(boxes).reshape(-1, 4),
                                         labels, scores, class_names=class_names))
    return annotated


def main(argv=None) -> int:
    args = parse_args(argv)
    import cv2
    import numpy as np
    import torch

    from step_tpu_torch.config import PRESETS
    from step_tpu_torch.inference import detect_video
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.utils.cli import apply_overrides
    from step_tpu_torch.utils.vis import extract_frames, write_video

    cfg = PRESETS[args.preset].replace(score_thresh=args.score_thresh)
    if args.tiny:
        cfg = cfg.replace(backbone_depth="tiny", feature_stride=8)
    cfg = apply_overrides(cfg, args.overrides)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cli.demo runs on a CUDA card and none is available; pass "
                           "--device cpu (device='cpu') to run on the CPU")
    model = STEPDetector(cfg)
    if args.ckpt_dir:
        from step_tpu_torch.utils.checkpoint import load_model_state

        model.load_state_dict(load_model_state(args.ckpt_dir))
    else:
        from step_tpu_torch.utils.init import init_detector_

        print("WARNING: no checkpoint given — using random weights (smoke test)")
        init_detector_(model, seed=0)
    model = model.eval().to(device)

    frames = extract_frames(args.video, args.max_frames)   # [F, H, W, 3] in [0, 1]
    F_all = frames.shape[0]
    S, T = cfg.image_size, cfg.total_frames
    resized = np.stack([cv2.resize(f, (S, S)) for f in frames])
    # tile into L clips of total_frames, the tail padded with the last frame
    L = max(1, -(-F_all // T))
    pad = L * T - F_all
    if pad:
        resized = np.concatenate([resized, np.repeat(resized[-1:], pad, 0)])
    clips = torch.from_numpy(resized.reshape(L, T, S, S, 3).astype(np.float32)).to(device)
    det = {k: v.float().cpu().numpy() if v.is_floating_point() else v.cpu().numpy()
           for k, v in detect_video(model, clips).items()}
    names = args.class_names.split(",") if args.class_names else None
    write_video(args.output, annotate(frames, det, cfg, names))
    print(f"wrote {args.output} ({F_all} frames, {L} clips)")
    return F_all


if __name__ == "__main__":
    main()
