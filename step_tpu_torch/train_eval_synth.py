"""Train on the synthetic oracle, then measure held-out frame-mAP and,
with `--video-eval N`, video-mAP through both linkers.

Port of `scripts/train_eval_synth.py`: a `StepConfig` for the synthetic
dataset (full I3D depth, `--image-size` px, `--classes` classes, two
actors at most, `--set` overrides on top) trains `--steps` steps on fresh
synthetic clips each step (clip seeds `seed * 1000 + step * batch + i`,
never repeated, as the JAX script draws them; built ahead by the port's
`DataLoader` threads), then `detect_clip` runs on `--eval-clips` held-out
clips (seeds from 10,000,000) and `eval/detection_metrics.py::frame_map`
scores them at IoU 0.5 and 0.2. `--video-eval N` then scores N held-out
synthetic videos of `VIDEO_WINDOWS` windows one chunk apart (seeds from
20,000,000) at video-mAP@0.2 and @0.5 with the host linker
(`collect_detections` → `dedupe_frame_detections` →
`link_frame_detections`) and with linking on the device
(`collect_video_tubes`), under the JAX script's keys
(`video_mAP@0.2_host`, ...), with the seconds and detection counts of
that evaluation. Prints one JSON line, with the script's `tag` and
`overrides`.

The JAX script's other flags keep their meanings:
`--same-class-actors` (scenes whose actors share one class, in training
and evaluation), `--save-variables PATH` (after training, `{params,
batch_stats}` as a flax msgpack file in the JAX package's layout,
`utils/msgpack_codec.py`, which the JAX script's `--load-variables`
reads), `--load-variables PATH` (skip training, evaluate such a file,
the JAX script's or this one's) and `--load-ckpt-dir DIR` (skip training,
restore the newest checkpoint of a `fit` run: the port's `<step>.pt`, or,
where `tensorstore` is installed, the JAX package's orbax directory —
the train → checkpoint → fresh-process restore → evaluate journey). The
config must match what was saved. The JAX script's `--video-windows` is
not carried: the windows stay `VIDEO_WINDOWS`. `--tag` defaults to
"baseline" (the JAX script requires it).

    python -m step_tpu_torch.train_eval_synth --steps 700 --batch 8 \\
        --image-size 112 --classes 4 --eval-clips 48 --video-eval 12

It runs on the card; `--device cpu` runs it on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

EVAL_SEED, VIDEO_SEED = 10_000_000, 20_000_000
VIDEO_WINDOWS = 11  # sliding windows per held-out video, as in the JAX script


class SyntheticClips:
    """A dataset of synthetic clips (`data/synthetic.py`): clip i is drawn
    from seed `seed + i`, so batch k of an unshuffled loader is
    `make_batch(seed + k * batch, batch)`. `with_flow` adds each clip's
    flow (`make_flow`), for a two-stream or flow-stream detector."""

    def __init__(self, syn, n: int, seed: int, with_flow: bool = False):
        self.syn, self.n, self.seed, self.with_flow = syn, n, seed, with_flow

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        from step_tpu_torch.data.synthetic import make_clip, make_flow

        clip = make_clip(self.seed + i, self.syn)
        if self.with_flow:
            clip["flow"] = make_flow(clip["rgb"])
        return clip


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tag", default="baseline")
    p.add_argument("--steps", type=int, default=700)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--image-size", type=int, default=112)
    p.add_argument("--classes", type=int, default=4)
    p.add_argument("--eval-clips", type=int, default=48)
    p.add_argument("--eval-batch", type=int, default=8)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--video-eval", type=int, default=0,
                   help="also score held-out video-mAP on this many synthetic long "
                        "videos through both linkers (host greedy, device K-tube)")
    p.add_argument("--set", dest="overrides", default=None,
                   help="comma-separated cfg overrides, e.g. reg_head=frame_fc")
    p.add_argument("--same-class-actors", action="store_true",
                   help="synthetic scenes whose actors all share one class, in "
                        "training and evaluation")
    p.add_argument("--save-variables", default=None, metavar="PATH",
                   help="after training, write {params, batch_stats} as a flax "
                        "msgpack file in the JAX package's layout")
    p.add_argument("--load-variables", default=None, metavar="PATH",
                   help="skip training; evaluate variables saved by --save-variables "
                        "(this script's or the JAX script's; config must match)")
    p.add_argument("--load-ckpt-dir", default=None, metavar="DIR",
                   help="skip training; restore the newest checkpoint of a fit() run "
                        "(the port's, or the JAX package's orbax with tensorstore; "
                        "config must match)")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def synth_config(args):
    """The JAX script's configuration for these arguments, `--set` on top."""
    from step_tpu_torch.config import StepConfig
    from step_tpu_torch.utils.cli import apply_overrides

    cfg = StepConfig(dataset="synthetic", num_classes=args.classes,
                     image_size=args.image_size, batch_size=args.batch,
                     learning_rate=args.lr,
                     warmup_steps=min(100, args.steps // 5),
                     total_steps=args.steps, max_gt_tubes=2)
    return apply_overrides(cfg, [args.overrides]) if args.overrides else cfg


def synth_data(cfg, args):
    """The synthetic scenes of the script's config and flags."""
    from step_tpu_torch.data.synthetic import SyntheticConfig

    return SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                           num_classes=cfg.num_classes, max_boxes=cfg.max_gt_tubes,
                           same_class_actors=args.same_class_actors)


def evaluate(model, cfg, syn, eval_clips: int, eval_batch: int, device) -> dict:
    """Held-out frame-mAP@0.5 and @0.2 of `model` on synthetic clips (with
    their flow for a two-stream detector, as the JAX script passes it)."""
    from step_tpu_torch.data.pipeline import build_model_batch
    from step_tpu_torch.data.synthetic import make_batch, make_flow
    from step_tpu_torch.eval.detection_metrics import frame_map
    from step_tpu_torch.inference import detect_clip
    from step_tpu_torch.models.detector import STEPDetector

    detections, frame_gt = [], []
    T = cfg.total_frames
    for start in range(0, eval_clips, eval_batch):
        n = min(eval_batch, eval_clips - start)
        raw = make_batch(EVAL_SEED + start, n, syn)
        b = build_model_batch(raw, cfg, train=False)
        props, pmask = STEPDetector.initial_proposals(cfg, n, device=device)
        flow = (torch.from_numpy(np.stack([make_flow(r) for r in raw["rgb"]])).to(device)
                if cfg.two_stream else None)
        out = detect_clip(model, torch.from_numpy(b["rgb"]).to(device), props, pmask, flow)
        boxes = out["frame_boxes"].float().cpu().numpy()
        scores = out["frame_scores"].float().cpu().numpy()
        mask = out["frame_mask"].cpu().numpy()
        for bi in range(n):
            vid = start + bi
            for g in range(raw["gt_mask"].shape[1]):
                if raw["gt_mask"][bi, g] <= 0:
                    continue
                cls = int(raw["gt_labels"][bi, g])
                for t in range(T):
                    frame_gt.append(((vid, t), cls, raw["gt_tubes"][bi, g, t]))
            keep = np.argwhere((mask[bi] > 0) & (scores[bi] > cfg.score_thresh))
            for t, c, k in keep:
                detections.append(((vid, int(t)), int(c), float(scores[bi, t, c, k]),
                                   boxes[bi, t, c, k]))
    return {f"frame_mAP@{thr}": round(float(frame_map(detections, frame_gt,
                                                       cfg.num_classes, thr)["mAP"]), 4)
            for thr in (0.5, 0.2)}


def evaluate_videos(model, cfg, num_videos: int, windows: int, eval_batch: int,
                    same_class_actors: bool = False) -> dict:
    """Held-out video-mAP@0.2 and @0.5 of `model` on `num_videos` synthetic
    videos, host and device linking, and under "video_eval_timings" the
    seconds of detection collection (with dedupe), of the host linker and
    of device linking (its own detection pass included), the detections
    kept at `cfg.score_thresh` per window, and the tubes of each linker."""
    from step_tpu_torch.data.synthetic import SyntheticConfig, SyntheticVideoDataset
    from step_tpu_torch.eval.detection_metrics import video_map
    from step_tpu_torch.evaluate import (collect_detections, collect_video_tubes,
                                         dedupe_frame_detections, link_frame_detections)

    T, fpc = cfg.total_frames, cfg.frames_per_chunk
    vds = SyntheticVideoDataset(
        SyntheticConfig(image_size=cfg.image_size, num_frames=(windows - 1) * fpc + T,
                        num_classes=cfg.num_classes, max_boxes=cfg.max_gt_tubes,
                        same_class_actors=same_class_actors),
        num_videos=num_videos, num_windows=windows, window_frames=T, stride=fpc,
        seed=VIDEO_SEED, with_flow=cfg.two_stream or cfg.input_stream == "flow")
    gt = vds.video_gt()
    times = {}
    t0 = time.perf_counter()
    dets = dedupe_frame_detections(collect_detections(model, vds, batch_size=eval_batch,
                                                      image_scale_to_gt=False))
    times["collect_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tubes = {"host": link_frame_detections(dets)}
    times["link_host_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tubes["device"] = collect_video_tubes(model, vds, image_scale_to_gt=False)
    times["device_linking_s"] = time.perf_counter() - t0   # its own detection pass too
    result = {f"video_mAP@{thr}_{name}": round(float(video_map(tubes[name], gt,
                                                               cfg.num_classes, thr)["mAP"]), 4)
              for name in ("host", "device") for thr in (0.2, 0.5)}
    result["video_eval_timings"] = dict(
        times, windows=len(vds), n_detections=len(dets),
        detections_per_window=len(dets) / len(vds), score_thresh=cfg.score_thresh,
        n_tubes_host=len(tubes["host"]), n_tubes_device=len(tubes["device"]))
    return result


def trained_model(cfg, args, syn, device):
    """The model to evaluate, as the flags say: trained here (→ model, the
    loss curve, the training seconds), or loaded from `--load-variables`
    or `--load-ckpt-dir` (no loss curve, 0 s)."""
    from step_tpu_torch.data.loader import DataLoader
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.train.trainer import batch_to_device, create_train_state, train_step

    if args.load_variables:
        from step_tpu_torch.convert import from_jax_variables
        from step_tpu_torch.utils.msgpack_codec import read_variables

        model = STEPDetector(cfg)
        model.load_state_dict(from_jax_variables(read_variables(args.load_variables), cfg))
        return model.to(device), [], 0.0
    if args.load_ckpt_dir:
        from step_tpu_torch.utils.checkpoint import restore_checkpoint

        state = create_train_state(cfg, args.seed, model=STEPDetector(cfg), device=device)
        state, _ = restore_checkpoint(args.load_ckpt_dir, state)
        print(f"restored step {state.step} from {args.load_ckpt_dir}", flush=True)
        return state.model, [], 0.0
    state = create_train_state(cfg, args.seed, device=device)
    loader = DataLoader(SyntheticClips(syn, args.steps * cfg.batch_size, args.seed * 1000,
                                       with_flow=cfg.two_stream),
                        cfg, shuffle=False, seed=args.seed)
    t0 = time.time()
    losses = []
    for step, b in enumerate(loader.epoch(0)):
        state, metrics = train_step(state, batch_to_device(b, device), cfg)
        if step % 50 == 0 or step == args.steps - 1:
            losses.append(round(float(metrics["loss"]), 3))
            print(f"step {step}: loss={losses[-1]}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return state.model, losses, time.time() - t0


def main(argv=None):
    args = parse_args(argv)
    from step_tpu_torch.convert import to_jax_variables
    from step_tpu_torch.train.trainer import resolve_device
    from step_tpu_torch.utils.msgpack_codec import write_variables

    device = resolve_device(args.device)
    cfg = synth_config(args)
    syn = synth_data(cfg, args)
    model, losses, train_s = trained_model(cfg, args, syn, device)
    model.eval()
    if args.save_variables:
        write_variables(args.save_variables, to_jax_variables(model.state_dict(), cfg))
        print(f"saved variables -> {args.save_variables}", flush=True)
    result = evaluate(model, cfg, syn, args.eval_clips, args.eval_batch, device)
    if args.video_eval > 0:
        result.update(evaluate_videos(model, cfg, args.video_eval, VIDEO_WINDOWS,
                                      args.eval_batch, args.same_class_actors))
    record = {
        "tag": args.tag, "overrides": args.overrides,
        "steps": args.steps, "batch": cfg.batch_size, "image_size": cfg.image_size,
        "num_classes": cfg.num_classes, **result, "loss_curve": losses,
        "train_s": round(train_s, 1),
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu"),
    }
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
