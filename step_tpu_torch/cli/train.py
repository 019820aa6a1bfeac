"""Train the detector on UCF101-24 (or a dataset in its layout), on AVA,
or on the synthetic oracle's clips.

Port of the JAX package's `train.py` on the port's `train/fit.py::fit`,
on the card (`--device cpu` for the CPU):

    python -m step_tpu_torch.cli.train --preset ucf_3step --data-root /data/ucf24 \\
        --ckpt-dir runs/ucf/ckpt --log-dir runs/ucf --epochs 8 \\
        --eval-every-epochs 1
    python -m step_tpu_torch.cli.train --preset two_stream_train --data-root /data/ucf24 --flow
    python -m step_tpu_torch.cli.train --preset ava_3step --dataset ava --data-root /data/ava \\
        --annotation-file ava_train_v2.1.csv --label-map ava_action_list_v2.1.pbtxt \\
        --exclusions ava_train_excluded_timestamps_v2.1.csv --ckpt-dir runs/ava/ckpt
    python -m step_tpu_torch.cli.train --dataset synthetic --steps 200

`--flow` trains the two-stream detector on the UCF layout's `brox-images`
(a flow-stream detector, for late fusion, is `--set input_stream=flow`).
`--eval-every-epochs N` scores the held-out data every N epochs, bounded
by `--eval-max-batches`: the UCF test split with `evaluate_ucf`, AVA's
validation CSV (`--eval-annotation-file`) with `evaluate_ava`.
`--pretrained-i3d i3d.pt` starts the backbone from a Kinetics I3D
checkpoint in any public naming (`models/convert.py`); `--set
adam_moments=int8` keeps AdamW's moments in 8-bit blocks and `--set
reg_head=frame_fc` trains the reference's 4·T regression FC.
`--distributed` trains data-parallel, one process a card, under torchrun:

    torchrun --nproc-per-node 8 -m step_tpu_torch.cli.train --distributed \
        --preset ucf_3step --data-root /data/ucf24 --ckpt-dir runs/ucf/ckpt

Each process loads its share, `batch_size // processes`, of the global
batch; as in the JAX package, `--eval-every-epochs` is refused with it.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    from step_tpu_torch.utils.cli import add_common_args

    p = argparse.ArgumentParser(description="Train the STEP detector (PyTorch port)")
    p.add_argument("--preset", default=None, help="named config preset")
    p.add_argument("--dataset", default=None, help="ucf101_24 | ava | synthetic")
    p.add_argument("--data-root", default=None)
    p.add_argument("--annotation-file", default=None)
    p.add_argument("--flow", action="store_true", help="load optical flow (two-stream)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--steps", type=int, default=None, help="total optimizer steps")
    p.add_argument("--epochs", type=int, default=8)
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--ckpt-dir", default=None)
    p.add_argument("--log-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--pretrained-i3d", default=None,
                   help="Kinetics-pretrained torch I3D checkpoint (.pt/.pth) for the "
                        "backbone")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--distributed", action="store_true",
                   help="data-parallel training over the process group that "
                        "torchrun's environment names (one card a process)")
    p.add_argument("--tiny", action="store_true", help="tiny backbone (debug)")
    p.add_argument("--eval-every-epochs", type=int, default=0,
                   help="held-out evaluation every N epochs (0 = off); ucf101_24 "
                        "scores the test split's frame- and video-mAPs, ava the "
                        "validation CSV's keyframe frame-mAP")
    p.add_argument("--eval-max-batches", type=int, default=25,
                   help="bound each in-training evaluation to N detection batches")
    p.add_argument("--eval-annotation-file", default=None,
                   help="annotations for --eval-every-epochs (AVA: the validation "
                        "CSV, default ava_val_v2.1.csv; UCF: the training pickle's "
                        "test split)")
    p.add_argument("--label-map", default=None,
                   help="AVA label-map pbtxt (the evaluated-class whitelist)")
    p.add_argument("--exclusions", default=None,
                   help="AVA excluded-timestamps CSV (relative to the data root)")
    p.add_argument("--fps", type=int, default=30,
                   help="AVA frame-extraction rate (frames per second)")
    add_common_args(p)
    return p.parse_args(argv)


def build_config(args):
    from step_tpu_torch.config import PRESETS, StepConfig
    from step_tpu_torch.utils.cli import apply_overrides

    cfg = PRESETS[args.preset] if args.preset else StepConfig()
    over = {}
    if args.dataset:
        over["dataset"] = args.dataset
        if args.dataset == "synthetic":
            over.update(num_classes=4, image_size=64)
    if args.batch_size:
        over["batch_size"] = args.batch_size
    if args.lr:
        over["learning_rate"] = args.lr
    if args.steps:
        over["total_steps"] = args.steps
    if args.image_size:
        over["image_size"] = args.image_size
    if args.flow:
        over["two_stream"] = True
    if args.tiny:
        over.update(backbone_depth="tiny", feature_stride=8)
    cfg = cfg.replace(**over) if over else cfg
    return apply_overrides(cfg, args.overrides)


def build_dataset(cfg, args):
    if cfg.dataset == "synthetic":
        # 512 oracle clips, clip i drawn from seed i
        from step_tpu_torch.data.synthetic import SyntheticConfig
        from step_tpu_torch.train_eval_synth import SyntheticClips

        syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                              num_classes=cfg.num_classes, max_boxes=cfg.max_gt_tubes)
        return SyntheticClips(syn, 512, 0)
    if cfg.dataset == "ava":
        return ava_dataset(cfg, args, args.annotation_file or "ava_train_v2.1.csv",
                           augment=True)
    from step_tpu_torch.data.ucf import UCFDataset
    from step_tpu_torch.inference import eval_needs_flow

    return UCFDataset(args.data_root, cfg, split="train",
                      annotation_file=args.annotation_file or "UCF101v2-GT.pkl",
                      augment=True, with_flow=eval_needs_flow(cfg))


def ava_dataset(cfg, args, annotation_file: str, augment: bool = False):
    """An `AVADataset` under `--data-root` with `--label-map`, `--exclusions`
    and `--fps` (shared with `cli/test.py`)."""
    from step_tpu_torch.data.ava import AVADataset
    from step_tpu_torch.eval.ava_eval import AVALabelMap

    label_map = AVALabelMap.from_pbtxt(args.label_map) if args.label_map else None
    return AVADataset(args.data_root, cfg, annotation_file, fps=args.fps,
                      augment=augment, label_map=label_map,
                      exclusions_file=args.exclusions)


def build_eval_fn(cfg, args):
    """The held-out evaluation `fit()` runs every `--eval-every-epochs`,
    `--eval-max-batches` batches: `evaluate_ucf` on the UCF test split,
    `evaluate_ava` on AVA's validation CSV."""
    if cfg.dataset == "ava":
        from step_tpu_torch.evaluate import evaluate_ava

        # --annotation-file is the training CSV here; the evaluation has its own
        val = ava_dataset(cfg, args, args.eval_annotation_file or "ava_val_v2.1.csv")

        def eval_fn(state, epoch):
            return evaluate_ava(state.model, val, max_batches=args.eval_max_batches)

        return eval_fn
    if cfg.dataset != "ucf101_24":
        raise SystemExit("--eval-every-epochs evaluates ucf101_24 and ava; for the "
                         "synthetic oracle use python -m step_tpu_torch.train_eval_synth")
    from step_tpu_torch.data.ucf import UCFDataset
    from step_tpu_torch.evaluate import evaluate_ucf
    from step_tpu_torch.inference import eval_needs_flow

    val = UCFDataset(args.data_root, cfg, split="test",
                     annotation_file=args.eval_annotation_file or args.annotation_file
                     or "UCF101v2-GT.pkl", with_flow=eval_needs_flow(cfg))

    def eval_fn(state, epoch):
        return evaluate_ucf(state.model, val, max_batches=args.eval_max_batches)

    return eval_fn


def main(argv=None):
    args = parse_args(argv)
    cfg = build_config(args)
    pi, pc, mesh = 0, 1, None
    if args.distributed:
        import os

        import torch

        from step_tpu_torch.parallel import create_mesh, init_distributed

        # refused before the group forms, so that every rank fails alike
        if args.eval_every_epochs:
            # (the JAX package's reason, train.py:204-209)
            raise SystemExit("--eval-every-epochs is not supported with "
                             "--distributed; run cli.test from one process")
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if cfg.batch_size % world:
            raise SystemExit(f"batch_size {cfg.batch_size} not divisible by "
                             f"{world} processes")
        pi, pc = init_distributed()
        mesh = create_mesh(device_type=torch.device(args.device).type)
        print(f"distributed: process {pi}/{pc}", flush=True)
    from step_tpu_torch.data.loader import DataLoader
    from step_tpu_torch.train.fit import fit

    dataset = build_dataset(cfg, args)
    loader = DataLoader(dataset, cfg, batch_size=cfg.batch_size // pc, train=True,
                        seed=args.seed, process_count=pc, process_index=pi)
    eval_fn = build_eval_fn(cfg, args) if args.eval_every_epochs else None
    state = fit(cfg, loader, num_epochs=args.epochs, ckpt_dir=args.ckpt_dir,
                log_dir=args.log_dir, resume=args.resume, seed=args.seed, eval_fn=eval_fn,
                eval_every_epochs=args.eval_every_epochs or 1, device=args.device,
                pretrained_i3d=args.pretrained_i3d, mesh=mesh)
    print(f"trained to step {state.step} on {args.device}"
          + (f"; decoder: {dataset.decoder}" if hasattr(dataset, "decoder") else ""),
          flush=True)
    return state


if __name__ == "__main__":
    main()
