"""Evaluate a trained detector on the test split of UCF101-24 (or of any
dataset in its layout): frame-mAP@0.5 and video-mAP over linked tubes; or
on AVA: keyframe frame-mAP@0.5.

Port of the JAX package's `test.py`. It restores the newest checkpoint of
`--ckpt-dir` (the port's own, or the JAX package's orbax directories where
`tensorstore` is installed: `utils/checkpoint.py`), runs
`evaluate.evaluate_ucf` or, for an AVA preset, `evaluate.evaluate_ava` on
the card (`--device cpu` for the CPU), and prints each result, and for
UCF the phase timings and the JPEG decoder that ran:

    python -m step_tpu_torch.cli.test --data-root /data/ucf24 \\
        --ckpt-dir runs/ucf/ckpt --optimized --dump dets.pkl
    python -m step_tpu_torch.cli.test --data-root /data/ucf24 \\
        --ckpt-dir runs/rgb/ckpt --flow-ckpt-dir runs/flow/ckpt
    python -m step_tpu_torch.cli.test --preset ava_3step --data-root /data/ava \\
        --ckpt-dir runs/ava/ckpt --label-map ava_action_list_v2.1.pbtxt \\
        --exclusions ava_val_excluded_timestamps_v2.1.csv

`--flow-ckpt-dir` runs the late-fusion protocol: `--ckpt-dir` holds the
RGB detector and `--flow-ckpt-dir` a flow-stream one (trained with `--set
input_stream=flow`); UCF only, and not with `--optimized`, as in the JAX
package. A two-stream or flow-stream checkpoint is evaluated with its
preset or `--set`. `--sharded` splits each detection batch over the
ranks of the process group (`parallel.create_mesh`, one card a process):
under plain `python -m` that is one rank; under `torchrun --nproc-per-node
N` N ranks, each with its card, all printing the same results. (The JAX
package's `--sharded` spreads a batch over every local chip of one
process.)
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    from step_tpu_torch.utils.cli import add_common_args

    p = argparse.ArgumentParser(description="Evaluate the STEP detector (PyTorch port)")
    p.add_argument("--preset", default="ucf_3step")
    p.add_argument("--data-root", required=True)
    p.add_argument("--annotation-file", default=None)
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--dump", default=None, help="detections pickle output path")
    p.add_argument("--calibration", default=None,
                   help="per-class Platt .npz to apply to the scores")
    p.add_argument("--fit-calibration", default=None,
                   help="fit per-class Platt scaling on this run and save it (.npz)")
    p.add_argument("--max-batches", type=int, default=None)
    p.add_argument("--max-videos", type=int, default=None,
                   help="bound the --device-linking pass to N whole videos "
                        "(defaults to --max-batches when only that is set)")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--optimized", action="store_true",
                   help="evaluate the serving form: BN folded, Inception 1x1x1 "
                        "convs fused (models/optimize.py)")
    p.add_argument("--device-linking", action="store_true",
                   help="link video tubes on the device (K-tube Viterbi) instead "
                        "of the host's greedy linker")
    p.add_argument("--sharded", action="store_true",
                   help="split each detection batch over the process group's ranks "
                        "(one card a process; torchrun for more than one)")
    p.add_argument("--flow-ckpt-dir", default=None,
                   help="second (flow-stream) checkpoint: the late-fusion protocol "
                        "(UCF only)")
    p.add_argument("--label-map", default=None,
                   help="AVA label-map pbtxt (the evaluated-class whitelist)")
    p.add_argument("--exclusions", default=None,
                   help="AVA excluded-timestamps CSV (relative to the data root)")
    p.add_argument("--fps", type=int, default=30,
                   help="AVA frame-extraction rate (frames per second)")
    add_common_args(p)
    return p.parse_args(argv)


def format_results(results: dict) -> list[str]:
    """One line a result: floats to 4 places, strings as they are, the
    timings dict as `key=value` pairs."""
    lines = []
    for k, v in results.items():
        if isinstance(v, float):
            lines.append(f"{k}: {v:.4f}")
        elif isinstance(v, dict):
            lines.append(k + ": " + ", ".join(
                f"{a}={b:.2f}" if isinstance(b, float) else f"{a}={b}"
                for a, b in v.items()))
        else:
            lines.append(f"{k}: {v}")
    return lines


def main(argv=None) -> dict:
    args = parse_args(argv)
    import torch

    from step_tpu_torch.cli.train import ava_dataset
    from step_tpu_torch.config import PRESETS
    from step_tpu_torch.data.ucf import UCFDataset
    from step_tpu_torch.evaluate import evaluate_ava, evaluate_ucf
    from step_tpu_torch.inference import eval_needs_flow
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.models.optimize import optimize_for_inference_cli
    from step_tpu_torch.train.trainer import create_train_state
    from step_tpu_torch.utils.checkpoint import restore_checkpoint
    from step_tpu_torch.utils.cli import apply_overrides

    cfg = PRESETS[args.preset]
    if args.tiny:
        cfg = cfg.replace(backbone_depth="tiny", feature_stride=8)
    cfg = apply_overrides(cfg, args.overrides)
    if args.flow_ckpt_dir:
        if args.optimized:
            raise SystemExit("--optimized does not combine with --flow-ckpt-dir "
                             "(transform each stream explicitly via models/optimize.py)")
        if cfg.dataset == "ava":
            raise SystemExit("--flow-ckpt-dir is UCF-only: AVA has no flow stream, "
                             "the late-fusion protocol does not apply")
        # late fusion: the primary checkpoint is the single-stream RGB
        # detector whatever the preset's two_stream flag
        cfg = cfg.replace(two_stream=False, input_stream="rgb")
    mesh = None
    if args.sharded:
        from step_tpu_torch.parallel import create_mesh, init_distributed

        init_distributed()
        mesh = create_mesh(device_type=torch.device(args.device).type)
        print(f"sharded eval over {mesh.size()} devices", flush=True)
    state = create_train_state(cfg, seed=0, device=args.device)
    state, _ = restore_checkpoint(args.ckpt_dir, state)
    model = state.model
    print(f"restored step {state.step} from {args.ckpt_dir} on {args.device}", flush=True)
    model_flow = None
    if args.flow_ckpt_dir:
        cfg_flow = cfg.replace(input_stream="flow")
        state_flow = create_train_state(cfg_flow, seed=0, device=args.device)
        state_flow, _ = restore_checkpoint(args.flow_ckpt_dir, state_flow)
        model_flow = state_flow.model
        print(f"restored the flow stream's step {state_flow.step} from "
              f"{args.flow_ckpt_dir}", flush=True)
        del state_flow
    if args.optimized:
        # explicit --set serving flags win over the optimized defaults
        cfg, folded = optimize_for_inference_cli(cfg, args.overrides, model.state_dict())
        model = STEPDetector(cfg).eval()
        model.load_state_dict(folded)
        model = model.to(device=args.device, dtype=getattr(torch, cfg.compute_dtype))
    del state                   # the optimizer's state: evaluation needs none
    if cfg.dataset == "ava":
        dataset = ava_dataset(cfg, args, args.annotation_file or "ava_val_v2.1.csv")
        results = evaluate_ava(model, dataset, dump_path=args.dump,
                               max_batches=args.max_batches, mesh=mesh)
    else:
        dataset = UCFDataset(args.data_root, cfg, split="test",
                             annotation_file=args.annotation_file or "UCF101v2-GT.pkl",
                             with_flow=eval_needs_flow(cfg, model_flow))
        results = evaluate_ucf(model, dataset, dump_path=args.dump,
                               max_batches=args.max_batches, calibration=args.calibration,
                               fit_calibration_path=args.fit_calibration,
                               model_flow=model_flow, device_linking=args.device_linking,
                               max_videos=args.max_videos, mesh=mesh)
        print(f"decoder: {dataset.decoder}")
    for line in format_results(results):
        print(line)
    return results


if __name__ == "__main__":
    main()
