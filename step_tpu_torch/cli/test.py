"""Evaluate a trained detector on the test split of UCF101-24 (or of any
dataset in its layout): frame-mAP@0.5 and video-mAP over linked tubes.

Port of the JAX package's `test.py`, UCF branch. It restores the newest
checkpoint of `--ckpt-dir` (the port's own, `utils/checkpoint.py`), runs
`evaluate.evaluate_ucf` on the card (`--device cpu` for the CPU), and
prints each result, the phase timings and the JPEG decoder that ran:

    python -m step_tpu_torch.cli.test --data-root /data/ucf24 \\
        --ckpt-dir runs/ucf/ckpt --optimized --dump dets.pkl

`--sharded` (ROADMAP M9), `--flow-ckpt-dir` and the AVA preset (M10) are
not ported yet and exit with a message that names their item.
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
                   help="data-parallel evaluation (not ported yet: ROADMAP M9)")
    p.add_argument("--flow-ckpt-dir", default=None,
                   help="late fusion with a flow detector (not ported yet: "
                        "ROADMAP M10)")
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
    if args.sharded:
        raise SystemExit("--sharded: data-parallel evaluation is not ported yet "
                         "(ROADMAP M9)")
    if args.flow_ckpt_dir:
        raise SystemExit("--flow-ckpt-dir: late fusion is not ported yet (ROADMAP M10)")
    import torch

    from step_tpu_torch.config import PRESETS
    from step_tpu_torch.data.ucf import UCFDataset
    from step_tpu_torch.evaluate import evaluate_ucf
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.models.optimize import optimize_for_inference_cli
    from step_tpu_torch.train.trainer import create_train_state
    from step_tpu_torch.utils.checkpoint import restore_checkpoint
    from step_tpu_torch.utils.cli import apply_overrides

    cfg = PRESETS[args.preset]
    if args.tiny:
        cfg = cfg.replace(backbone_depth="tiny", feature_stride=8)
    cfg = apply_overrides(cfg, args.overrides)
    if cfg.dataset == "ava":
        raise SystemExit("AVA evaluation is not ported yet (ROADMAP M10)")
    if cfg.two_stream or cfg.input_stream != "rgb":
        raise SystemExit("flow and two-stream detectors are not ported yet (ROADMAP M10)")
    state = create_train_state(cfg, seed=0, device=args.device)
    state, _ = restore_checkpoint(args.ckpt_dir, state)
    model = state.model
    print(f"restored step {state.step} from {args.ckpt_dir} on {args.device}", flush=True)
    if args.optimized:
        # explicit --set serving flags win over the optimized defaults
        cfg, folded = optimize_for_inference_cli(cfg, args.overrides, model.state_dict())
        model = STEPDetector(cfg).eval()
        model.load_state_dict(folded)
        model = model.to(device=args.device, dtype=getattr(torch, cfg.compute_dtype))
    del state                   # the optimizer's state: evaluation needs none
    dataset = UCFDataset(args.data_root, cfg, split="test",
                         annotation_file=args.annotation_file or "UCF101v2-GT.pkl")
    results = evaluate_ucf(model, dataset, dump_path=args.dump,
                           max_batches=args.max_batches, calibration=args.calibration,
                           fit_calibration_path=args.fit_calibration,
                           device_linking=args.device_linking, max_videos=args.max_videos)
    print(f"decoder: {dataset.decoder}")
    for line in format_results(results):
        print(line)
    return results


if __name__ == "__main__":
    main()
