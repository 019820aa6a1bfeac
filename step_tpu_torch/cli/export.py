"""Export the detect program of a preset as a serving artifact.

Port of the JAX package's `export.py`: traces `detect_clip` for the
preset at `--batch-size` with `torch.export`
(`utils/export.py::export_detect_fn`) and writes the program
(`torch.export.save`), which `cli/serve.py` loads. The weights are not in
it: `cli/serve.py` passes a checkpoint's at call time.

    python -m step_tpu_torch.cli.export --preset ucf_3step --batch-size 8 \\
        --optimized --out detect.pt2

Every program holds its max pools as the pool kernels' nodes (K5
`step::max_pool3x3_same`, the strided `step::max_pool3d_same`). The
kernel configuration (K3 and K4 as nodes of the program as well) is the
unfolded tree with the JAX CLI's own switch, read at trace time and kept
by the program:

    python -m step_tpu_torch.cli.export \\
        --preset ucf_3step --batch-size 8 --set fused_bn_relu=True --out kernels.pt2

(not `--optimized`: BN folding wins over `fused_bn_relu`).
`cli/serve.py` serves it with the same preset and `--set` flags.

The program runs on the device it was traced on (`--device`, the card by
default), in the installation that wrote it. `--platforms` (the JAX
package's lowering targets) has no meaning for a traced PyTorch program
and is refused.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    from step_tpu_torch.utils.cli import add_common_args

    p = argparse.ArgumentParser(description="Export a detect program (PyTorch port)")
    p.add_argument("--preset", default="ucf_3step")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--out", required=True, help="output path of the program")
    p.add_argument("--platforms", default=None,
                   help="the JAX package's lowering targets: refused here")
    p.add_argument("--optimized", action="store_true",
                   help="export the inference-optimized program (BN folded + fused "
                        "Inception 1x1, models/optimize.py); cli.serve --optimized "
                        "folds the checkpoint to match")
    p.add_argument("--tiny", action="store_true")
    add_common_args(p)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.platforms:
        raise SystemExit("--platforms: a torch.export program runs on the device it "
                         "was traced on; pass --device cuda|cpu instead")
    from step_tpu_torch.config import PRESETS
    from step_tpu_torch.models.optimize import optimize_for_inference_cli
    from step_tpu_torch.utils.cli import apply_overrides
    from step_tpu_torch.utils.export import export_detect_fn

    cfg = PRESETS[args.preset]
    if args.tiny:
        cfg = cfg.replace(backbone_depth="tiny", feature_stride=8)
    cfg = apply_overrides(cfg, args.overrides)
    if args.optimized:
        # the program's config only: cli.serve folds the checkpoint with the
        # same flags, so the weights it passes match the program's inputs
        cfg, _ = optimize_for_inference_cli(cfg, args.overrides)
    blob = export_detect_fn(cfg, batch_size=args.batch_size, device=args.device)
    with open(args.out, "wb") as f:
        f.write(blob)
    print(f"exported {len(blob)} bytes -> {args.out} "
          f"(preset={args.preset}, batch={args.batch_size}, device={args.device})")
    return len(blob)


if __name__ == "__main__":
    main()
