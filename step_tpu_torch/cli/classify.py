"""Classify a video with I3D (the Kinetics head), on the card.

Port of the JAX package's `classify.py`: the centre clip of
`--num-frames` frames (repeating the last frame when the video is
shorter), resized to `--image-size`, normalized on the device, run
through `models/i3d.py::I3DClassifier` in bfloat16, softmax in float32,
the top `--top-k` classes printed as `probability  name`.

    python -m step_tpu_torch.cli.classify --video clip.mp4 --torch-ckpt i3d_kinetics.pth \\
        --labels kinetics_400_labels.txt
    python -m step_tpu_torch.cli.classify --frames-dir frames/ --ckpt-dir runs/i3d

Weights come from a torch I3D checkpoint in any public naming
(`--torch-ckpt`, converted by `models/convert.py`), or from a directory of
checkpoints (`--ckpt-dir`): the port's own `<step>.pt` files, whose newest
"model" entry is the classifier's state_dict, or, where `tensorstore` is
installed, the JAX package's orbax directory of an `I3DClassifier`
(`utils/checkpoint.py::load_model_state`).
`--device cpu` runs on the CPU.
"""

from __future__ import annotations

import argparse
import os


def parse_args(argv=None):
    from step_tpu_torch.utils.cli import add_common_args

    p = argparse.ArgumentParser(description="I3D video classification (PyTorch port)")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--video", help="video file (decoded with cv2)")
    src.add_argument("--frames-dir", help="directory of frame images")
    p.add_argument("--torch-ckpt", default=None,
                   help="torch I3D state_dict (.pt/.pth) to convert on the fly")
    p.add_argument("--ckpt-dir", default=None,
                   help="directory of the port's checkpoints (or the JAX package's "
                        "orbax checkpoints, with tensorstore) holding the classifier")
    p.add_argument("--labels", default=None, help="text file, one class name per line")
    p.add_argument("--num-classes", type=int, default=400)
    p.add_argument("--num-frames", type=int, default=64,
                   help="centre-clip length (the Quo Vadis evaluation uses 64+)")
    p.add_argument("--image-size", type=int, default=224)
    p.add_argument("--top-k", type=int, default=5)
    add_common_args(p)
    return p.parse_args(argv)


def load_frames(args):
    """The centre clip `[1, T, S, S, 3]` uint8 RGB of `--video` or
    `--frames-dir` (its .jpg/.jpeg/.png files in name order), each frame
    resized to S = `--image-size`; a video shorter than T repeats its last
    frame."""
    import cv2
    import numpy as np

    if args.frames_dir:
        names = sorted(os.listdir(args.frames_dir))
        frames = [cv2.cvtColor(cv2.imread(os.path.join(args.frames_dir, n)),
                               cv2.COLOR_BGR2RGB)
                  for n in names if n.lower().endswith((".jpg", ".jpeg", ".png"))]
    else:
        cap = cv2.VideoCapture(args.video)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        cap.release()
    if not frames:
        raise SystemExit("no frames decoded")
    clip = np.stack([cv2.resize(f, (args.image_size, args.image_size)) for f in frames])
    T = args.num_frames
    if len(clip) >= T:
        s = (len(clip) - T) // 2
        clip = clip[s:s + T]
    else:
        clip = np.concatenate([clip, np.repeat(clip[-1:], T - len(clip), 0)])
    return clip[None]


def load_classifier(args):
    """`I3DClassifier` with the weights of `--torch-ckpt` or `--ckpt-dir`, in
    eval mode on the CPU."""
    from step_tpu_torch.models.i3d import I3DClassifier

    model = I3DClassifier(num_classes=args.num_classes).eval()
    if args.torch_ckpt:
        from step_tpu_torch.models.convert import convert_torch_i3d, load_torch_checkpoint

        sd = convert_torch_i3d(load_torch_checkpoint(args.torch_ckpt), include_logits=True)
    elif args.ckpt_dir:
        from step_tpu_torch.utils.checkpoint import load_model_state

        sd = load_model_state(args.ckpt_dir)
    else:
        raise SystemExit("need --torch-ckpt or --ckpt-dir")
    model.load_state_dict(sd)
    return model


def main(argv=None):
    args = parse_args(argv)
    import numpy as np
    import torch

    from step_tpu_torch.preprocess import device_preprocess

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("classification runs on a CUDA card and none is available; "
                           "pass --device cpu to run on the CPU")
    model = load_classifier(args).to(device)
    clip = torch.from_numpy(load_frames(args)).to(device)
    with torch.no_grad():
        logits = model(device_preprocess(clip).to(torch.bfloat16))
        probs = torch.softmax(logits.to(torch.float32), dim=-1)[0].cpu().numpy()
    labels = None
    if args.labels:
        with open(args.labels) as f:
            labels = [line.strip() for line in f]
    for i in np.argsort(-probs)[:args.top_k]:
        name = labels[i] if labels and i < len(labels) else f"class_{i}"
        print(f"{probs[i]:.4f}  {name}")
    return probs


if __name__ == "__main__":
    main()
