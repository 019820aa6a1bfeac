"""step_tpu_torch — the STEP action detector in PyTorch, with CUDA kernels
for NVIDIA Hopper (sm_90a).

A port of the JAX package `step_tpu`, which stays the reference: module
names mirror it (`step_tpu/ops/nms.py` ↔ `step_tpu_torch/ops/nms.py`), and
the public functions keep its channels-last layout (`[B, T, H, W, C]` clips,
`[B, T', H, W, C]` features). The package imports nothing of `step_tpu`
and nothing of JAX: it carries its own copy of the configuration,
`StepConfig` and `PRESETS` (`config.py`), with the JAX package's fields and
defaults.

Layers, entry point first:

  config.py        StepConfig and the five presets
  inference.py     detect_clip → class scores → nms_surface; late fusion,
                   the video and streaming forms
  models/          STEPDetector, FeatureNet / ContextNet / TwoBranchHead,
                   I3D, the VideoMAE ViT-B/16 backbone (vit.py), the
                   MViTv2-B backbone (mvit.py), the Video Swin-B backbone
                   (swin.py), BN folding (optimize.py)
  ops/             tube ROI-align, batched NMS and the backbone kernels:
                   each a plain PyTorch version plus a CUDA kernel
                   (kernels.py, csrc/); the pool backward (pool_grad.py)
  train/           the progressive losses, train_step, fit()
  parallel/        data parallelism: one card a rank in a process group,
                   its "data" mesh, the per-process batch slices
  evaluate.py      detections over a dataset, dedupe, tube linking, the
                   UCF101-24 frame- and video-mAP (evaluate_ucf), AVA's
                   keyframe frame-mAP (evaluate_ava)
  cli/             python -m step_tpu_torch.cli.train / cli.test
  data/            batch assembly, the threaded loader, synthetic clips,
                   the UCF101-24 and AVA readers and their augmentations
  eval/            frame- and video-mAP, the AVA evaluator, calibration
  tubes/           box and tube math, the initial cuboids
  convert.py       JAX variable tree → this package's state_dict
  utils/           seeded initializers (serving, training), checkpoints,
                   the command lines' --set overlay
"""

import torch

from step_tpu_torch.config import PRESETS, StepConfig  # noqa: F401

# float32 means float32. The serving path computes in bfloat16, where these
# flags change nothing; float32 is the parity mode, held against the JAX
# reference at 1e-4, and cuDNN's default TF32 convolutions keep ~10
# mantissa bits — far outside that tolerance.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
