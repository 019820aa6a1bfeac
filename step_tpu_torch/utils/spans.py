"""Named ranges around the port's stages, live only while a profiler records.

`span(name)` is `torch.profiler.record_function(name)` while a profiler
session is on: any `torch.profiler.profile` (the range is then a
`user_annotation` event of its trace, on the clock of the device's kernels
and copies), or `torch.autograd.profiler.emit_nvtx` (an NVTX range for
Nsight Systems). With no profiler it returns one shared null context and
builds nothing, so the spans cost one check a stage on the served path.
`torch.export` leaves the ranges out of a program it traces, so an
exported program holds no profiler node.

`SPANS` lists every name the port opens, with where each sits:

  model.preprocess  `STEPDetector.stem`: the input's normalization and the
                    cast to the compute dtype
  model.backbone    `STEPDetector.stem`: the backbone's call (`FeatureNet`,
                    `vit.VideoMAEViT`, `mvit.MViTv2` or
                    `swin.SwinTransformer3D`)
  model.stem        inside `model.backbone`, an I3D stem's first unit
                    (`I3DStem.forward`: Conv3d_1a_7x7), one a stem; or
                    MViTv2's patch embedding, or Video Swin's with its
                    norm, one a call
  model.attn_pool   inside `model.backbone`, an MViTv2 block's depthwise
                    pools of q, k and v and their LayerNorms, one a block
  model.window      inside `model.backbone`, a Video Swin block's window
                    moves, twice a block: LN1's output padded, rolled and
                    cut into windows (one gather), and the windows put
                    back, rolled back and cropped (one gather)
  model.attention   inside `model.backbone`, a ViT block's attention call
                    (`F.scaled_dot_product_attention`), an MViTv2
                    block's packing of its relative positions into the
                    query's and keys' channels, its attention call with no
                    mask and residual `+ q`, or a Video Swin block's qkv
                    split into window-major heads, its summed bias and
                    mask, the attention call and the heads' merge; one a
                    block
  model.mlp         inside `model.backbone`, a ViT, MViTv2 or Video Swin
                    block's fc1, GELU and fc2 (`vit.Mlp`), one a block
  model.refine      all of `STEPDetector.refine`, the context included
  model.context     `STEPDetector.refine`: the `ContextNet` call
  model.head        a refinement step's `TwoBranchHead` call (its I3D tail
                    and two-branch head)
  model.boxes       a refinement step's box decoding, clipping and
                    extension in time (`tubes/`)
  detect.nms        the class scores, padding mask and NMS surface of a
                    detection (`inference._detections`)
  train.forward     `train_step`: a micro-batch's forward
  train.loss        `train_step`: a micro-batch's `step_losses`
  train.backward    `train_step`: a micro-batch's backward
  train.reduce      `train_step`: the data-parallel reduction, where given
  train.optimizer   `train_step`: the global norm and the optimizer update
  train.bn_commit   `train_step`: the BatchNorm running statistics written
                    (each micro-batch's update is made after its backward,
                    outside the spans)
  loader.wait       `DataLoader.epoch`: the consumer's wait for a batch

`profile_request.py` prints the device and host ms of each; its
`train_dp` path is the one that opens `train.reduce` and `loader.wait`.
"""

from __future__ import annotations

import contextlib

import torch

SPANS = ("model.preprocess", "model.backbone", "model.stem", "model.attn_pool",
         "model.window", "model.attention", "model.mlp", "model.refine", "model.context",
         "model.head", "model.boxes", "detect.nms",
         "train.forward", "train.loss", "train.backward", "train.reduce",
         "train.optimizer", "train.bn_commit", "loader.wait")

_OFF = contextlib.nullcontext()


def span(name: str):
    """The range `name` while a profiler records, else the shared null
    context."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch.profiler.record_function(name)
