"""Smoke test of the PyTorch port (`step_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):
  1. the device, and its name and power limit from nvidia-smi;
  2. build the CUDA kernels from step_tpu_torch/csrc with nvcc (sm_90a),
     and count the HGMMA (tensor-core) instructions in K3's SASS;
  3. K1, batched NMS: kernel against its plain PyTorch version, required
     exactly equal, with exact ties, zero-area boxes, duplicates, boxes
     with NaN and infinite coordinates, all-invalid problems and problems
     that run out before K: through `nms_many` at the serving shape (B=8 →
     8*18*24 problems, P=16, K=16), at B=64, on one problem (the latency
     floor), at P=64 and P=1024, and with K > P; and `nms_surface` (boxes
     shared by a frame's 24 classes, one launch) at B=8 and B=64 with
     float32 and bfloat16 scores, by raw bits. It prints the kernel's
     device times, the surface's wrapper and plain times, the bound of the
     compact surface and of the expanded interface, and the kernels one
     `nms_surface` call launches, counted by torch.profiler (fatal above 2);
  4. K2, tube ROI-align: kernel against its plain version on features
     [8, 5, 14, 14, 832] with boxes partly and wholly outside the map, in
     float32 (tolerance 1e-4) and bfloat16 (one bf16 rounding step), at
     sampling_ratio 2 and at 0 (adaptive, with boxes larger than the map so
     that the sample cap bites);
  5. a tiny float32 detector on the card against the same detector on the
     CPU (plain versions of both kernels);
  6. the main path: `ucf_3step` at full width and depth, seeded weights,
     made ready for serving by `optimize_for_inference` (BN folded, the
     Inception 1x1x1 convs fused, as the JAX package serves it), bfloat16,
     serving uint8 clips through `detect_clip` at B=1 and B=8 — output
     shapes, finite values, K1's and K2's launch counters above zero (K1's
     counts `nms_many` and `nms_surface` launches), no K3 or K4, and the
     pools measured: K5 13 and the strided pool kernel 3 launches a
     request, as `backbone_launches` and `strided_launches` list them;
  7. K5, 3x3x3 max pool: kernel against its plain version at each of the
     six shapes a B=8 request of the kernel configuration pools
     (`backbone_launches`), float32 and bfloat16, with signed zeros, +-inf
     and NaN payloads mixed in — the same bits, NaNs included;
  8. K4, BN + ReLU: at each of the 25 shapes of a B=8 request — float32
     within 1e-6, bfloat16 within one rounding step;
  9. K3, 3x3x3 conv + BN + ReLU: at Conv3d_2c_3x3, the tail's Mixed_5b
     b1b, Mixed_4c b2b (C = 24) and Mixed_4b b1b (K = 208) — float32 within
     1e-4, bfloat16 (the tensor-core kernel, which must hold HGMMA
     instructions) within one rounding step and 2^-15 (K3_BF16_ATOL); times
     against cuDNN in bf16 and the bound, and the per-call weight
     re-layout;
 10. the kernel path: the same `ucf_3step` at full width and depth, seeded
     weights left unfolded, `fused_bn_relu=True`, bfloat16, serving B=1 and
     B=8 — the checks of
     phase 6, and all six launch counters above zero;
 11. the same weights in float32 at B=1: the kernel path against the main
     path (folded, cuDNN) — tube scores within 1e-3, tubes
     within 1e-2 px;
 12. the video path: the `streaming` preset at full width on the main
     path's tree (bf16, the same seeded weights), a 288-frame uint8 video
     (48 chunks of 6 frames) tiled into 48 windows one chunk apart, through
     `detect_video` with tiling_stride 6 and None — link outputs [24, 4, 48]
     finite and node-disjoint per clip, K1 and K2 launched, linking on the
     card equal to linking on the CPU on the same tubes and scores; every
     K1 and K2 call of each run recorded (`recorded`) and held against its
     plain version on that call's own inputs (K1 by raw bits); per-video
     wall ms (median of 3) of `detect_video` and of its linking alone, with
     the linking's kernel launches (profiler);
 13. the chunk-stem cache on the same video: `detect_video_stream_batched`
     (clip_batch 16, three batches) and `detect_video_stream` over 4
     chunks, each K1 and K2 call of both held against its plain version as
     in phase 12, and the batched form's per-video wall ms; in float32
     (TF32 off) both forms against `detect_clip` on the assembled window at
     an interior window and both clamped edges (scores within 1e-4, tubes
     within 1e-3 px); K2 at [16, 6, 14, 14, 832] with boxes outside the
     map; and the kernel configuration with chunk stems at B=2, whose K3,
     K4 and K5 launches, recorded by shape, must equal what
     `backbone_launches` lists (T = 3 and 2 in the stem, T' = 6 in the
     tail), each of those shapes then held against its plain version as in
     phases 7-9; and in float32 that configuration against the main path's
     chunk-stem tree on the same clips, as in phase 11.

 14. the training path at full width (`training_phases`): `ucf_3step`,
     bf16 compute on float32 weights, B=8, remat "dots", AdamW (warmup 2,
     lr 1e-3), the training init; synthetic 224 px clips through the
     port's `DataLoader` and `fit()` for 12 steps with a checkpoint at
     step 6 (restored into a fresh state); every loss and `grad_norm`
     finite; every backbone parameter's gradient at step 1 nonzero (so
     K2's backward reaches the backbone); K2 and K5 launched in every
     step (launches counted a step); 8 more steps on one fixed batch
     lower the loss; the median step ms of the last 8, the peak memory,
     and the plain backwards alone (`device_ms`): the stride-1 pool's at
     the tail's [128, 832, 5, 7, 7] and ROI-align's at [8, 5, 14, 14, 832];
 15. kernels under autograd against plain on the card: K2's Function
     against `tube_roi_align_plain` under autograd (forward and
     dfeatures, float32 within 1e-4, bf16 within one rounding step); the
     stride-1 and strided pools' forward and backward on the card against
     the CPU on integer-valued inputs (ties), bit for bit; a tiny float32
     AdamW `train_step` (2 steps, dropout 0) on the card against the CPU:
     losses within 1e-5 relative, BatchNorm statistics within 1e-4, every
     weight within 2 lr and at most 0.1% of them beyond 1e-5 (Adam turns
     a gradient at the level of float noise into a step of either sign).

 16. the UCF101-24 evaluation path (`eval_phases`): `evaluate_ucf` on
     `ucf_3step` at full width on the main path's tree (BN folded, bf16,
     the seeded weights, score threshold 0), on `MemoryUCF`: 4 synthetic
     oracle videos of 60 frames held in memory with the UCF reader's
     protocol and a native resolution of 240x320, so boxes scale back; with
     host linking, then `device_linking=True`. Each result holds every key,
     each mAP in [0, 1] or NaN, and detections; K1 and K2 launched, every
     K1 and K2 call recorded and held against its plain version on its own
     inputs (K1 by raw bits), and, against the `detect_clip` calls counted
     in the run, K1 launched once and K2 `num_steps` times a detection
     batch; the phase timings printed with the card's name and power limit.
     Then a tiny float32 detector on the card against the same on the CPU:
     each linker's tubes (`link_frame_detections` after
     `collect_detections`, and `collect_video_tubes`) matched one to one,
     same frames, boxes within 5e-3 px of 240x320, scores within 1e-4; and
     its `evaluate_ucf`, both linkers: equal detection counts, mAPs within
     1e-3;
 17. the command lines on the card: a 4-video UCF101-24 layout on disk
     (`write_ucf_layout`, 36 frames at 224 px), `cli.train` for 4 steps at
     full width, B=2, with its in-training evaluation, then `cli.test` on
     that checkpoint with `--optimized` and with `--device-linking`
     (score threshold 0): the printed keys, the decoder, the dump, and K1
     and K2 launched in each (K5 too in training).
 18. the two-stream detector (`two_stream_phases`): `two_stream_train` at
     full width on `optimize_for_inference`'s tree (BN folded in both stems
     and the fusion unit), bf16, serving uint8 RGB and int8 flow through
     `detect_clip` at B=1 and B=8, every K1 and K2 call held against its
     plain version (`held_run`: K1 by raw bits, K2 within one bf16 step), K1
     1 and K2 3 a request, the request medians; the kernel configuration at
     B=2, whose K3, K4 and K5 launches by shape must equal
     `backbone_launches` with both stems and the fusion unit's K4, that
     shape held against plain (`bn_case`); the same weights in float32 at
     B=1, the kernel configuration against the main path's tree on the same
     RGB and flow (tube scores within 1e-3, tubes within 1e-2 px, as phase
     11); a tiny float32 two-stream detector on the card against the CPU;
     12 `fit()` steps at full width, B=8 (remat "dots", AdamW, synthetic
     clips with their flow): finite losses, a nonzero step-1 gradient on
     every parameter of both stems and the fusion unit, K2 and K5 in every
     step, the step times, their median over the last 8 (CUDA events, as
     phase 14) and the peak memory; then 8 steps on one batch already on
     the card, no loader running, timed the same way (so is phase 14's
     fixed batch);
 19. late fusion and the flow stream (`late_fusion_phases`): an RGB and a
     flow-stream `ucf_3step` detector on the main path's tree,
     `detect_clip_late_fusion` at B=8 (K1 1 and K2 6 a request, every call
     held), `evaluate_ucf` with `model_flow` on `MemoryUCF` videos that
     carry their flow (host-linked; K1 1 and K2 6 a fused batch, counted),
     `collect_video_tubes` with the flow stream; then each of the three as
     a tiny float32 run, card against CPU (tubes 1e-3 px, scores 1e-4, the
     surface equal; detections equal and mAPs within 1e-3; tubes matched
     one to one);
 20. AVA (`ava_phases`): `ava_3step` at full width on the main path's tree
     serving B=1 and B=8 (every K1 and K2 call held), the C = 60 surface of
     a B=8 request's own tubes and scores held against plain by raw bits
     with float32 and bfloat16 scores; `evaluate_ava` on an AVA layout the
     script writes (`write_ava_layout`: 3 videos, a label map of 60 sparse
     ids, rows the map does not evaluate, an excluded keyframe), its
     frame-mAP in [0, 1], its dump normalized, K1 1 and K2 3 a batch of 4;
     then `cli.train --dataset ava` (4 steps, B=2; K2 launched) and
     `cli.test --preset ava_3step` on that checkpoint (K1 once and K2 3
     times a `detect_clip` batch, counted).
 21. the pretrained start (`pretrained_phases`): a seeded full-width I3D
     written with `torch.save` in the piergiaj naming with a `module.`
     prefix (`i3d_checkpoint`); `fit(pretrained_i3d=...)` on `ucf_3step`,
     B=8, 12 steps timed as phase 14 (`timed_fit`): the normalizer's report
     printed, every stem and tail tensor the checkpoint's bit for bit
     before the first step and the moments fresh, K2 and K5 in every step;
     `two_stream_train` at B=2 for 2 steps, its flow stem the inflated RGB
     stem; `cli.train --pretrained-i3d` on phase 17's on-disk layout;
 22. int8 moments (`int8_phases`): `fit()` with `adam_moments="int8"`, B=8,
     12 steps: the median of the last 8, peak memory, the state's bytes a
     parameter (2.03 to 2.04; float32 moments take 8), the kernels of one
     step and of the optimizer's update alone beside float32 moments'
     (profiler), the update's device time (profiler) and its time between
     CUDA events; a tiny float32 int8 step on the card
     against the CPU (weights within 2 lr, at most 0.1% beyond 1e-5, each
     stored moment within one code level, 8%, or 1% of its block's largest
     value, where a gradient at float-noise level differs);
 23. the "frame_fc" head (`frame_fc_phases`): `ucf_3step` with
     `reg_head="frame_fc"` on `optimize_for_inference`'s tree serving B=1
     and B=8 (every K1 and K2 call held, K1 1 and K2 3 a request), its
     kernel configuration against the main path in float32 at phase 11's
     tolerances, 4 `fit()` steps at B=8;
 24. `I3DClassifier` (`classifier_phases`): 64-frame clips at 224 px from a
     written checkpoint, bf16, B=1 and B=8 request medians on the main
     configuration (cuDNN convs; the pool kernels its only kernels) and the
     kernel configuration; one more request at each batch whose every K3,
     K4 and K5 call is held against its plain version on its own inputs
     (`held_backbone`) and counted by shape against `classifier_launches`;
     every B=1 shape held and timed by `pool_case`/`bn_case`/`conv_case`;
     float32 logits of the kernel configuration against the main one
     (within 1e-3 of their scale, probabilities within 1e-3); then
     `cli.classify` on a written frame directory and the checkpoint, its
     probabilities within 1e-3 of the classifier's on the same clip.
 25. the exported program (`serving_phases`): `ucf_3step` on
     `optimize_for_inference`'s tree, bf16, exported with `torch.export` at
     B=8 and B=1 on the card (`utils/export.py`): its bytes under 10% of the
     state dict's (the weights are an input), 1 `step::nms_surface`, 3
     `step::tube_roi_align`, 7 `step::max_pool3x3_same` (the heads' six
     pools run inside their blocks), 3 `step::max_pool3d_same`, 6
     `step::inception_block` and 3 `step::conv1x1x1_bias_relu` nodes (a
     program traced on the card holds its pools as the kernels' nodes); loaded and run on uint8 clips, K1 1 and
     K2 3 launches a request, every K1 and K2 call of a B=8 request held
     against its plain version on its own inputs and timed on them; the
     served request's median at B=8 and B=1 beside eager `detect_clip`'s;
     the float32 program against eager `detect_clip` (tube scores 1e-4,
     tubes 1e-3 px, frame_mask equal);
 26. `cli.export --optimized` then `cli.serve` on phase 17's on-disk
     layout and a checkpoint `cli.train` writes there, in float32 with the
     cv2 decoder: each video's detections equal `cli.test --optimized
     --dump`'s (frames and classes equal, scores within rtol 1e-5 / atol
     1e-6, boxes within rtol 1e-4 / atol 1e-3 px), and a directory of the
     videos served at once equals each video served alone; its wall time
     and clips/s;
 27. `cli.demo` at the `streaming` preset on a 60-frame synthetic mp4: as
     many frames written as read, K1 and K2 launched.
 28. data parallelism on one rank (`parallel_phases`): `fit` on a one-rank
     NCCL mesh against plain `fit`, `evaluate_ucf(mesh)`, `cli.train
     --distributed` and `cli.test --sharded`;
 29. two gloo ranks on the one card against one process on the same global
     batches;
 30. the kernel configuration as a served program (`kernel_program_phases`):
     `ucf_3step` unfolded with `fused_bn_relu`, exported on the card at B=8
     and B=1 in bf16 and served: its bytes under 10% of the state dict's;
     K3 `step::conv3x3x3_bn_relu`, K4 `step::scale_bias_relu` and K5
     `step::max_pool3x3_same` nodes as `backbone_launches` counts them (27,
     54, 13) beside K1 1, K2 3 and the strided `step::max_pool3d_same` 3;
     one launch a node in a served request;
     every K3, K4 and K5 launch of the program held against its plain
     version on its own inputs (`held_backbone_launches`: K5 by raw bits,
     K4 within one bf16 step, K3 by `k3_close`); their device ms inside
     the B=8 program (profiler), their summed bounds, the device ms of K3's
     weight layouts the program makes; request medians against the eager
     kernel configuration; the float32 program against eager (tube scores
     1e-4, tubes 1e-3 px, frame_mask equal);
 31. the variables and checkpoint bridge (`bridge_phases`), tiny depth at
     64 px: `train_eval_synth --save-variables`, then `--load-variables` in
     a second call (the same frame-mAPs); `fit` then `--load-ckpt-dir` on
     its checkpoint (the mAPs of the `fit` model) with `--save-variables`,
     whose file re-read by the port's decoder equals the weights bit for
     bit and detects the same. The orbax reader needs `tensorstore`, which
     the card's machine lacks: the phase says it was not run.
 32. the benches (`bench_phases`), each `main(argv)` in-process at a
     reduced size: `step_tpu_torch.bench` with `--config main` and
     `--config kernel` at B=8 (5 chained requests), `bench_train` at B=8
     (4 steps, `--skip-fit`), `bench_stream` over 8 chunks with
     `--decompose`, `bench_linking_stream` over 8 clips: every field of
     each JSON line, `mfu` in (0, 1.05], the card's name in `device`; K1
     and K2 launched in each serving run, K3, K4 and K5 too under `--config
     kernel`, K2 and K5 in training; both configurations count the same
     FLOPs, and the tiny float32 detector's request and train-step FLOPs
     on the card equal the CPU's.
 33. the pools of a main-path request (`pool_b32_phase`) at B=32, at B=1
     and on a B=1 request's chunk stems: K5 at its 13 launches and the
     strided kernel (`ops/pool.py::max_pool3d_same`, `csrc/pool3d_same.cu`)
     at the stem's MaxPool_2a, 3a and 4a, each against its plain version
     by raw bits in f32 and bf16 with `with_specials`, and its bf16 device
     time beside its bytes bound, its plain version's and the library's
     (`F.max_pool3d`; for a strided pool on the input padded beforehand);
     the launches a request the shape tables list, at B=32 and B=1, must
     equal those phase 6 measured.
 34. the ViT-B/16 detector (`vit_phase`): the benchmark's `ava_videomae_b16`
     built as `benchmark/program.py::Server` builds it, one B=32 request
     through `detect_clip` with the launch counts set to 0 just before:
     K1 1, K2 3, K5 6 (the heads' tails at [512, 768|832, 9, 7, 7]), the
     strided pool, K3 and K4 0; each K1 and K2 call of the request held
     against its plain version, each K5 launch by raw bits at its
     launcher; K2 at [32, 9, 14, 14, 768] on phase 4's boxes (f32 within
     1e-4, bf16 within one step) and K5 at the two tail shapes as phase 33
     holds its pools.
 35. the stem conv kernel (`stem_phase`, `ops/stem_conv.py`,
     `csrc/stem_conv.cu`; it replaces no TPU kernel): its HGMMA
     instructions counted; at the served stem [32, 18, 224, 224, 3] (bias
     and ReLU), B=1, a B=1 request's chunk stems [3, 6, 224, 224, 3] and
     the flow stem [32, 18, 224, 224, 2], each held against its plain
     version (`stem_close`) and timed beside its operations bound, its
     plain version and two library yardsticks the port never calls:
     today's path before it (`F.pad`, cuDNN's bf16 conv with the bias, a
     ReLU) and cuDNN on the input and weight zero-padded to 8 channels;
     then one B=32 request of the benchmark's `ucf_3step` and of its
     `ava_videomae_b16` detector (built as `benchmark/program.py::Server`
     builds them), every stem launch held against plain at its launcher:
     1 and 0 launches (`STEM_LAUNCHES`).
 36. the heads' served Inception block (`inception_phase`,
     `ops/inception.py::inception_block`; the 1x1x1 GEMM `csrc/gemm.cu` and
     the tube conv `csrc/conv3d.cu::tube_conv_kernel` replace no TPU
     kernel beyond K3's): the tube conv's HGMMA instructions counted; at
     each served block shape of the three cells (Mixed_5b and 5c at
     [512, 832, 5, 7, 7]; the ViT cell's at [512, 768|832, 9, 7, 7]) and
     of a B=1 request ([16, 832, 5, 7, 7]), the operator held against a
     float32 model of its arithmetic (`block_close`) and timed, whole and
     kernel by kernel, beside its bound, the plain version and today's path
     (cuDNN conv, bias add, ReLU, slice copies, cat: the library yardstick,
     which the port no longer calls) and, for each conv, cuDNN's conv alone;
     then one B=32 request of `ucf_3step`, `ava_3step` and
     `ava_videomae_b16` and one B=1 request of `ucf_3step`, built as
     `benchmark/program.py::Server` builds them, every block held against
     the model at its call: 6 blocks and 3 head reductions a request
     (`INCEPTION_LAUNCHES`).
 37. MViTv2's attention pools (`attn_pool_phase`, `ops/attn_pool.py::
     attn_pool`, `csrc/attn_pool.cu`; it replaces no TPU kernel): at each
     block shape of a full-depth request at B=32 (and the first at B=2),
     the three pools of a block held against the plain version and timed
     beside the bound by the benchmark's bytes and by the bytes the taps
     touch, the plain version and today's path before the kernel (the
     depthwise conv on channel-major parts and the LayerNorm on the
     transposed view), and the sums over a request's 21 blocks; then one
     B=32 request of the benchmark's `ava_mvitv2_b` detector, every pool
     held against the plain version at its call: 63 launches
     (`ATTN_POOL_LAUNCHES`).

At the end it checks that nothing of JAX or of the JAX package was
imported. Each kernel's time `ms` is its own device time: 20 launches of
its launcher on preallocated outputs captured in a CUDA graph and replayed
between CUDA events (`device_ms`), so the host's cost per call is left
out; `wrapper_ms` is the Python wrapper's time, back to back. Phases 7 and
8 also sum launches x device time over a request. The second-to-last line
is a JSON object describing each kernel: launches counted on the path that
runs it (K1, K2, K5 and the strided pool on the main path, phase 6; K3 and
K4 on the kernel path, phase 10, which must equal the launches phases 7
and 8 list), max
error, kernel, wrapper and plain times, the bound (the larger of the bytes
it must move over 3.35 TB/s and its operations over the peak rate for
their type) and the time of one PyTorch call for the same function where
there is one; K1's entry also holds its one-problem floor (`floor_ms`) and
the launches of one `nms_surface` call (`surface_launches`). Each entry
also holds `video_launches`, its launches on each video path of phases 12
and 13 (counts set to 0 just before each path and read just after),
`video_shapes`: for each path and each shape that path gave the kernel, the
launches recorded there, the max error against the plain version, and the
device, plain and bound times, and `train_launches`, its launches in one
training step of phase 14 (K2 and K5 also `train_backward_ms`, the device
time of their plain backward), and `eval_launches`, its launches on each
run of phases 16 and 17 (K1 and K2 also `eval_launches_per_batch` and
`eval_shapes`, as `video_shapes`), and `two_stream_launches`,
`late_fusion_launches` and `ava_launches`, its launches on each run of
phases 18, 19 and 20, with `two_stream_shapes`, `late_fusion_shapes` and
`ava_shapes` for the shapes held there (K4's fusion shape among them), and
`pretrained_launches`, `int8_launches`, `frame_fc_launches` (with
`frame_fc_shapes`) and `classifier_launches` (with `classifier_shapes`, each
B=1 classifier shape's numbers) from phases 21-24, and `served_launches`,
its launches on each run of phases 25-27 (K1 and K2 also `served_ms`,
`served_max_abs_err` and `served_request_ms`: the device time and error of
their calls inside the B=8 program, and the served request's median at
B=8 and B=1), and `kernel_program_launches`, its launches in each
request of the phase-30 programs (K3, K4 and K5 also `kernel_program_ms`,
their device ms inside the B=8 program by the profiler,
`kernel_program_bound_ms` and `kernel_program_max_abs_err`, K3
`kernel_program_pack_ms`), with the request medians of the program and of
eager, `bridge_launches`, its launches in each phase-31 run, and
`bench_launches`, in each phase-32 bench run, and the pools'
`b32_request`, `b32_shapes`, `b1_request`, `b1_shapes`, `chunk_b1_request`
and `chunk_b1_shapes` (phase 33), and `vit_launches` and `vit_shapes`
(phase 34). The entry `max_pool3d_same` (the strided
pool, which replaces no TPU kernel; `replaces` null) has no phase 1-11
numbers; the entry `stem_conv` (the stem conv, `replaces` null) holds
phase 35's alone: `launches` a request of each served detector, and
`shapes`, each shape's numbers; the entry `attn_pool` (`replaces` null)
phase 37's: `launches` in a B=32 MViTv2 request, `shapes` and `request`
(the sums over its 21 blocks). The last
is {"ok": true, "device": {...}}. Without a CUDA device, or run outside the
repository, it exits non-zero and prints no result.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

SEED = 0
SERVE_BATCHES = (1, 8)
REQUESTS_PER_BATCH = 4          # the first of each batch size warms up
KERNEL_PATH_REQUESTS = 3        # the kernel path is slower: fewer requests
BF16_RTOL = 2.0 ** -7           # one bf16 rounding step (8-bit significand)
# K3's tensor cores add each 16-deep group of products into the float32
# accumulator aligned to the largest exponent and truncated, so over 27 * C
# terms the sum drifts from the plain version's rounded float32 sum. Where
# BN and ReLU bring the output near 0 that drift is more than one bf16 step
# of the output: about 1e-5 beyond it at the Inception widths on an H100
# (phase 9 measures it). Hence an absolute floor of
# 2^-15 for K3 in bf16, and 1e-5 elsewhere.
K3_BF16_ATOL = 2.0 ** -15
# On the classifier's own activations (phase 24: post-ReLU inputs up to ~40,
# outputs near 0 after heavy cancellation) that drift is ~2e-7 of the sum of
# |x * w| * |scale| over the output's 27 * C terms, beyond 2^-15 where that
# sum is in the hundreds. Held calls on real activations (`held_backbone`)
# allow 2^-20 of that sum beside one bf16 step and 2^-15 (`k3_close`).
K3_BF16_SUM_RTOL = 2.0 ** -20
PATH_SCORE_TOL, PATH_TUBE_TOL = 1e-3, 1e-2
# The video phases: a 288-frame video of the streaming preset, 48 chunks of
# 6 frames, tiled into 48 windows one chunk apart; refinement batches of 16
# windows (three batches); each video form timed 3 times after a warm-up.
VIDEO_CHUNKS, STREAM_BATCH, VIDEO_RUNS = 48, 16, 3
STREAM_SCORE_TOL, STREAM_TUBE_TOL = 1e-4, 1e-3   # float32, TF32 off
# The training phases: B=8 clips at full width, 12 fit() steps.
TRAIN_BATCH, TRAIN_STEPS = 8, 12
LINK_VALUE_TOL = 1e-5
# The evaluation phases: 4 synthetic videos of 60 frames at a native
# 240x320 (10 windows each); the tiny card-vs-CPU evaluation's tubes
# matched within EVAL_TUBE_TOL and EVAL_SCORE_TOL and its mAPs within 1e-3; the CLIs on 4 on-disk videos of 36 frames, 4 training steps at B=2.
EVAL_VIDEOS, EVAL_FRAMES, EVAL_RESOLUTION = 4, 60, (240, 320)
EVAL_MAP_TOL = 1e-3
# phase 5's 1e-3 px at 64 px, in the 240x320 native pixels (x5), and its
# 1e-4 of score
EVAL_TUBE_TOL, EVAL_SCORE_TOL = 5e-3, 1e-4
CLI_FRAMES, CLI_STEPS = 36, 4
# The two-stream, late-fusion and AVA phases: `two_stream_train` trained for
# 12 fit() steps at B=8, as phase 14 times ucf_3step; late fusion evaluated on 2 synthetic videos of 60
# frames; an on-disk AVA layout of 3 videos of 48 frames at 6 fps (5
# keyframes each, one excluded), 60 evaluated ids of the sparse 1..80.
TS_TRAIN_BATCH, TS_TRAIN_STEPS = 8, 12
LF_VIDEOS = 2
AVA_VIDEOS, AVA_FRAMES, AVA_FPS, AVA_SIZE = 3, 48, 6, (180, 320)
# The classifier phase: I3DClassifier on 64-frame clips at 224 px (the Quo
# Vadis evaluation's centre clip, classify.py's default).
CLASSIFY_FRAMES, CLASSIFY_SIZE = 64, 224
# The serving phases: each exported program's request timed 5 times after a
# warm-up; the demo's synthetic video of 60 frames at 320x240.
SERVED_REQUESTS = 5
DEMO_FRAMES, DEMO_SIZE = 60, (240, 320)
# The data-parallel phases: fit() for 4 steps at phase 14's B=8 (3 on two
# ranks), the step alone 6 times in turns with the plain one; the
# evaluation on 1 synthetic video of EVAL_FRAMES frames (10 windows).
DP_STEPS, DP2_STEPS, DP_TIMED, DP_EVAL_VIDEOS = 4, 3, 6, 1
KERNELS = ("nms_many", "tube_roi_align", "max_pool3x3_same", "fused_scale_bias_relu",
           "conv3x3x3_bn_relu", "max_pool3d_same")
# The operators whose launches count for each of KERNELS, in the port's one
# launch counter (`step_tpu_torch/ops/kernel_op.py::LAUNCHES`): K1 launches
# through `nms_surface` on the main path and through `nms_many` elsewhere.
KERNEL_OPS = {"nms_many": ("nms_many", "nms_surface"), "tube_roi_align": ("tube_roi_align",),
              "max_pool3x3_same": ("max_pool3x3_same",),
              "fused_scale_bias_relu": ("scale_bias_relu",),
              "conv3x3x3_bn_relu": ("conv3x3x3_bn_relu",),
              "max_pool3d_same": ("max_pool3d_same",)}
# The H100 SXM's published peaks (NVIDIA's data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
F32_FLOPS = 67e12               # float32 outside the tensor cores


def bound(nbytes: float, ops: float, peak_ops: float) -> dict:
    """The least time the card could take: bytes over the memory rate or
    operations over the peak rate for their type, whichever is larger."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / peak_ops * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def hgmma_count(library, nvcc: str, kernel: str = "igemm_kernel") -> int:
    """HGMMA instructions in the SASS of the kernels whose names hold
    `kernel` (the bf16 implicit GEMM of K3 and the 1x1x1 conv by default),
    read with the cuobjdump beside nvcc."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True,
                          text=True, timeout=300)
    check(sass.returncode == 0, f"cuobjdump failed: {sass.stderr.strip()}")
    n, in_conv = 0, False
    for line in sass.stdout.splitlines():
        if "Function :" in line:
            in_conv = kernel in line
        elif in_conv and "HGMMA" in line:
            n += 1
    return n


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(launch, n: int = 20, reps: int = 5) -> float:
    """A kernel's own device time: `n` calls of its launcher (a
    `kernels.*_forward` on preallocated outputs) captured in a CUDA graph,
    the graph replayed `reps` times between CUDA events. The host's cost per
    call, which sets the pace of `cuda_ms` on a short kernel, is outside it."""
    launch()                    # builds, and allows large shared memory, first
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            launch()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * reps)


def backbone_launches(cfg, B: int):
    """The K4, K5 and K3 launches of one request of the kernel
    configuration at batch B: K4 and K5 as {NCDHW input shape: launches},
    K3 as {(NCDHW input shape, output channels): launches}. Every unit whose
    kernel is not 3x3x3 stride 1 ends in K4 (the stem's Conv3d_1a and
    Conv3d_2b, and the four 1x1x1 units of each Inception block), but in
    bfloat16 Conv3d_1a runs the stem kernel (`ops/stem_conv.py`), whose
    epilogue applies its BN and ReLU; every
    3x3x3 stride-1 unit is K3 (Conv3d_2c, and b1b and b2b of each block);
    each Inception block pools its input with K5 — the stem's once, each
    step's tail once per refinement step, on the pooled tubes of all
    B * max_proposals slots. With `chunk_stem` the stem runs on the B *
    num_chunks chunks of frames_per_chunk frames, and the tail on their
    features side by side in time. With `two_stream` a second stem (flow)
    runs the same shapes, and the fusion unit's BN + ReLU is one more K4
    launch on the fused map, 832 channels."""
    from step_tpu_torch.models.i3d import INCEPTION_CHANNELS

    up = lambda n, s: -(-n // s)  # noqa: E731
    chunks = cfg.num_chunks if cfg.chunk_stem else 1
    N = B * chunks
    T1, S1 = up(cfg.total_frames // chunks, 2), up(cfg.image_size, 2)
    S2 = up(S1, 2)
    S3 = up(S2, 2)
    T4, S4 = up(T1, 2), up(S3, 2)
    streams = 2 if cfg.two_stream else 1
    k4 = {(N, 64, T1, S2, S2): streams}
    if cfg.compute_dtype != "bfloat16":
        k4 = {(N, 64, T1, S1, S1): streams, **k4}
    k3 = {((N, 64, T1, S2, S2), 192): streams}
    k5 = {}
    where = {"Mixed_3": (N, T1, S3, streams), "Mixed_4": (N, T4, S4, streams),
             "Mixed_5": (B * cfg.max_proposals, chunks * T4, cfg.pooled_size,
                         cfg.num_steps)}
    cin = 192
    for name, c in INCEPTION_CHANNELS.items():
        n_, t, s, n = where[name[:7]]
        k5[(n_, cin, t, s, s)] = k5.get((n_, cin, t, s, s), 0) + n
        for width in (c[0], c[1], c[3], c[5]):
            k4[(n_, width, t, s, s)] = k4.get((n_, width, t, s, s), 0) + n
        for cin3, cout in ((c[1], c[2]), (c[3], c[4])):
            key = ((n_, cin3, t, s, s), cout)
            k3[key] = k3.get(key, 0) + n
        cin = c[0] + c[2] + c[4] + c[5]
    if cfg.two_stream:
        k4[(N, 832, T4, S4, S4)] = 1
    return k4, k5, k3


def with_specials(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    """x with about 0.4% of its elements each set to +0, -0, +inf, -inf and
    three NaNs with sign and payload, by raw bits: ties of signed zeros and
    NaNs whose bits the pool must carry."""
    if x.dtype == torch.float32:
        ints, pats = torch.int32, (0, -2 ** 31, 0x7F800000, -0x800000, 0x7FC00001,
                                   -0x3FFEDD, 0x7FA00000)
    else:
        ints, pats = torch.int16, (0, -2 ** 15, 0x7F80, -0x80, 0x7FC1, -0x3D, 0x7FA0)
    code = torch.randint(0, 256, x.shape, device=x.device, generator=gen,
                         dtype=torch.int16)
    bits = x.view(ints)
    for i, p in enumerate(pats):
        bits.masked_fill_(code == i, p)
    return x


def raw_bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32 if x.element_size() == 4 else torch.int16)


def nms_inputs(rng, N: int, P: int):
    """Boxes [N, P, 4], scores [N, P] and valid [N, P] that exercise every
    rule: exact ties, zero-area boxes, all-invalid problems, problems that
    exhaust before K, duplicate boxes, and boxes with NaN and infinite
    coordinates (which suppress nothing, as in the JAX package)."""
    xy = rng.uniform(0.0, 200.0, (N, P, 2))
    wh = rng.uniform(0.0, 60.0, (N, P, 2))
    wh[rng.rand(N, P) < 0.1] = 0.0                       # zero-area boxes
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    dup = rng.rand(N, P) < 0.05                          # exact duplicates
    boxes[dup] = boxes[:, :1].repeat(P, axis=1)[dup]
    odd = rng.rand(N, P, 4) < 0.01                       # NaN, +inf, -inf
    boxes[odd] = rng.choice(np.float32([np.nan, np.inf, -np.inf]), int(odd.sum()))
    scores = (rng.randint(0, 8, (N, P)) / 8.0).astype(np.float32)  # ties
    smooth = rng.rand(N) < 0.5
    scores[smooth] = rng.rand(int(smooth.sum()), P).astype(np.float32)
    valid = (rng.rand(N, P) > 0.2).astype(np.float32)
    valid[::7] = 0.0                                     # all-invalid problems
    valid[3::11, 2:] = 0.0                               # at most 2 live boxes
    return boxes, scores, valid


def surface_inputs(rng, B: int, P: int, T: int, C: int, dev):
    """tubes [B, P, T, 4] as `nms_inputs` makes boxes, scores [B, P, C]
    with ties and zero on padding, and the proposal mask [B, P] with the
    last quarter of the slots padding, on the card."""
    boxes, _, _ = nms_inputs(rng, B * T, P)
    tubes = boxes.reshape(B, T, P, 4).transpose(0, 2, 1, 3).copy()
    mask = np.ones((B, P), np.float32)
    mask[:, P - P // 4:] = 0.0
    scores = (rng.randint(0, 9, (B, P, C)) / 8.0).astype(np.float32) * mask[..., None]
    return (torch.from_numpy(a).to(dev) for a in (tubes, scores, mask))


def randn_cl(rng, shape, dev) -> torch.Tensor:
    """A float32 NCDHW tensor on the card from `rng`, in channels_last_3d
    order, as the backbone keeps its activations."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev)
    return x.contiguous(memory_format=torch.channels_last_3d)


def roi_inputs(rng, B: int, Tp: int, H: int, C: int, N: int, T: int, image: int):
    feat = rng.randn(B, Tp, H, H, C).astype(np.float32)
    base = rng.uniform(-0.2, 1.0, (B, N, 1, 2)) * image
    size = rng.uniform(0.0, 0.7, (B, N, 1, 2)) * image
    tubes = np.concatenate([base, base + size], axis=-1)
    tubes = tubes + rng.randn(B, N, T, 4) * 4.0           # per-frame jitter
    tubes[:, 0] = [-100.0, -100.0, -20.0, -20.0]          # wholly outside
    tubes[:, 1] = [image + 40.0, 30.0, image + 90.0, 80.0]
    tubes[:, 2] = [-30.0, -30.0, 60.0, 60.0]              # partly outside
    tubes[:, 3] = [100.0, 100.0, 100.0, 100.0]            # zero-area
    return feat, tubes.astype(np.float32)


def pool_case(shape, gen: torch.Generator) -> dict:
    """K5 at one NCDHW shape: the kernel against its plain version in
    float32 and bfloat16, with `with_specials` mixed in, by raw bits; its
    bf16 device, wrapper, plain and library (`F.max_pool3d`) times and its
    bound (x read once, out written once; 26 compares an element)."""
    from step_tpu_torch import kernels
    from step_tpu_torch.ops.pool import max_pool3x3_same, max_pool3x3_same_plain

    x32 = torch.randn(shape, device=gen.device, generator=gen).contiguous(
        memory_format=torch.channels_last_3d)
    x16 = x32.to(torch.bfloat16)
    for x in (with_specials(x32, gen), with_specials(x16, gen)):
        got, want = max_pool3x3_same(x), max_pool3x3_same_plain(x)
        torch.cuda.synchronize()
        differ = raw_bits(got) != raw_bits(want)
        check(not bool(differ.any()),
              f"K5 pool {x.dtype} {shape} differs from plain in "
              f"{int(differ.sum())} elements, {int(differ[want.isnan()].sum())} "
              f"of them NaN")
    out16 = torch.empty_like(x16)
    return dict(max_abs_err=0.0,
                ms=device_ms(lambda: kernels.max_pool3x3_forward(kernels.ndhwc(x16),
                                                                 kernels.ndhwc(out16))),
                wrapper_ms=cuda_ms(lambda: max_pool3x3_same(x16)),
                plain_ms=cuda_ms(lambda: max_pool3x3_same_plain(x16)),
                library_ms=cuda_ms(lambda: F.max_pool3d(x16, 3, 1, 1)),
                **bound(2 * x16.numel() * 2, 26 * x16.numel(), F32_FLOPS))


# The strided SAME pools of the stem, (window, stride) by name.
STRIDED_POOLS = {"MaxPool_2a": ((1, 3, 3), (1, 2, 2)), "MaxPool_3a": ((1, 3, 3), (1, 2, 2)),
                 "MaxPool_4a": ((3, 3, 3), (2, 2, 2))}
# The strided pools of an `I3DClassifier` request: the stem's three and MaxPool_5a.
CLASSIFIER_STRIDED = 4


def strided_launches(cfg, B: int) -> dict:
    """The strided pools of one request at batch B: {(name, NCDHW input
    shape): launches}, the stem's MaxPool_2a, 3a and 4a once each (on the
    B * num_chunks chunks with `chunk_stem`, as `backbone_launches`)."""
    up = lambda n, s: -(-n // s)  # noqa: E731
    chunks = cfg.num_chunks if cfg.chunk_stem else 1
    N = B * chunks
    T1, S1 = up(cfg.total_frames // chunks, 2), up(cfg.image_size, 2)
    S2, S3 = up(S1, 2), up(up(S1, 2), 2)
    return {("MaxPool_2a", (N, 64, T1, S1, S1)): 1, ("MaxPool_3a", (N, 192, T1, S2, S2)): 1,
            ("MaxPool_4a", (N, 480, T1, S3, S3)): 1}


def strided_pool_case(shape, window, stride, gen: torch.Generator) -> dict:
    """The strided pool kernel (`ops/pool.py::max_pool3d_same`) at one NCDHW
    shape: against its plain version (`F.pad(-inf)` + `F.max_pool3d`) in
    float32 and bfloat16, with `with_specials` mixed in, by raw bits; its
    bf16 device, wrapper and plain times, the library's (`F.max_pool3d` on
    the input padded beforehand, so without the pad's copy) and its bound
    (x read once, out written once)."""
    from step_tpu_torch import kernels
    from step_tpu_torch.ops.kernel_op import LAUNCHES
    from step_tpu_torch.ops.pool import (max_pool3d_same, max_pool3d_same_plain,
                                         max_pool3d_same_shape, same_padding)

    x32 = torch.randn(shape, device=gen.device, generator=gen).contiguous(
        memory_format=torch.channels_last_3d)
    x16 = x32.to(torch.bfloat16)
    for x in (with_specials(x32, gen), with_specials(x16, gen)):
        before = LAUNCHES["max_pool3d_same"]
        got, want = max_pool3d_same(x, window, stride), max_pool3d_same_plain(x, window, stride)
        torch.cuda.synchronize()
        check(LAUNCHES["max_pool3d_same"] == before + 1, "max_pool3d_same did not launch once")
        check(got.shape == want.shape and got.is_contiguous(
            memory_format=torch.channels_last_3d), f"strided pool {shape}: {got.shape}")
        differ = raw_bits(got.contiguous()) != raw_bits(want.contiguous())
        check(not bool(differ.any()),
              f"strided pool {window}/{stride} {x.dtype} {shape} differs from plain in "
              f"{int(differ.sum())} elements, {int(differ[want.isnan()].sum())} of them NaN")
    del x32, got, want
    out16 = kernels.empty_ncdhw(max_pool3d_same_shape(shape, stride), x16)
    sym, pad = same_padding(x16, window, stride)
    padded = x16 if pad is None else F.pad(x16, pad, value=float("-inf"))
    return dict(max_abs_err=0.0,
                ms=device_ms(lambda: kernels.max_pool3d_same_forward(
                    kernels.ndhwc(x16), kernels.ndhwc(out16), window, stride)),
                wrapper_ms=cuda_ms(lambda: max_pool3d_same(x16, window, stride)),
                plain_ms=cuda_ms(lambda: max_pool3d_same_plain(x16, window, stride)),
                library_ms=cuda_ms(lambda: F.max_pool3d(padded, window, stride, sym or 0)),
                **bound((x16.numel() + out16.numel()) * 2,
                        math.prod(window) * out16.numel(), F32_FLOPS))


def pool_b32_phase(dev, per_request: dict) -> dict:
    """Phase 33: every max pool of a main-path `ucf_3step` request on the
    kernel that pools it there, at B=32 (the benchmark's cells), at B=1
    (live serving) and on a B=1 request's chunk stems (`chunk_stem`, T' =
    6, the streaming path's): K5 at the 13 stride-1 launches (the stem's
    seven, each step's tail's two) and the strided kernel at the stem's
    three, each held against its plain version by raw bits and timed beside
    its bound, its plain version and the library's call. At B=32 and B=1
    the launches a request that `backbone_launches` and `strided_launches`
    list must equal `per_request`, the counts a request of phase 6 (the
    main path at B=1 and B=8) measured. Returns
    {"max_pool3x3_same": ..., "max_pool3d_same": ...} for the JSON line:
    `b32_request` and `b32_shapes`, `b1_…` and `chunk_b1_…`."""
    from step_tpu_torch import PRESETS

    t33 = time.time()
    cfg = PRESETS["ucf_3step"]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 33)
    out = {"max_pool3x3_same": {}, "max_pool3d_same": {}}
    for key, c, B in (("b32", cfg, 32), ("b1", cfg, 1),
                      ("chunk_b1", cfg.replace(chunk_stem=True), 1)):
        k5 = [(f"3x3x3/1 {list(s)}", n, s, None)
              for s, n in backbone_launches(c, B)[1].items()]
        strided = [(f"{name} {list(s)}", n, s, STRIDED_POOLS[name])
                   for (name, s), n in strided_launches(c, B).items()]
        for kernel, cases in (("max_pool3x3_same", k5), ("max_pool3d_same", strided)):
            total = dict(ms=0.0, bound_ms=0.0, plain_ms=0.0, library_ms=0.0, launches=0)
            rows = {}
            for label, n, shape, pool in cases:
                r = pool_case(shape, gen) if pool is None else strided_pool_case(shape, *pool, gen)
                torch.cuda.empty_cache()
                rows[label] = dict(r, launches=n)
                for k in ("ms", "bound_ms", "plain_ms", "library_ms"):
                    total[k] += n * r[k]
                total["launches"] += n
                print(f"[33] {kernel} {key} {label} x{n}: the plain version's bits; kernel "
                      f"{r['ms']:.4f} ms, {r['bound_ms'] / r['ms']:.1%} of the "
                      f"{r['bound_ms']:.4f} ms bound; wrapper {r['wrapper_ms']:.4f}, plain "
                      f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f} ms", flush=True)
            check(key == "chunk_b1" or total["launches"] == per_request[kernel],
                  f"{kernel} {key}: the tables list {total['launches']} launches a request, "
                  f"the main path measured {per_request[kernel]}")
            print(f"[33] {kernel} {key}: {total['launches']} launches a request, kernels "
                  f"{total['ms']:.4f} ms ({total['bound_ms'] / total['ms']:.1%} of the "
                  f"{total['bound_ms']:.4f} ms bound), plain {total['plain_ms']:.4f}, library "
                  f"{total['library_ms']:.4f} ms", flush=True)
            out[kernel].update({f"{key}_request": total, f"{key}_shapes": rows})
    print(f"    phase 33 took {time.time() - t33:.1f} s", flush=True)
    return out


# A request of the ViT detector at B=32: K1 once on the C = 60 surface, K2
# once a refinement step on the [32, 9, 14, 14, 768] map, K5 at the two
# pools of each step's tail on the pooled tubes, no strided pool (the ViT
# has none), no K3 or K4.
VIT_B = 32
VIT_LAUNCHES = {"nms_many": 1, "tube_roi_align": 3, "max_pool3x3_same": 6,
                "max_pool3d_same": 0, "fused_scale_bias_relu": 0, "conv3x3x3_bn_relu": 0}


def vit_phase(dev, rng, smi_line: str, reset_counts, read_counts) -> dict:
    """Phase 34, the benchmark's `ava_videomae_b16` detector (VideoMAE
    ViT-B/16 at published widths, `models/vit.py`) built as the benchmark
    builds it (`benchmark/program.py::Server` on `benchmark/work.py`'s
    seeded weights: BN-folded heads, the tree in bfloat16) and served one
    B=32 request of 224 px uint8 clips through `detect_clip`, the launch
    counts set to 0 just before and read just after: they must equal
    `VIT_LAUNCHES`. Every K1 and K2 call of that request is held against its
    plain version on its own inputs (`held_run`; K2 also on its features in
    float32 within 1e-4), every K5 launch at its launcher by raw bits
    (`held_backbone_launches`), and K5 at each tail shape against its plain
    version in f32 and bf16 with `with_specials` (`pool_case`). Returns, per
    kernel, `vit_launches` and `vit_shapes` for the JSON line."""
    from benchmark import work
    from benchmark.program import Server
    from benchmark.reference import detector as reference
    from step_tpu_torch.ops.roi_align import tube_roi_align, tube_roi_align_plain

    t34 = time.time()
    out = {name: dict(vit_launches={}, vit_shapes={}) for name in KERNELS}
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "benchmark", "configs", "ava_videomae_b16.json")) as f:
        fields = json.load(f)["config"]
    server = Server(fields, work.make_weights(reference.config(fields), SEED + 34, dev),
                    dev)
    cfg = server.cfg
    T, S = cfg.total_frames, cfg.image_size
    props, pmask = server.proposals(VIT_B)
    clips = [torch.from_numpy(rng.randint(0, 256, (VIT_B, T, S, S, 3)).astype(np.uint8))
             .to(dev) for _ in range(2)]
    server.detect(clips[0], props, pmask)       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    errors = {}
    t0 = time.perf_counter()
    with held_backbone_launches(errors) as held:
        _, counts, _ = held_run("serve_b32", lambda: server.detect(clips[1], props, pmask),
                                reset_counts, read_counts, out, "vit")
    wall = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    check(counts == VIT_LAUNCHES,
          f"a B={VIT_B} request of the ViT detector launched {counts}, not {VIT_LAUNCHES}")
    tails = {(VIT_B * cfg.max_proposals, c, T // 2, cfg.pooled_size, cfg.pooled_size):
             cfg.num_steps for c in (768, 832)}
    k5_held = {}
    for shape, _ in held.get("max_pool3x3_same", []):
        k5_held[shape] = k5_held.get(shape, 0) + 1
    check(k5_held == tails and not held.get("fused_scale_bias_relu")
          and not held.get("conv3x3x3_bn_relu"),
          f"the ViT request's K3/K4/K5 launches at their launchers: "
          f"{ {k: len(v) for k, v in held.items()} }, K5 at {k5_held}, not {tails}")
    print(f"[34] ava_videomae_b16 B={VIT_B} ({smi_line}): launches {counts}; every K5 "
          f"launch the plain version's bits (tails {sorted(k5_held)}); request wall "
          f"{wall:.1f} ms with every call held; peak memory {peak / 2**30:.2f} GiB",
          flush=True)
    del server, clips
    # K2 at the request's map shape on phase 4's boxes (partly, wholly
    # outside, zero-area), float32 within 1e-4 and bfloat16 within one step
    Hf = S // cfg.feature_stride
    feat_np, tubes_np = roi_inputs(rng, VIT_B, T // 2, Hf, 768, cfg.max_proposals, T, S)
    feat32, tubes = torch.from_numpy(feat_np).to(dev), torch.from_numpy(tubes_np).to(dev)
    for f in (feat32, feat32.to(torch.bfloat16)):
        got = tube_roi_align(f, tubes, cfg.pooled_size, 1.0 / cfg.feature_stride,
                             cfg.sampling_ratio)
        want = tube_roi_align_plain(f, tubes, cfg.pooled_size, 1.0 / cfg.feature_stride,
                                    cfg.sampling_ratio)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = (torch.allclose(got, want, rtol=1e-4, atol=1e-4) if f.dtype == torch.float32
              else bf16_close(got, want))
        check(ok and got.dtype == f.dtype and float(want[:, 0].abs().max()) == 0.0,
              f"K2 at {list(f.shape)} {f.dtype} differs from plain: max |err| {err}")
        out["tube_roi_align"]["vit_shapes"][f"random boxes {list(f.shape)} {f.dtype}"] = dict(
            max_abs_err=err)
        print(f"[34] K2 at {list(f.shape)} {f.dtype}, phase 4's boxes: max |err| {err:.3g} "
              f"({'tol 1e-4' if f.dtype == torch.float32 else 'one bf16 step'})", flush=True)
    del feat32, tubes, got, want
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 34)
    for shape, n in tails.items():
        r = pool_case(shape, gen)
        torch.cuda.empty_cache()
        out["max_pool3x3_same"]["vit_shapes"][f"tail {list(shape)}"] = dict(r, launches=n)
        print(f"[34] K5 max_pool3x3 {list(shape)} x{n} a request: the plain version's bits in "
              f"f32 and bf16, NaN payloads included; bf16 kernel {r['ms']:.4f} ms "
              f"({r['bound_ms'] / r['ms']:.1%} of the {r['bound_ms']:.4f} ms bound), plain "
              f"{r['plain_ms']:.4f} ms", flush=True)
    print(f"    phase 34 took {time.time() - t34:.1f} s", flush=True)
    return out


# A B=32 request's stem conv launches: one on `ucf_3step`'s RGB stem, none on
# the ViT detector, which has no I3D stem.
STEM_LAUNCHES = {"ucf_3step": 1, "ava_videomae_b16": 0}
STEM_SHAPES = {"served B=32": (32, 18, 224, 224, 3), "B=1": (1, 18, 224, 224, 3),
               "chunk stems B=1": (3, 6, 224, 224, 3), "flow B=32": (32, 18, 224, 224, 2)}


def stem_close(got, want, x, weight, scale) -> bool:
    """The stem kernel's bf16 output against its plain version on the same
    inputs x (NCDHW), weight and scale: one rounding step, 2^-15, and
    K3_BF16_SUM_RTOL of the sum of |x * w| * |scale| each output adds up
    (1,029 float32 products summed in other orders)."""
    from step_tpu_torch.ops.pool import same_padding

    w = weight.to(torch.bfloat16).float().abs()
    sym, pad = same_padding(x, (7, 7, 7), (2, 2, 2))
    xa = x.float().abs()
    terms = (F.conv3d(xa, w, None, 2, sym) if sym is not None
             else F.conv3d(F.pad(xa, pad), w, None, 2))
    if scale is not None:
        terms = terms * scale.abs().view(1, -1, 1, 1, 1)
    err = (got.float() - want.float()).abs()
    return bool((err <= BF16_RTOL * want.float().abs() + K3_BF16_ATOL
                 + K3_BF16_SUM_RTOL * terms).all())


def stem_bound(x_shape) -> dict:
    """The stem conv's least time: 2 * 343 C * 64 operations an output
    position at the bf16 tensor peak, or its bf16 input and output once."""
    N, T, H, W, C = x_shape
    positions = N * -(-T // 2) * -(-H // 2) * -(-W // 2)
    return bound(2 * (N * T * H * W * C + positions * 64), 2 * positions * 64 * 343 * C,
                 BF16_TENSOR_FLOPS)


def stem_case(shape, gen: torch.Generator) -> dict:
    """The stem kernel at one `[N, T, H, W, C]` input with the folded
    bias and the ReLU: held against the plain version (`stem_close`), its
    device and wrapper ms, its plain version's, today's path before it
    (`F.pad`, cuDNN's bf16 conv with the bias, the ReLU: `library_ms`) and
    cuDNN on the input and weight zero-padded to 8 channels
    (`library_pad8_ms`), both on the device as the kernel is timed."""
    from step_tpu_torch import kernels
    from step_tpu_torch.models.i3d import conv3d_same
    from step_tpu_torch.ops.stem_conv import pack_stem_weight, stem_conv, stem_conv_plain

    N, T, H, W, C = shape
    x = torch.randn(shape, generator=gen, device=gen.device).to(torch.bfloat16)
    xc = x.permute(0, 4, 1, 2, 3)                 # the detector's NCDHW view
    weight = torch.randn(64, C, 7, 7, 7, generator=gen, device=gen.device) / math.sqrt(343 * C)
    bias = torch.randn(64, generator=gen, device=gen.device) * 0.1
    got = stem_conv(xc, weight, None, bias)
    want = stem_conv_plain(xc, weight, None, bias)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    check(stem_close(got, want, xc, weight, None),
          f"stem conv at {list(shape)} differs from plain: max |err| {err}")
    packed = pack_stem_weight(weight)
    out = torch.empty(kernels.stem_conv_shape(shape), dtype=torch.bfloat16, device=x.device)
    ms = device_ms(lambda: kernels.stem_conv_forward(x, packed, None, bias, out, True))
    wb, bb = weight.to(torch.bfloat16), bias.to(torch.bfloat16)
    library_ms = device_ms(lambda: F.relu(conv3d_same(xc, wb, bb, (2, 2, 2))), n=4, reps=2)
    x8 = F.pad(x, (0, 8 - C)).permute(0, 4, 1, 2, 3)
    w8 = F.pad(wb, (0, 0, 0, 0, 0, 0, 0, 8 - C)).contiguous(
        memory_format=torch.channels_last_3d)
    pad8_ms = device_ms(lambda: F.relu(conv3d_same(x8, w8, bb, (2, 2, 2))), n=2, reps=2)
    del x8, w8
    r = dict(max_abs_err=err, ms=ms, wrapper_ms=cuda_ms(lambda: stem_conv(xc, weight, None, bias)),
             plain_ms=cuda_ms(lambda: stem_conv_plain(xc, weight, None, bias), iters=3, warmup=1),
             library_ms=library_ms, library_pad8_ms=pad8_ms, **stem_bound(shape))
    return r


@contextlib.contextmanager
def held_stem_launches(errors: dict):
    """Each stem conv launch while the block runs, at its launcher
    (`kernels.stem_conv_forward`), held against its plain version on its
    own inputs (`stem_close`); yields the list of launch shapes and fills
    `errors["stem_conv"]` with the largest |error|."""
    from step_tpu_torch import kernels
    from step_tpu_torch.ops.stem_conv import stem_conv_plain, unpack_stem_weight

    launcher, seen = kernels.stem_conv_forward, []

    def run(x, w, scale, bias, out, relu):
        launcher(x, w, scale, bias, out, relu)
        xc = x.permute(0, 4, 1, 2, 3)
        weight = unpack_stem_weight(w, x.shape[4])
        want = stem_conv_plain(xc, weight, scale, bias, relu)
        got = out.permute(0, 4, 1, 2, 3)
        err = float((got.float() - want.float()).abs().max())
        check(stem_close(got, want, xc, weight, scale),
              f"a stem conv launch at {list(x.shape)} differs from plain: max |err| {err}")
        errors["stem_conv"] = max(errors.get("stem_conv", 0.0), err)
        seen.append(tuple(x.shape))

    kernels.stem_conv_forward = run
    try:
        yield seen
    finally:
        kernels.stem_conv_forward = launcher


def stem_phase(dev, rng, smi_line: str, n_hgmma: int) -> dict:
    """Phase 35, the stem conv kernel: each of `STEM_SHAPES` against its
    plain version and timed (`stem_case`), then a B=32 request of each
    detector of `STEM_LAUNCHES`, built as `benchmark/program.py::Server`
    builds it, with every stem launch held against plain. Returns the
    kernel's JSON entry: `launches` a request of each detector, `shapes`."""
    from benchmark import work
    from benchmark.program import Server
    from benchmark.reference import detector as reference
    from step_tpu_torch.ops.kernel_op import LAUNCHES

    t35 = time.time()
    check(n_hgmma > 0, "the stem conv kernels hold no HGMMA instruction")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 35)
    shapes = {}
    for label, shape in STEM_SHAPES.items():
        r = shapes[f"{label} {list(shape)}"] = stem_case(shape, gen)
        torch.cuda.empty_cache()
        print(f"[35] stem conv {label} {list(shape)}, bias + ReLU: max |err| "
              f"{r['max_abs_err']:.3g} (one bf16 step + accumulation); kernel {r['ms']:.4f} ms "
              f"({r['bound_ms'] / r['ms']:.1%} of the {r['bound_ms']:.4f} ms bound, "
              f"{r['bound_by']}), wrapper {r['wrapper_ms']:.4f}, plain {r['plain_ms']:.4f}, "
              f"today's F.pad + cuDNN + ReLU {r['library_ms']:.4f}, cuDNN on 8 channels "
              f"{r['library_pad8_ms']:.4f} ms", flush=True)
    launches = {}
    here = os.path.dirname(os.path.abspath(__file__))
    for name, n_want in STEM_LAUNCHES.items():
        with open(os.path.join(here, "benchmark", "configs", f"{name}.json")) as f:
            fields = json.load(f)["config"]
        server = Server(fields, work.make_weights(reference.config(fields), SEED + 35, dev),
                        dev)
        cfg = server.cfg
        T, S = cfg.total_frames, cfg.image_size
        props, pmask = server.proposals(32)
        clips = [torch.from_numpy(rng.randint(0, 256, (32, T, S, S, 3)).astype(np.uint8))
                 .to(dev) for _ in range(2)]
        server.detect(clips[0], props, pmask)       # warm-up
        torch.cuda.synchronize()
        errors = {}
        before = LAUNCHES["stem_conv"]
        with held_stem_launches(errors) as seen:
            out = server.detect(clips[1], props, pmask)
            torch.cuda.synchronize()
        n = LAUNCHES["stem_conv"] - before
        check(n == n_want == len(seen) and bool(torch.isfinite(out["tubes"]).all()),
              f"a B=32 request of {name} launched the stem conv {n} times ({len(seen)} "
              f"held), not {n_want}")
        launches[f"{name}_b32"] = n
        print(f"[35] {name} B=32 ({smi_line}): {n} stem conv launch(es) a request "
              f"{seen}, each held against plain (max |err| {errors.get('stem_conv')})",
              flush=True)
        del server, clips, out
        torch.cuda.empty_cache()
    print(f"    phase 35 took {time.time() - t35:.1f} s", flush=True)
    return dict(launches=launches, hgmma=n_hgmma, shapes=shapes)


# The heads' Inception blocks: a B=32 request of each cell's configuration
# runs six (two a head, three heads) and three head reductions; a B=1
# request the same.
INCEPTION_LAUNCHES = {"inception_block": 6, "conv1x1x1_bias_relu": 3}
INCEPTION_SHAPES = {"I3D Mixed_5b B=32": (512, 832, 5, "Mixed_5b"),
                    "I3D Mixed_5c B=32": (512, 832, 5, "Mixed_5c"),
                    "ViT Mixed_5b B=32": (512, 768, 9, "Mixed_5b"),
                    "ViT Mixed_5c B=32": (512, 832, 9, "Mixed_5c"),
                    "I3D Mixed_5b B=1": (16, 832, 5, "Mixed_5b"),
                    "I3D Mixed_5c B=1": (16, 832, 5, "Mixed_5c")}


def block_model(x, weights, channels):
    """The operator's arithmetic in float32 on bf16 x, from the units'
    OIDHW weights and biases (w012, b012, w1b, b1b, w2b, b2b, w3b, b3b):
    each unit's sum, bias and ReLU in float32, rounded once, b1 and b2 on
    b012's rounded output; with the terms |y| * |w| each b1/b2 output adds
    up (zero elsewhere)."""
    w012, b012, w1b, b1b, w2b, b2b, w3b, b3b = (t.float() for t in weights)
    c0, c1, c2, c3, c4, c5 = channels
    unit = lambda t, w, b: torch.relu(F.conv3d(t, w, b, 1, w.shape[2] // 2))  # noqa: E731
    xf = x.float()
    y = unit(xf, w012, b012).to(torch.bfloat16).float()
    y1, y2 = y[:, c0: c0 + c1], y[:, c0 + c1:]
    out = torch.cat([y[:, :c0], unit(y1, w1b, b1b), unit(y2, w2b, b2b),
                     unit(F.max_pool3d(xf, 3, 1, 1), w3b, b3b)], dim=1)
    terms = torch.zeros_like(out)
    terms[:, c0: c0 + c2] = F.conv3d(y1.abs(), w1b.abs(), None, 1, 1)
    terms[:, c0 + c2: c0 + c2 + c4] = F.conv3d(y2.abs(), w2b.abs(), None, 1, 1)
    return out, terms


def block_close(got, want, terms) -> bool:
    """One bf16 step of the output, 2^-15, and one bf16 step of each term
    a b1/b2 output adds up: b012's rounding of a y may fall the other way
    where its float32 sum is taken in another order."""
    err = (got.float() - want).abs()
    return bool((err <= BF16_RTOL * (want.abs() + terms) + 2.0 ** -15).all())


def unpacked_block(weights, cin, channels):
    """The units' OIDHW weights and float32 biases from the operator's
    packed arguments (`ops/inception.py::block_kernel_weights`)."""
    from step_tpu_torch.ops.conv3d import unpack_kernel_weight, unpack_tube_weight

    w012, b012, w1b, b1b, w2b, b2b, w3b, b3b = weights
    c0, c1, c2, c3, c4, c5 = channels
    return (unpack_kernel_weight(w012, cin, c0 + c1 + c3, 1), b012,
            unpack_tube_weight(w1b, c1, c2), b1b, unpack_tube_weight(w2b, c3, c4), b2b,
            unpack_kernel_weight(w3b, cin, c5, 1), b3b)


def block_case(shape, gen: torch.Generator) -> dict:
    """The operator at one served shape `(N, Cin, T', block)`: held against
    `block_model`, the whole block's device ms (its calls captured in a CUDA
    graph) beside the sum of its kernels' bounds, the plain version's ms and
    today's path's (`library_ms`); then each kernel on preallocated
    outputs: its device ms, bound, today's unit (cuDNN conv with the bias,
    the ReLU, on the slice: `library_ms`) and cuDNN's conv alone on a
    channels-last input (`library_conv_ms`)."""
    from step_tpu_torch import kernels
    from step_tpu_torch.models.i3d import INCEPTION_CHANNELS, InceptionBlock
    from step_tpu_torch.ops import inception

    N, cin, T, name = shape
    channels = INCEPTION_CHANNELS[name]
    c0, c1, c2, c3, c4, c5 = channels
    block = InceptionBlock(cin, channels, bn_folded=True, fused_inception=True).eval()
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=gen, device=gen.device).cpu()
                    / math.sqrt(max(p[0].numel(), 1)))
    block = block.to(gen.device, torch.bfloat16).requires_grad_(False)
    x = torch.relu(torch.randn((N, cin, T, 7, 7), generator=gen, device=gen.device)).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    units = (block.b012, block.b1b, block.b2b, block.b3b)
    tensors = [t for u in units for t in (u.conv.weight, u.conv.bias)]
    weights = inception.block_kernel_weights(tensors, torch.bfloat16)
    with torch.no_grad():
        got = inception.inception_block(x, weights, channels)
        want, terms = block_model(x, tensors, channels)
        torch.cuda.synchronize()
        err = float((got.float() - want).abs().max())
        check(block_close(got, want, terms),
              f"the Inception block at {list(x.shape)} ({name}) differs from its model: "
              f"max |err| {err}")
        del want, terms
        M = N * T * 49
        xr = kernels.ndhwc(x)
        out = torch.empty((N, T, 7, 7, c0 + c2 + c4 + c5), dtype=torch.bfloat16,
                          device=x.device)
        scratch = torch.empty((N, T, 7, 7, c1 + c3), dtype=torch.bfloat16, device=x.device)
        pooled = torch.empty_like(xr)
        w012, b012, w1b, b1b, w2b, b2b, w3b, b3b = weights
        y = block.b012(x)
        s1, s2 = y[:, c0: c0 + c1], y[:, c0 + c1:]
        cl = lambda t: t.contiguous(memory_format=torch.channels_last_3d)  # noqa: E731
        kernel_cases = {
            "b012 1x1x1 GEMM (split epilogue)": (
                lambda: kernels.igemm_forward(xr, w012, None, b012, (out[..., :c0], scratch), 1),
                2 * M * (cin + c0 + c1 + c3), 2 * M * cin * (c0 + c1 + c3), block.b012, x),
            "b1b tube conv": (
                lambda: kernels.tube_conv_forward(scratch[..., :c1], w1b, b1b,
                                                  out[..., c0: c0 + c2]),
                2 * M * (c1 + c2), 2 * M * 27 * c1 * c2, block.b1b, s1),
            "b2b tube conv": (
                lambda: kernels.tube_conv_forward(scratch[..., c1:], w2b, b2b,
                                                  out[..., c0 + c2: c0 + c2 + c4]),
                2 * M * (c3 + c4), 2 * M * 27 * c3 * c4, block.b2b, s2),
            "b3 pool (K5)": (lambda: kernels.max_pool3x3_forward(xr, pooled),
                             2 * M * 2 * cin, 0, None, None),
            "b3b 1x1x1 GEMM": (
                lambda: kernels.igemm_forward(pooled, w3b, None, b3b, (out[..., -c5:],), 1),
                2 * M * (cin + c5), 2 * M * cin * c5, block.b3b, x),
        }
        rows, total_bound = {}, 0.0
        for label, (launch, nbytes, ops, unit, unit_in) in kernel_cases.items():
            r = dict(ms=device_ms(launch), **bound(nbytes, ops, BF16_TENSOR_FLOPS))
            if unit is not None:
                from step_tpu_torch.models.i3d import conv3d_same
                wb, bb = unit.conv.weight, unit.conv.bias
                r["library_ms"] = device_ms(lambda: F.relu(conv3d_same(unit_in, wb, bb,
                                                                       (1, 1, 1))), n=5, reps=2)
                dense = cl(unit_in)
                r["library_conv_ms"] = device_ms(lambda: conv3d_same(dense, wb, None,
                                                                     (1, 1, 1)), n=5, reps=2)
            total_bound += r["bound_ms"]
            rows[label] = r
        del y, s1, s2
        r = dict(max_abs_err=err,
                 ms=device_ms(lambda: inception.inception_block(x, weights, channels), n=5,
                              reps=2),
                 wrapper_ms=cuda_ms(lambda: inception.inception_block(x, weights, channels)),
                 bound_ms=total_bound,
                 plain_ms=cuda_ms(lambda: inception.inception_block_plain(x, *tensors, channels),
                                  iters=5, warmup=1),
                 library_ms=device_ms(lambda: block(x), n=5, reps=2), kernels=rows)
    return r


def inception_phase(dev, rng, smi_line: str, n_hgmma: int) -> dict:
    """Phase 36, the heads' served Inception block: each of
    `INCEPTION_SHAPES` held and timed (`block_case`), then a B=32 request of
    each cell's detector and a B=1 request of `ucf_3step`, built as
    `benchmark/program.py::Server` builds them, with every block held
    against its model at its call and the launches counted
    (`INCEPTION_LAUNCHES`). Returns the entry's `shapes` and `launches`."""
    from benchmark import work
    from benchmark.program import Server
    from benchmark.reference import detector as reference
    from step_tpu_torch.models import i3d
    from step_tpu_torch.ops import inception
    from step_tpu_torch.ops.kernel_op import LAUNCHES

    t36 = time.time()
    check(n_hgmma > 0, "the tube conv kernels hold no HGMMA instruction")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 36)
    shapes = {}
    for label, shape in INCEPTION_SHAPES.items():
        r = shapes[f"{label} {list(shape[:3])} + [7, 7]"] = block_case(shape, gen)
        torch.cuda.empty_cache()
        print(f"[36] Inception block {label} {list(shape[:3])}: max |err| "
              f"{r['max_abs_err']:.3g} against its model; block {r['ms']:.4f} ms "
              f"({r['bound_ms'] / r['ms']:.1%} of the {r['bound_ms']:.4f} ms bound), "
              f"wrapper {r['wrapper_ms']:.4f}, plain {r['plain_ms']:.4f}, today's path "
              f"(library) {r['library_ms']:.4f} ms", flush=True)
        for name, k in r["kernels"].items():
            lib = (f"; today's unit {k['library_ms']:.4f}, cuDNN conv alone "
                   f"{k['library_conv_ms']:.4f} ms" if "library_ms" in k else "")
            print(f"       {name}: {k['ms']:.4f} ms ({k['bound_ms'] / k['ms']:.1%} of the "
                  f"{k['bound_ms']:.4f} ms bound, {k['bound_by']}){lib}", flush=True)
    launches = {}
    here = os.path.dirname(os.path.abspath(__file__))
    for name, B in (("ucf_3step", 32), ("ava_3step", 32), ("ava_videomae_b16", 32),
                    ("ucf_3step", 1)):
        with open(os.path.join(here, "benchmark", "configs", f"{name}.json")) as f:
            fields = json.load(f)["config"]
        server = Server(fields, work.make_weights(reference.config(fields), SEED + 36, dev),
                        dev)
        cfg = server.cfg
        T, S = cfg.total_frames, cfg.image_size
        props, pmask = server.proposals(B)
        clips = [torch.from_numpy(rng.randint(0, 256, (B, T, S, S, 3)).astype(np.uint8))
                 .to(dev) for _ in range(2)]
        server.detect(clips[0], props, pmask)       # warm-up
        torch.cuda.synchronize()
        held, errors = [], []
        real = i3d.inception_block

        def hold(x, weights, channels):
            got = real(x, weights, channels)
            tensors = unpacked_block(weights, x.shape[1], channels)
            want, terms = block_model(x, tensors, channels)
            err = float((got.float() - want).abs().max())
            check(block_close(got, want, terms),
                  f"a block call at {list(x.shape)} differs from its model: max |err| {err}")
            held.append(tuple(x.shape))
            errors.append(err)
            return got

        before = {k: LAUNCHES[k] for k in INCEPTION_LAUNCHES}
        with swapped(real, hold):
            out = server.detect(clips[1], props, pmask)
            torch.cuda.synchronize()
        counts = {k: LAUNCHES[k] - before[k] for k in INCEPTION_LAUNCHES}
        check(counts == INCEPTION_LAUNCHES and len(held) == 6
              and bool(torch.isfinite(out["tubes"]).all()),
              f"a B={B} request of {name} launched {counts} ({len(held)} blocks held), not "
              f"{INCEPTION_LAUNCHES}")
        launches[f"{name}_b{B}"] = dict(counts, max_abs_err=max(errors))
        print(f"[36] {name} B={B} ({smi_line}): {counts} a request, blocks at "
              f"{sorted(set(held))}, each held against its model (max |err| "
              f"{max(errors):.3g})", flush=True)
        del server, clips, out
        torch.cuda.empty_cache()
    print(f"    phase 36 took {time.time() - t36:.1f} s", flush=True)
    return dict(launches=launches, hgmma=n_hgmma, shapes=shapes)


ATTN_POOL_EPS = 1e-6            # models/vit.py::LN_EPS
ATTN_POOL_LAUNCHES = 63         # 3 parts x 21 blocks of a full-depth request


def attn_pool_blocks() -> dict:
    """{(input grid, dim_out, heads, q stride, K/V stride): blocks} of a
    full-depth MViTv2-B request at 224 px and 18 frames, in block order."""
    from step_tpu_torch.models import mvit

    size, blocks = (9, 56, 56), {}
    for _, dim_out, heads, q_stride, kv_stride in mvit.block_plan("full"):
        key = (size, dim_out, heads, q_stride, kv_stride)
        blocks[key] = blocks.get(key, 0) + 1
        size = mvit.pooled(size, q_stride)
    return blocks


def attn_pool_close(got: torch.Tensor, want: torch.Tensor) -> bool:
    """The kernel's bf16 output against the plain version's: each rounds a
    float32 result that differs from the other's only by the order of its
    sums, so they are one bf16 step apart at most, with 1e-4 absolute where
    an output near 0 has steps finer than the sums' float32 error."""
    err = (got.float() - want.float()).abs()
    return bool((err <= BF16_RTOL * want.float().abs() + 1e-4).all())


def attn_pool_case(B: int, key, gen: torch.Generator, dev) -> dict:
    """One block's three pools at batch B, on a bf16 qkv of the block's
    shape (a GEMM output: unit normal plus a per-channel offset, as its
    bias gives) with bf16 weights: each part held against the plain version
    (float32 conv and norm, TF32 off), then timed as the block runs them
    (three launches): device ms, the bound by the benchmark's bytes (each
    part's whole input, `benchmark/reference/backbones/mvitv2_b.py`) and by
    the bytes the taps touch, the plain version, and today's path before
    the kernel (the library yardstick, which the port no longer calls:
    `F.conv3d(groups=d)` on channel-major parts, then `F.layer_norm` on the
    transposed view)."""
    from step_tpu_torch import kernels
    from step_tpu_torch.models import mvit
    from step_tpu_torch.ops.attn_pool import attn_pool_plain

    grid, dim_out, heads, q_stride, kv_stride = key
    d, N = dim_out // heads, math.prod(grid)
    qkv = (torch.randn((B, N, 3 * dim_out), device=dev, generator=gen)
           + torch.randn(3 * dim_out, device=dev, generator=gen)).bfloat16()
    strides = (q_stride, kv_stride, kv_stride)
    weights = [((0.2 * torch.randn((d, 1, 3, 3, 3), device=dev, generator=gen)).bfloat16(),
                (1 + 0.2 * torch.randn(d, device=dev, generator=gen)).bfloat16(),
                (0.1 * torch.randn(d, device=dev, generator=gen)).bfloat16()) for _ in range(3)]
    outs = [torch.empty(kernels.attn_pool_shape(qkv.shape, heads, grid, s), device=dev,
                        dtype=torch.bfloat16) for s in strides]

    def launch():
        for part in range(3):
            kernels.attn_pool_forward(qkv, part, heads, grid, strides[part], *weights[part],
                                      ATTN_POOL_EPS, outs[part])

    def plain():
        return [attn_pool_plain(qkv, part, heads, grid, strides[part], *weights[part],
                                ATTN_POOL_EPS) for part in range(3)]

    cm = [qkv[..., p * dim_out:(p + 1) * dim_out].transpose(1, 2).contiguous().view(
        B * heads, d, *grid) for p in range(3)]

    def library():
        for part in range(3):
            w, nw, nb = weights[part]
            y = F.conv3d(cm[part], w, None, strides[part], 1, 1, d)
            F.layer_norm(y.reshape(-1, heads, d, y[0, 0].numel()).transpose(2, 3), (d,), nw,
                         nb, ATTN_POOL_EPS)

    launch()
    torch.cuda.synchronize()
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        wants = plain()
    errs = []
    for part, (got, want) in enumerate(zip(outs, wants)):
        err = float((got.float() - want.float()).abs().max())
        check(attn_pool_close(got, want), f"attn_pool part {'qkv'[part]} at B={B} {key} "
              f"differs from plain: max |err| {err}")
        errs.append(err)
    del wants
    sides = [mvit.pooled(grid, s) for s in strides]
    n_out = [math.prod(s) for s in sides]
    ref_bytes = (3 * N + sum(n_out)) * dim_out * B * 2
    ops = 2 * 27 * sum(n_out) * dim_out * B

    def touched(n, s):
        rows = {s * i + k for i in range((n - 1) // s + 1) for k in (-1, 0, 1)} & set(range(n))
        return len(rows)

    read = sum(grid[0] * touched(grid[1], s[1]) * touched(grid[2], s[2]) for s in strides)
    touched_bytes = (read + sum(n_out)) * dim_out * B * 2
    r = dict(ms=device_ms(launch), max_abs_err=max(errs),
             **bound(ref_bytes, ops, BF16_TENSOR_FLOPS),
             touched_bound_ms=touched_bytes / HBM_BYTES_PER_S * 1e3,
             plain_ms=cuda_ms(plain, iters=3, warmup=1),
             library_ms=cuda_ms(library, iters=5, warmup=2))
    del qkv, outs, cm
    return r


def attn_pool_phase(dev, rng, smi_line: str) -> dict:
    """Phase 37, MViTv2's attention pools (`csrc/attn_pool.cu`, through
    `ops/attn_pool.py::attn_pool`; it replaces no TPU kernel): each block
    shape of a full-depth request (`attn_pool_blocks`) at B=32 and the
    first at B=2, held and timed (`attn_pool_case`), and the request's sums
    (blocks x each shape's numbers); then one B=32 request of the
    benchmark's `ava_mvitv2_b` detector, built as `benchmark/program.py::
    Server` builds it, every pool held against the plain version at its
    call: 63 launches (`ATTN_POOL_LAUNCHES`). Returns the entry's `shapes`,
    `request` and `launches`."""
    from benchmark import work
    from benchmark.program import Server
    from benchmark.reference import detector as reference
    from step_tpu_torch.ops import attn_pool as ap
    from step_tpu_torch.ops.kernel_op import LAUNCHES

    t37 = time.time()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 37)
    blocks = attn_pool_blocks()
    shapes, request = {}, dict(ms=0.0, bound_ms=0.0, touched_bound_ms=0.0, plain_ms=0.0,
                               library_ms=0.0)
    cases = [(32, key) for key in blocks] + [(2, next(iter(blocks)))]
    for B, key in cases:
        grid, dim_out, heads, q_stride, kv_stride = key
        label = (f"B={B} {'x'.join(map(str, grid))} D={dim_out} h={heads} "
                 f"q {q_stride[1]} kv {kv_stride[1]}")
        r = shapes[label] = attn_pool_case(B, key, gen, dev)
        torch.cuda.empty_cache()
        if B == 32:
            for k in request:
                request[k] += blocks[key] * r[k]
        print(f"[37] attn pools {label} (x{blocks[key]} a request): max |err| "
              f"{r['max_abs_err']:.3g}; kernel {r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of "
              f"the {r['bound_ms']:.4f} ms bound by the counted bytes, "
              f"{r['touched_bound_ms'] / r['ms']:.1%} of {r['touched_bound_ms']:.4f} by the "
              f"touched), plain {r['plain_ms']:.3f}, today's path (library) "
              f"{r['library_ms']:.4f} ms", flush=True)
    print(f"[37] a B=32 request's 63 pools ({smi_line}): kernel {request['ms']:.4f} ms "
          f"({request['bound_ms'] / request['ms']:.1%} of the {request['bound_ms']:.4f} ms "
          f"bound; {request['touched_bound_ms'] / request['ms']:.1%} of "
          f"{request['touched_bound_ms']:.4f} by the touched bytes), plain "
          f"{request['plain_ms']:.2f}, today's path {request['library_ms']:.3f} ms", flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(here, "benchmark", "configs", "ava_mvitv2_b.json")) as f:
        fields = json.load(f)["config"]
    server = Server(fields, work.make_weights(reference.config(fields), SEED + 37, dev), dev)
    cfg = server.cfg
    props, pmask = server.proposals(32)
    clips = [torch.from_numpy(rng.randint(0, 256, (32, cfg.total_frames, cfg.image_size,
                                                   cfg.image_size, 3)).astype(np.uint8)).to(dev)
             for _ in range(2)]
    server.detect(clips[0], props, pmask)       # warm-up
    torch.cuda.synchronize()
    real, errors = ap.attn_pool, []

    def hold(qkv, *args):
        got = real(qkv, *args)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            want = ap.attn_pool_plain(qkv, *args)
        err = float((got.float() - want.float()).abs().max())
        check(attn_pool_close(got, want), f"a pool call at {list(qkv.shape)} differs from "
              f"plain: max |err| {err}")
        errors.append(err)
        return got

    before = LAUNCHES["attn_pool"]
    with swapped(real, hold):
        out = server.detect(clips[1], props, pmask)
        torch.cuda.synchronize()
    n = LAUNCHES["attn_pool"] - before
    check(n == ATTN_POOL_LAUNCHES and len(errors) == n and bool(torch.isfinite(out["tubes"]).all()),
          f"a B=32 request of ava_mvitv2_b launched {n} attention pools ({len(errors)} held), "
          f"not {ATTN_POOL_LAUNCHES}")
    print(f"[37] ava_mvitv2_b B=32: {n} pool launches a request, each held against plain "
          f"(max |err| {max(errors):.3g})", flush=True)
    del server, clips, out
    torch.cuda.empty_cache()
    print(f"    phase 37 took {time.time() - t37:.1f} s", flush=True)
    return dict(launches=n, max_abs_err=max(errors), shapes=shapes, request=request)


def bn_case(shape, gen: torch.Generator) -> dict:
    """K4 at one NCDHW shape: float32 within 1e-6 and bfloat16 within one
    rounding step of the plain version; its bf16 device, wrapper and plain
    times and its bound."""
    from step_tpu_torch import kernels
    from step_tpu_torch.ops.fused_bn_relu import (fused_scale_bias_relu,
                                                  fused_scale_bias_relu_plain)

    C = shape[1]
    x32 = torch.randn(shape, device=gen.device, generator=gen).contiguous(
        memory_format=torch.channels_last_3d)
    scale = torch.rand(C, device=gen.device, generator=gen) * 2 + 0.1
    bias = torch.randn(C, device=gen.device, generator=gen)
    got, want = fused_scale_bias_relu(x32, scale, bias), \
        fused_scale_bias_relu_plain(x32, scale, bias)
    torch.cuda.synchronize()
    err32 = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-6, atol=1e-6),
          f"K4 bn_relu f32 {shape} differs from plain: max |err| {err32}")
    x16 = x32.to(torch.bfloat16)
    del x32, got, want
    got, want = fused_scale_bias_relu(x16, scale, bias), \
        fused_scale_bias_relu_plain(x16, scale, bias)
    torch.cuda.synchronize()
    err16 = float((got.float() - want.float()).abs().max())
    check(got.dtype == torch.bfloat16 and bf16_close(got, want),
          f"K4 bn_relu bf16 {shape} differs from plain: max |err| {err16}")
    x2d, out16 = kernels.ndhwc(x16).reshape(-1, C), torch.empty_like(got)
    return dict(max_abs_err=err16, err32=err32, rows=x2d.shape[0],
                ms=device_ms(lambda: kernels.scale_bias_relu_forward(
                    x2d, scale, bias, kernels.ndhwc(out16).view(-1, C))),
                wrapper_ms=cuda_ms(lambda: fused_scale_bias_relu(x16, scale, bias)),
                plain_ms=cuda_ms(lambda: fused_scale_bias_relu_plain(x16, scale, bias)),
                library_ms=None,
                **bound(2 * x16.numel() * 2 + 2 * C * 4, 3 * x16.numel(), F32_FLOPS))


def conv_case(shape, K: int, rng, dev) -> dict:
    """K3 at one NCDHW input shape and K output channels: float32 within
    1e-4 and bfloat16 (the tensor-core kernel) within one rounding step and
    K3_BF16_ATOL of the plain version; its bf16 device and wrapper times,
    the weight re-layout, cuDNN's bf16 conv with the BN folded plus a ReLU
    (the library's yardstick), the plain version and the bound."""
    from step_tpu_torch import kernels
    from step_tpu_torch.ops.conv3d import (conv3x3x3_bn_relu, conv3x3x3_bn_relu_plain,
                                           pack_conv_weight)

    x32 = randn_cl(rng, shape, dev)
    w = torch.randn(K, shape[1], 3, 3, 3, device=dev) / (27 * shape[1]) ** 0.5
    scale = torch.rand(K, device=dev) + 0.5
    bias = torch.randn(K, device=dev) * 0.1
    got, want = conv3x3x3_bn_relu(x32, w, scale, bias), \
        conv3x3x3_bn_relu_plain(x32, w, scale, bias)
    torch.cuda.synchronize()
    err32 = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
          f"K3 conv f32 {shape}->{K} differs from plain: max |err| {err32}")
    x16, w16 = x32.to(torch.bfloat16), w.to(torch.bfloat16)
    got, want = conv3x3x3_bn_relu(x16, w16, scale, bias), \
        conv3x3x3_bn_relu_plain(x16, w16, scale, bias)
    torch.cuda.synchronize()
    err16 = float((got.float() - want.float()).abs().max())
    check(got.dtype == torch.bfloat16 and bf16_close(got, want, K3_BF16_ATOL),
          f"K3 conv bf16 {shape}->{K} differs from plain: max |err| {err16}")
    packed, out16 = pack_conv_weight(w, torch.bfloat16), torch.empty_like(got)
    cache = {}          # as a Unit3D calls it: its bf16 weight layout cached
    w_fold = (w * scale.view(-1, 1, 1, 1, 1)).to(torch.bfloat16)
    b_fold = bias.to(torch.bfloat16)
    M = shape[0] * int(np.prod(shape[2:]))
    flop = 2 * M * 27 * shape[1] * K
    return dict(
        max_abs_err=err16, err32=err32, flop=flop,
        ms=device_ms(lambda: kernels.conv3x3x3_bn_relu_forward(
            kernels.ndhwc(x16), packed, scale, bias, kernels.ndhwc(out16)), n=10),
        wrapper_ms=cuda_ms(lambda: conv3x3x3_bn_relu(x16, w, scale, bias,
                                                     weight_cache=cache), iters=10),
        plain_ms=cuda_ms(lambda: conv3x3x3_bn_relu_plain(x16, w, scale, bias), iters=10),
        library_ms=cuda_ms(lambda: F.relu_(F.conv3d(x16, w_fold, b_fold, 1, 1)), iters=10),
        pack_ms=cuda_ms(lambda: pack_conv_weight(w, torch.bfloat16)),
        **bound(x16.numel() * 2 + w16.numel() * 2 + M * K * 2 + 2 * K * 4, flop,
                BF16_TENSOR_FLOPS))


def serve(model, cfg, clips, dev, label: str, flows=None) -> dict:
    """Serve each batch size's clips (and `flows`, a two-stream detector's
    second stream) through `detect_clip`, timing each request, and check
    the outputs as a client would read them. Returns {batch: request wall
    ms}."""
    from step_tpu_torch.inference import detect_clip
    from step_tpu_torch.models.detector import STEPDetector

    T, C, P = cfg.total_frames, cfg.num_classes, cfg.max_proposals
    K = min(cfg.max_detections, P)
    walls = {}
    for b, batch in clips.items():
        props, pmask = STEPDetector.initial_proposals(cfg, b, device=dev)
        times = []
        for i, clip in enumerate(batch):
            flow = None if flows is None else flows[b][i].to(dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = detect_clip(model, clip.to(dev), props, pmask, flow)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            shapes = {"tubes": (b, P, T, 4), "tube_scores": (b, P, C),
                      "frame_boxes": (b, T, C, K, 4), "frame_scores": (b, T, C, K),
                      "frame_mask": (b, T, C, K)}
            for key, shape in shapes.items():
                check(tuple(out[key].shape) == shape,
                      f"{label}: {key} shape {tuple(out[key].shape)}, expected {shape}")
                check(bool(torch.isfinite(out[key]).all()), f"{label}: {key} not finite")
            check(float(out["tube_scores"][:, cfg.num_proposals:].abs().max()) == 0.0,
                  f"{label}: padding proposals scored")
            check(bool(((out["tubes"] >= 0) & (out["tubes"] <= cfg.image_size)).all()),
                  f"{label}: tubes outside the image")
        print(f"    B={b}: request wall ms {', '.join(f'{t:.2f}' for t in times)} "
              f"(first warms up); {int(out['frame_mask'].sum())} survivors in the "
              f"last", flush=True)
        walls[b] = times
    return walls


def bf16_close(got: torch.Tensor, want: torch.Tensor, atol: float = 1e-5) -> bool:
    """Within one bf16 rounding step of each other."""
    return torch.allclose(got.float(), want.float(), rtol=BF16_RTOL, atol=atol)


def k3_close(got, want, x, weight, scale) -> bool:
    """K3's output against its plain version on the inputs x, weight and
    scale: float32 within 1e-4; bfloat16 within one rounding step, 2^-15,
    and K3_BF16_SUM_RTOL of the sum of |x * w| * |scale| each output adds
    up (its accumulation drift)."""
    if got.dtype == torch.float32:
        return torch.allclose(got, want, rtol=1e-4, atol=1e-4)
    w = weight.to(x.dtype).float().abs()
    terms = F.conv3d(x.float().abs(), w, None, 1, 1) * scale.abs().view(1, -1, 1, 1, 1)
    err = (got.float() - want.float()).abs()
    return bool((err <= BF16_RTOL * want.float().abs() + K3_BF16_ATOL
                 + K3_BF16_SUM_RTOL * terms).all())


def median_wall_ms(fn, runs: int = VIDEO_RUNS):
    """(median, all) wall ms of `runs` calls of `fn`, each ending in a
    synchronize, after one warm-up call."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), times


def device_work(event) -> bool:
    """A profile's kernel or copy on the card, not a span's range there
    (the port's spans are ranges on the device too while a profiler
    records)."""
    return (event.device_type == torch.autograd.DeviceType.CUDA
            and not event.is_user_annotation)


def cuda_kernels_in(fn) -> int:
    """The CUDA kernels one call of `fn` launches, counted by torch.profiler."""
    return profiled(fn)[0]


def profiled(fn) -> tuple[int, float]:
    """(CUDA kernels, their summed device ms) of one call of `fn`, from
    torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if device_work(e)]
    return (sum(e.count for e in events),
            sum(e.self_device_time_total for e in events) / 1e3)


def check_links(det, C: int, K: int, L: int, label: str) -> None:
    """detect_video's link outputs: shapes, finite values, and the emitted
    (trimmed-in) nodes of each class disjoint in every clip."""
    for key in ("link_paths", "link_trim"):
        check(tuple(det[key].shape) == (C, K, L),
              f"{label}: {key} shape {tuple(det[key].shape)}, expected {(C, K, L)}")
    for key in ("link_scores", "link_trim", "link_tube_scores"):
        check(bool(torch.isfinite(det[key]).all()), f"{label}: {key} not finite")
    paths, trim = det["link_paths"].cpu().numpy(), det["link_trim"].cpu().numpy()
    for c in range(C):
        for l in range(L):
            emitted = paths[c, trim[c, :, l] > 0, l]
            check(len(set(emitted.tolist())) == len(emitted),
                  f"{label}: class {c} clip {l} emits node(s) {emitted.tolist()} twice")


@contextlib.contextmanager
def recorded(fn, key, keep: bool = False):
    """The calls of the kernel wrapper `fn` while the block runs, as the
    port's modules make them: yields {key(*args): [launches, calls]}, where
    launches is the kernels those calls launched (`launched()`) and calls
    lists each call's (args, output) when `keep`. `fn` is replaced by a
    recorder in every module of the port that holds it (`swapped`)."""
    calls = {}

    def rec(*args, **kwargs):
        before = launched()
        got = fn(*args, **kwargs)
        entry = calls.setdefault(key(*args), [0, []])
        entry[0] += launched() - before
        if keep:
            entry[1].append((args, got))
        return got

    with swapped(fn, rec):
        yield calls


def launched() -> int:
    """Every kernel launch the port has counted, of all operators
    (`step_tpu_torch/ops/kernel_op.py::LAUNCHES`)."""
    from step_tpu_torch.ops.kernel_op import LAUNCHES

    return sum(LAUNCHES.values())


@contextlib.contextmanager
def swapped(fn, replacement):
    """`fn` replaced by `replacement` in every module of the port that
    holds it, under whatever name, while the block runs."""
    homes = [(m, attr) for name, m in list(sys.modules.items())
             if name.split(".")[0] == "step_tpu_torch"
             for attr, value in list(vars(m).items()) if value is fn]
    for m, attr in homes:
        setattr(m, attr, replacement)
    try:
        yield
    finally:
        for m, attr in homes:
            setattr(m, attr, fn)


@contextlib.contextmanager
def call_count(fn):
    """Yields a one-element list: the calls of `fn` the port's modules make
    while the block runs."""
    n = [0]

    def counting(*args, **kwargs):
        n[0] += 1
        return fn(*args, **kwargs)

    with swapped(fn, counting):
        yield n


def shape_of(x, *_):
    return tuple(x.shape)


def hold_nms_calls(path: str, calls: dict, out: dict) -> None:
    """K1 as `path` launched it: each recorded `nms_surface` call against
    `nms_surface_plain` on the same tubes, scores, mask and config, by raw
    bits; per shape, its launches on the path, its device time on the first
    call's inputs, the plain version's time and the bound."""
    from step_tpu_torch import kernels
    from step_tpu_torch.inference import nms_surface_plain
    from step_tpu_torch.ops.nms import _f32, kernel_valid

    for shape, (launches, kept) in calls.items():
        for args, got in kept:
            want = nms_surface_plain(*args)
            for key in ("frame_boxes", "frame_scores", "frame_mask"):
                check(torch.equal(raw_bits(got[key]), raw_bits(want[key])),
                      f"K1 nms_surface on {path} at {list(shape)} differs from plain "
                      f"in {key}")
        (tubes, scores, pmask, cfg), got = kept[0]
        B, P, T = tubes.shape[:3]
        C = scores.shape[-1]
        buf = {key: torch.empty_like(v) for key, v in got.items() if key.startswith("frame")}
        ms = device_ms(lambda: kernels.nms_many_forward(
            tubes.transpose(1, 2), scores[:, None].expand(B, T, P, C),
            kernel_valid(pmask)[:, None].expand(B, T, P), buf["frame_mask"],
            _f32(cfg.nms_thresh), _f32(cfg.score_thresh), out_boxes=buf["frame_boxes"],
            out_scores=buf["frame_scores"]))
        plain_ms = cuda_ms(lambda: nms_surface_plain(*kept[0][0]), iters=3, warmup=1)
        b = bound(tubes.numel() * 4 + scores.numel() * scores.element_size()
                  + pmask.numel() * 4 + got["frame_mask"].numel() * 24,
                  float(got["frame_mask"].sum()) * P * 13, F32_FLOPS)
        out[f"{path} surface {list(shape)}"] = dict(
            launches=launches, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
            library_ms=None, **b)
        print(f"    K1 on {path}, surface {list(shape)} ({B * T * C} problems) x{launches}: "
              f"all {len(kept)} calls the plain version's bits; kernel device {ms:.4f} ms "
              f"({b['bound_ms'] / ms:.1%} of the {b['bound_ms']:.6f} ms bound), plain "
              f"{plain_ms:.3f} ms", flush=True)


def hold_roi_calls(path: str, calls: dict, out: dict) -> None:
    """K2 as `path` launched it: each recorded `tube_roi_align` call against
    `tube_roi_align_plain` on the same features, tubes and settings (float32
    within 1e-4, bfloat16 within one rounding step); per feature shape, its
    launches on the path, its device time on the first call's inputs, the
    plain version's time and the bound."""
    from step_tpu_torch import kernels
    from step_tpu_torch.ops.roi_align import tube_roi_align_plain

    for shape, (launches, kept) in calls.items():
        err = 0.0
        for args, got in kept:
            want = tube_roi_align_plain(*args)
            e = float((got.float() - want.float()).abs().max())
            err = max(err, e)
            ok = (bf16_close(got, want) if got.dtype == torch.bfloat16
                  else torch.allclose(got, want, rtol=1e-4, atol=1e-4))
            check(ok and got.dtype == want.dtype,
                  f"K2 roi_align on {path} at {list(shape)} {got.dtype} differs from "
                  f"plain: max |err| {e}")
        (feat, tubes, _, scale, ratio), got = kept[0]
        tubes32, buf = tubes.to(torch.float32).contiguous(), torch.empty_like(got)
        ms = device_ms(lambda: kernels.tube_roi_align_forward(feat, tubes32, buf, scale,
                                                               ratio))
        plain_ms = cuda_ms(lambda: tube_roi_align_plain(*kept[0][0]), iters=5)
        b = bound(feat.numel() * feat.element_size() + tubes.numel() * 4
                  + got.numel() * got.element_size(), got.numel() * ratio ** 2 * 8,
                  F32_FLOPS)
        out[f"{path} {list(shape)}"] = dict(
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            library_ms=None, **b)
        print(f"    K2 on {path}, features {list(shape)} {feat.dtype} x{launches}: all "
              f"{len(kept)} calls within tolerance of plain (max |err| {err:.3g}); kernel "
              f"device {ms:.4f} ms ({b['bound_ms'] / ms:.1%} of the {b['bound_ms']:.4f} ms "
              f"bound), plain {plain_ms:.4f} ms", flush=True)


def video_phases(dev, rng, seeded, reset_counts, read_counts) -> dict:
    """Phases 12 and 13, the streaming preset's video path. Returns, per
    kernel, its launches on each video path and its numbers at the shapes
    each path gave it, for the JSON line."""
    from step_tpu_torch import PRESETS
    from step_tpu_torch.inference import (detect_clip, detect_video, detect_video_stream,
                                          detect_video_stream_batched, link_video,
                                          window_centers)
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.ops.conv3d import conv3x3x3_bn_relu
    from step_tpu_torch.ops.fused_bn_relu import fused_scale_bias_relu
    from step_tpu_torch.ops.pool import max_pool3x3_same
    from step_tpu_torch.ops.roi_align import tube_roi_align, tube_roi_align_plain

    out = {name: dict(video_launches={}, video_shapes={}) for name in KERNELS}
    scfg = PRESETS["streaming"]
    C, K, P, T = scfg.num_classes, scfg.link_tubes_per_class, scfg.max_proposals, \
        scfg.total_frames
    c, n = scfg.frames_per_chunk, VIDEO_CHUNKS

    def held(path: str, run):
        """`held_run` on the video path: K1 and K2 must both launch."""
        result, counts, _ = held_run(path, run, reset_counts, read_counts, out, "video")
        for name in ("nms_many", "tube_roi_align"):
            check(counts[name] > 0, f"{path}: kernel {name} never launched")
        return result, counts

    # ---- 12. detect_video on the 48 windows, bf16, the main path's tree --
    t0 = t12 = time.time()
    model = served_model(scfg, seeded, dev)
    video = torch.from_numpy(rng.randint(0, 256, (n * c, scfg.image_size, scfg.image_size,
                                                  3)).astype(np.uint8)).to(dev)
    clips = video.reshape(n, c, *video.shape[1:])[window_centers(n, scfg, device=dev)]
    clips = clips.reshape(n, T, *video.shape[1:])   # [48, 18, 224, 224, 3]
    print(f"[12] streaming preset, full width, BN folded, {scfg.compute_dtype}: a "
          f"{n * c}-frame uint8 video, {n} windows one chunk apart; built in "
          f"{time.time() - t0:.1f} s", flush=True)
    pmask = STEPDetector.initial_proposals(scfg, n, device="cpu")[1]
    for stride in (c, None):
        label = f"detect_video_stride_{stride}"
        torch.cuda.reset_peak_memory_stats(dev)
        det, counts = held(label, lambda: detect_video(model, clips, tiling_stride=stride))
        check_links(det, C, K, n, label)
        check(bool(torch.isfinite(det["tubes"]).all()
                   and torch.isfinite(det["tube_scores"]).all()), f"{label}: not finite")
        # the same linking on the CPU, on the same tubes and scores
        ref = link_video(det["tubes"].cpu(), det["tube_scores"].cpu(), pmask, scfg,
                         stride=stride)
        for key, mine in (("link_paths", "paths"), ("link_trim", "trim")):
            check(torch.equal(det[key].cpu(), ref[mine]),
                  f"{label}: {key} on the card differs from the CPU's in "
                  f"{int((det[key].cpu() != ref[mine]).sum())} places")
        d_link = max(float((det[key].cpu() - ref[mine]).abs().max()) for key, mine in
                     (("link_scores", "values"), ("link_tube_scores", "tube_scores")))
        check(d_link <= LINK_VALUE_TOL, f"{label}: link values on the card differ from "
              f"the CPU's by {d_link}")
        alive = int((det["link_tube_scores"] > 0).sum())
        print(f"[12] {label}: launches {counts}; links [{C}, {K}, {n}] finite, "
              f"node-disjoint, equal to the CPU's (values within {d_link:.3g}); "
              f"{alive} of {C * K} video tubes alive; peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)

    tubes, scores = det["tubes"], det["tube_scores"]
    video_ms, video_runs = median_wall_ms(lambda: detect_video(model, clips, tiling_stride=c))
    pmask = pmask.to(dev)
    link_fn = lambda: link_video(tubes, scores, pmask, scfg, stride=c)  # noqa: E731
    link_ms, link_runs = median_wall_ms(link_fn)
    link_kernels = cuda_kernels_in(link_fn)
    print(f"[12] per-video wall, median of {VIDEO_RUNS}: detect_video over {n} windows "
          f"{video_ms:.2f} ms ({', '.join(f'{t:.2f}' for t in video_runs)}); its linking "
          f"alone {link_ms:.2f} ms ({', '.join(f'{t:.2f}' for t in link_runs)}), "
          f"{link_kernels} kernel launches (profiler)", flush=True)
    del det, clips, tubes, scores
    print(f"    phase 12 took {time.time() - t12:.1f} s", flush=True)

    # ---- 13. the chunk-stem cache on the same video -----------------------
    t13 = time.time()
    ccfg = scfg.replace(chunk_stem=True)
    cmodel = served_model(ccfg, seeded, dev)
    sdet, counts = held("stream_batched", lambda: detect_video_stream_batched(
        cmodel, video, clip_batch=STREAM_BATCH))
    sk = min(scfg.max_detections, P)
    shapes = {"tubes": (n, P, T, 4), "tube_scores": (n, P, C),
              "frame_mask": (n, T, C, sk)}
    for key, shape in shapes.items():
        check(tuple(sdet[key].shape) == shape,
              f"stream batched: {key} shape {tuple(sdet[key].shape)}, expected {shape}")
        check(bool(torch.isfinite(sdet[key]).all()), f"stream batched: {key} not finite")
    print(f"[13] detect_video_stream_batched, chunk stems, clip_batch={STREAM_BATCH} "
          f"({-(-n // STREAM_BATCH)} batches): outputs [{n}, ...] finite; launches "
          f"{counts}", flush=True)
    live, counts = held("stream", lambda: detect_video_stream(cmodel, video[:4 * c]))
    check(len(live) == 4 and all(bool(torch.isfinite(o["tube_scores"]).all()) for o in live),
          "detect_video_stream over 4 chunks: not 4 finite results")
    print(f"[13] detect_video_stream over 4 chunks: 4 finite results; launches {counts}",
          flush=True)
    stream_ms, stream_runs = median_wall_ms(
        lambda: detect_video_stream_batched(cmodel, video, clip_batch=STREAM_BATCH))
    print(f"[13] per-video wall, median of {VIDEO_RUNS}: detect_video_stream_batched "
          f"{stream_ms:.2f} ms ({', '.join(f'{t:.2f}' for t in stream_runs)}), against "
          f"detect_video {video_ms:.2f} ms", flush=True)
    del cmodel, model, sdet, live

    # float32, TF32 off: both streams against detect_clip on the window
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on")
    fcfg = ccfg.replace(compute_dtype="float32")
    fmodel = served_model(fcfg, seeded, dev)
    first = video[:4 * c]
    live = detect_video_stream(fmodel, first)
    batched = detect_video_stream_batched(fmodel, first, clip_batch=3)   # 3 + 1
    props, pm1 = STEPDetector.initial_proposals(ccfg, 1, device=dev)
    worst = [0.0, 0.0]
    for center, ids in ((1, [0, 1, 2]), (0, [0, 0, 1]), (3, [2, 3, 3])):
        ref = detect_clip(fmodel, torch.cat([first[i * c:(i + 1) * c] for i in ids])[None],
                          props, pm1)
        for form, got in (("stream", live[center]),
                          ("batched", {k: v[center:center + 1] for k, v in batched.items()})):
            d_s = float((got["tube_scores"] - ref["tube_scores"]).abs().max())
            d_t = float((got["tubes"] - ref["tubes"]).abs().max())
            worst = [max(worst[0], d_s), max(worst[1], d_t)]
            check(d_s <= STREAM_SCORE_TOL and d_t <= STREAM_TUBE_TOL,
                  f"f32 {form} window {ids} differs from detect_clip: scores {d_s}, "
                  f"tubes {d_t} px")
    print(f"[13] f32 streams against detect_clip at windows [0,1,2], [0,0,1] and "
          f"[2,3,3]: scores max |d| {worst[0]:.3g} (tol {STREAM_SCORE_TOL}), tubes "
          f"{worst[1]:.3g} px (tol {STREAM_TUBE_TOL})", flush=True)
    del live, batched

    # K2 at T'=6 with boxes partly and wholly outside the map and zero-area
    # boxes, which the detector's tubes never hold
    feat_np, tubes_np = roi_inputs(rng, STREAM_BATCH, 6, 14, 832, P, T, scfg.image_size)
    feat32, rtubes = torch.from_numpy(feat_np).to(dev), torch.from_numpy(tubes_np).to(dev)
    args = (scfg.pooled_size, 1.0 / scfg.feature_stride, scfg.sampling_ratio)
    got, want = tube_roi_align(feat32, rtubes, *args), tube_roi_align_plain(feat32, rtubes, *args)
    err32 = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
          f"K2 at T'=6 float32 differs from plain: max |err| {err32}")
    feat16 = feat32.to(torch.bfloat16)
    got, want = tube_roi_align(feat16, rtubes, *args), tube_roi_align_plain(feat16, rtubes, *args)
    err16 = float((got.float() - want.float()).abs().max())
    check(got.dtype == torch.bfloat16 and bf16_close(got, want),
          f"K2 at T'=6 bfloat16 differs from plain: max |err| {err16}")
    print(f"[13] K2 roi_align at [{STREAM_BATCH},6,14,14,832], boxes outside the map and "
          f"zero-area: max |err| f32 {err32:.3g} (tol 1e-4), bf16 {err16:.3g} (one bf16 "
          f"step)", flush=True)
    del feat32, feat16, got, want

    # The kernel configuration with chunk stems at B=2: K3, K4 and K5 at
    # T = 3 and 2, and the tail at T' = 6; each launch recorded by shape.
    kcfg = ccfg.replace(fused_bn_relu=True)
    props, pm2 = STEPDetector.initial_proposals(kcfg, 2, device=dev)
    clips2 = video[:2 * T].reshape(2, T, *video.shape[1:])

    def kernel_path(cfg):
        model = STEPDetector(cfg).eval()
        model.load_state_dict(seeded)
        return detect_clip(model.to(dev), clips2, props, pm2)

    wrappers = (("conv3x3x3_bn_relu", conv3x3x3_bn_relu,
                 lambda x, w, *_: (tuple(x.shape), w.shape[0])),
                ("fused_scale_bias_relu", fused_scale_bias_relu, shape_of),
                ("max_pool3x3_same", max_pool3x3_same, shape_of))
    reset_counts()
    with contextlib.ExitStack() as stack:
        seen = {name: stack.enter_context(recorded(fn, key)) for name, fn, key in wrappers}
        kdet = kernel_path(kcfg)
        torch.cuda.synchronize()
    counts = read_counts()
    check(bool(torch.isfinite(kdet["tube_scores"]).all()), "chunk-stem kernel path: not finite")
    k4s, k5s, k3s = backbone_launches(kcfg, 2)
    for name, listed in (("conv3x3x3_bn_relu", k3s), ("fused_scale_bias_relu", k4s),
                         ("max_pool3x3_same", k5s)):
        measured = {shape: v[0] for shape, v in seen[name].items()}
        check(counts[name] > 0 and counts[name] == sum(measured.values()),
              f"chunk-stem kernel path: {counts[name]} {name} launches, "
              f"{sum(measured.values())} recorded")
        check(measured == listed, f"chunk-stem kernel path: {name} launched {measured} "
              f"by shape, backbone_launches lists {listed}")
        out[name]["video_launches"]["chunk_stem_kernel_path"] = counts[name]
    print(f"[13] kernel configuration, chunk stems, B=2 (N={2 * kcfg.num_chunks} chunks): "
          f"launches {counts}, by shape as backbone_launches lists", flush=True)
    # float32: the chunk-stem kernel configuration against the main path's
    # chunk-stem tree on the same clips, as phase 11 holds the clip path
    got = kernel_path(fcfg.replace(fused_bn_relu=True))
    want = detect_clip(fmodel, clips2, props, pm2)
    torch.cuda.synchronize()
    d_scores = float((got["tube_scores"] - want["tube_scores"]).abs().max())
    d_tubes = float((got["tubes"] - want["tubes"]).abs().max())
    print(f"[13] f32 B=2 chunk-stem kernel path vs main path: tube scores max |d| "
          f"{d_scores:.3g} (tol {PATH_SCORE_TOL}), tubes {d_tubes:.3g} px "
          f"(tol {PATH_TUBE_TOL})", flush=True)
    check(d_scores <= PATH_SCORE_TOL and d_tubes <= PATH_TUBE_TOL,
          f"chunk-stem kernel path differs from the main path: scores {d_scores}, "
          f"tubes {d_tubes} px")
    del kdet, fmodel, got, want
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    for name, listed, case in (("max_pool3x3_same", k5s, lambda sh: pool_case(sh, gen)),
                               ("fused_scale_bias_relu", k4s, lambda sh: bn_case(sh, gen)),
                               ("conv3x3x3_bn_relu", k3s,
                                lambda sh: conv_case(sh[0], sh[1], rng, dev))):
        total = dict(ms=0.0, bound_ms=0.0)
        for shape, (launches, _) in seen[name].items():
            r = case(shape)
            total["ms"] += launches * r["ms"]
            total["bound_ms"] += launches * r["bound_ms"]
            out[name]["video_shapes"][f"chunk_stem_kernel_path {shape}"] = dict(
                ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                max_abs_err=r["max_abs_err"], bound_ms=r["bound_ms"],
                bound_by=r["bound_by"], launches=launches)
            print(f"    {name} {shape} x{launches}: held against plain (max |err| "
                  f"{r['max_abs_err']:.3g}); bf16 device {r['ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%}), plain "
                  f"{r['plain_ms']:.4f} ms", flush=True)
        print(f"[13] {name} at every chunk-stem shape ({len(listed)} shapes, "
              f"{sum(listed.values())} launches): within tolerance of plain; device "
              f"{total['ms']:.4f} ms a B=2 request, bound {total['bound_ms']:.4f} ms",
              flush=True)
    print(f"    phase 13 took {time.time() - t13:.1f} s", flush=True)
    return out


def far_weights(got: dict, want: dict, lr: float, names) -> tuple[int, int, float]:
    """(elements beyond 1e-5, elements, max |d|) between two state_dicts
    over `names`; fatal if any element is more than 2 lr apart."""
    far = total = 0
    worst = 0.0
    for name in names:
        d = (got[name].float().cpu() - want[name].float().cpu()).abs()
        worst = max(worst, float(d.max()))
        far += int((d > 1e-5).sum())
        total += d.numel()
    check(worst <= 2 * lr * (1 + 1e-3), f"a weight moved {worst} apart, more than 2 lr")
    return far, total, worst


def fixed_batch_steps(state, batch, cfg, n: int = 8):
    """`n` train_steps on one batch already on the card, no loader running:
    (losses, each step's ms between CUDA events)."""
    from step_tpu_torch.train.trainer import train_step

    losses, ms = [], []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        loss = train_step(state, batch, cfg)[1]["loss"]
        end.record()
        losses.append(float(loss))
        ms.append(start.elapsed_time(end))
    return losses, ms


def training_phases(dev, rng, reset_counts, read_counts) -> dict:
    """Phases 14 and 15, the training path. Returns, per kernel, its
    launches a training step and, for K2 and K5, the device time of the
    plain backward, for the JSON line."""
    import tempfile

    from step_tpu_torch.data.pipeline import build_model_batch
    from step_tpu_torch.data.synthetic import SyntheticConfig, make_batch
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.models.i3d import max_pool_3d
    from step_tpu_torch.ops.pool_grad import max_pool_s1_backward
    from step_tpu_torch.ops.roi_align import (tube_roi_align, tube_roi_align_backward,
                                              tube_roi_align_plain)
    from step_tpu_torch.train.trainer import (batch_to_device, create_train_state,
                                              make_schedule, train_step)
    from step_tpu_torch.utils.checkpoint import checkpoint_steps, restore_checkpoint
    from step_tpu_torch.utils.init import init_detector_train_

    # ---- 14. training at full width --------------------------------------
    cfg = train_cfg("ucf_3step", TRAIN_BATCH)
    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=4)
    t0 = time.time()
    model = init_detector_train_(STEPDetector(cfg), cfg, SEED)
    # Step 1's gradient of every backbone parameter, kept on the card.
    first_grads = first_grad_hooks(model.features)
    reset_counts()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        state, steps, memory = timed_fit(
            dict(cfg=cfg, loader=synthetic_loader(cfg, TRAIN_STEPS), num_epochs=1,
                 ckpt_dir=ckpt_dir, ckpt_every=TRAIN_STEPS // 2, model=model, device=dev,
                 seed=SEED), read_counts)
        saved = checkpoint_steps(ckpt_dir)
        check(TRAIN_STEPS // 2 in saved and TRAIN_STEPS in saved,
              f"checkpoints at steps {saved}, expected {TRAIN_STEPS // 2} and "
              f"{TRAIN_STEPS}")
        fresh = create_train_state(cfg, seed=SEED + 1, device=dev)
        fresh, data_iter = restore_checkpoint(ckpt_dir, fresh, step=TRAIN_STEPS // 2)
        check(fresh.step == TRAIN_STEPS // 2
              and data_iter == {"epoch": 0, "batch_index": TRAIN_STEPS // 2},
              f"checkpoint {TRAIN_STEPS // 2} restored step {fresh.step}, {data_iter}")
        del fresh
    check(len(steps) == TRAIN_STEPS and state.step == TRAIN_STEPS,
          f"fit ran {len(steps)} steps, state at {state.step}, expected {TRAIN_STEPS}")
    norms = [float(m["grad_norm"]) for _, _, m in steps]
    features = [n for n, _ in model.features.named_parameters()]
    check(sorted(first_grads) == sorted(features),
          f"{len(features) - len(first_grads)} backbone parameters got no gradient at step 1")
    zero = [n for n in features if not bool(first_grads[n])]
    check(not zero, f"backbone parameters with an all-zero gradient at step 1: {zero[:5]}")
    median_ms, per_step, summary = step_summary(steps)
    for name in ("tube_roi_align", "max_pool3x3_same"):
        check(min(per_step[name]) > 0, f"{name} did not launch in every training step: "
                                       f"{per_step[name]}")
    print(f"[14] training ucf_3step full width, bf16, B={cfg.batch_size}, remat "
          f"{cfg.remat_policy}, AdamW, {TRAIN_STEPS} fit() steps from the DataLoader: "
          f"built and ran in {time.time() - t0:.1f} s; {summary}; median of the last 8 "
          f"{median_ms:.2f} ms ({cfg.batch_size / median_ms * 1e3:.1f} clips/s); {memory}",
          flush=True)
    print(f"    grad_norm {', '.join(f'{v:.3g}' for v in norms)}", flush=True)
    print(f"    launches a step: {per_step}; all {len(features)} backbone parameters "
          f"have a nonzero gradient at step 1; checkpoints {saved}, step "
          f"{TRAIN_STEPS // 2} restored", flush=True)

    # 8 steps on one fixed batch lower the loss.
    raw = make_batch(SEED * 1000 + 10 ** 6, cfg.batch_size, syn)
    fixed = batch_to_device(build_model_batch(raw, cfg, train=True, emit_uint8=True), dev)
    fixed_losses, fixed_ms = fixed_batch_steps(state, fixed, cfg)
    check(fixed_losses[-1] < fixed_losses[0],
          f"8 steps on one batch did not lower the loss: {fixed_losses}")
    print(f"    8 steps on one batch: loss {', '.join(f'{v:.3f}' for v in fixed_losses)}; "
          f"step ms without the loader, median {float(np.median(fixed_ms)):.2f}",
          flush=True)
    del state, model

    # Each backward alone, at the shapes of a training step.
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    tail = torch.randn((128, 832, 5, 7, 7), device=dev, generator=gen,
                       dtype=torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    g_tail = torch.randn_like(tail)
    pool_bwd_ms = device_ms(lambda: max_pool_s1_backward(tail, g_tail, (3, 3, 3)))
    pool_bwd_bound = bound(3 * tail.numel() * 2, 0, F32_FLOPS)
    B, Tp, Hf = cfg.batch_size, 5, cfg.image_size // cfg.feature_stride
    feat_np, tubes_np = roi_inputs(rng, B, Tp, Hf, 832, cfg.max_proposals,
                                   cfg.total_frames, cfg.image_size)
    feat16 = torch.from_numpy(feat_np).to(dev, torch.bfloat16)
    tubes = torch.from_numpy(tubes_np).to(dev)
    args = (cfg.pooled_size, 1.0 / cfg.feature_stride, cfg.sampling_ratio)
    g_roi = torch.randn((B, cfg.max_proposals, Tp, 7, 7, 832), device=dev,
                        generator=gen, dtype=torch.bfloat16)
    roi_bwd_ms = device_ms(lambda: tube_roi_align_backward(feat16, tubes, g_roi, *args))
    roi_bwd_bound = bound(g_roi.numel() * 2 + tubes.numel() * 4 + feat16.numel() * 2, 0,
                          F32_FLOPS)
    print(f"    plain backwards alone (device): pool [128,832,5,7,7] bf16 "
          f"{pool_bwd_ms:.4f} ms (bytes bound {pool_bwd_bound['bound_ms']:.4f} ms); "
          f"ROI-align [{B},{Tp},{Hf},{Hf},832] bf16 {roi_bwd_ms:.4f} ms (bytes bound "
          f"{roi_bwd_bound['bound_ms']:.4f} ms)", flush=True)

    # ---- 15. kernels under autograd against plain, on the card -----------
    feat32 = torch.from_numpy(feat_np).to(dev)
    for f, tol in ((feat32, 1e-4), (feat16, None)):
        fk = f.detach().requires_grad_()
        fp = f.detach().requires_grad_()
        out_k = tube_roi_align(fk, tubes, *args)
        out_p = tube_roi_align_plain(fp, tubes, *args)
        check(out_k.grad_fn is not None, "K2 under autograd returned no grad_fn")
        g = torch.randn(out_p.shape, device=dev, generator=gen).to(f.dtype)
        out_k.backward(g)
        out_p.backward(g)
        torch.cuda.synchronize()
        errs = [float((a.detach().float() - b.detach().float()).abs().max())
                for a, b in ((out_k, out_p), (fk.grad, fp.grad))]
        ok = all((torch.allclose(a, b, rtol=tol, atol=tol) if tol else bf16_close(a, b))
                 for a, b in ((out_k.detach(), out_p.detach()), (fk.grad, fp.grad)))
        check(ok, f"K2 under autograd {f.dtype} differs from plain: out {errs[0]}, "
                  f"dfeatures {errs[1]}")
        print(f"[15] K2 under autograd, {f.dtype}, [{B},{Tp},{Hf},{Hf},832]: out max |err| "
              f"{errs[0]:.3g}, dfeatures {errs[1]:.3g} "
              f"({'tol 1e-4' if tol else 'one bf16 step'})", flush=True)
    for shape, window, stride in (((128, 832, 5, 7, 7), (3, 3, 3), (1, 1, 1)),
                                  ((8, 192, 9, 28, 28), (3, 3, 3), (1, 1, 1)),
                                  ((2, 64, 9, 112, 112), (1, 3, 3), (1, 2, 2)),
                                  ((2, 480, 9, 28, 28), (3, 3, 3), (2, 2, 2))):
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randint(0, 3, shape, device=dev, generator=gen).to(dtype).contiguous(
                memory_format=torch.channels_last_3d)
            grads = []
            for d in (dev, "cpu"):
                xd = x.to(d).detach().requires_grad_()
                y = max_pool_3d(xd, window, stride)
                g = torch.arange(y.numel(), device=d).reshape(y.shape).remainder(7).sub(3)
                y.backward(g.to(dtype))
                grads.append((y.detach().cpu(), xd.grad.cpu()))
            same = all(torch.equal(raw_bits(a), raw_bits(b))
                       for a, b in zip(grads[0], grads[1]))
            check(same, f"pool {window}/{stride} {list(shape)} {dtype}: the card's "
                        f"forward or backward differs from the CPU's on ties")
        print(f"[15] pool {window} stride {stride} {list(shape)}, integer inputs (ties): "
              f"forward and backward on the card equal the CPU's bit for bit, f32 and "
              f"bf16", flush=True)

    tiny = cfg.replace(backbone_depth="tiny", feature_stride=8, image_size=64,
                       compute_dtype="float32", batch_size=2, dropout_rate=0.0,
                       max_gt_tubes=2)
    tsyn = SyntheticConfig(image_size=64, num_frames=tiny.total_frames,
                           num_classes=tiny.num_classes, max_boxes=2)
    tbatch = build_model_batch(make_batch(SEED, 2, tsyn), tiny, train=True)
    runs = []
    for d in (dev, "cpu"):
        st = create_train_state(tiny, seed=SEED, device=d)
        b = batch_to_device(tbatch, d)
        ms = [train_step(st, b, tiny)[1] for _ in range(2)]
        runs.append(([{k: v.cpu() for k, v in m.items()} for m in ms],
                     {k: v.cpu() for k, v in st.model.state_dict().items()}))
    (m_gpu, sd_gpu), (m_cpu, sd_cpu) = runs
    for a, b in zip(m_gpu, m_cpu):
        check(torch.allclose(a["loss"], b["loss"], rtol=1e-5, atol=0),
              f"tiny train_step loss on the card {float(a['loss'])}, CPU {float(b['loss'])}")
    lr = make_schedule(tiny)(1)
    weights = [k for k in sd_cpu if "running_" not in k]
    stats = [k for k in sd_cpu if "running_" in k]
    far, total, worst = far_weights(sd_gpu, sd_cpu, lr, weights)
    check(far <= 1e-3 * total, f"tiny train_step: {far} of {total} weights beyond 1e-5")
    stat_err = max(float((sd_gpu[k] - sd_cpu[k]).abs().max()) for k in stats)
    check(stat_err <= 1e-4, f"tiny train_step BN statistics differ by {stat_err}")
    print(f"[15] tiny f32 train_step (AdamW, 2 steps) card vs CPU: loss max rel "
          f"{max(float((a['loss'] - b['loss']).abs() / b['loss'].abs()) for a, b in zip(m_gpu, m_cpu)):.3g} "
          f"(tol 1e-5); weights: {far} of {total} beyond 1e-5 (tol 0.1%), max |d| "
          f"{worst:.3g} (tol 2 lr = {2 * lr:.3g}); BN statistics {stat_err:.3g} (tol 1e-4)",
          flush=True)

    out = {name: dict(train_launches=max(per_step[name])) for name in per_step}
    out["tube_roi_align"]["train_backward_ms"] = roi_bwd_ms
    out["max_pool3x3_same"]["train_backward_ms"] = pool_bwd_ms
    return out


def check_eval_results(results: dict, label: str) -> None:
    """`evaluate_ucf`'s result: every key, each mAP in [0, 1] or NaN, and
    detections found."""
    maps = ("frame_mAP@0.5", "video_mAP@0.2", "video_mAP@0.5", "video_mAP@0.5:0.95")
    timing_keys = ("collect_s", "dedupe_s", "frame_map_s", "link_s", "video_map_s",
                   "n_detections", "n_tubes", "peak_rss_mb")
    for key in maps:
        check(key in results, f"{label}: no {key} in {sorted(results)}")
        v = float(results[key])
        check(np.isnan(v) or 0.0 <= v <= 1.0, f"{label}: {key} = {v} outside [0, 1]")
    missing = [k for k in timing_keys if k not in results.get("timings", {})]
    check(not missing, f"{label}: timings lack {missing}")
    check(results["timings"]["n_detections"] > 0, f"{label}: no detections")


def same_tubes(got: list, want: list, label: str):
    """Two linkers' outputs `[(video, cls, score, {frame: box})]` as the
    same tubes: per (video, class) the same number, each of `got` matched
    to its own tube of `want` with the same frames, boxes within
    EVAL_TUBE_TOL px and a score within EVAL_SCORE_TOL (the order may
    differ where scores tie within float noise). Returns the tube count and
    the largest box and score differences of the matching."""
    groups: dict = {}
    for side, tubes in enumerate((got, want)):
        for video, c, score, frames in tubes:
            groups.setdefault((video, c), ([], []))[side].append((score, frames))
    box_err = score_err = 0.0
    for key, (mine, theirs) in groups.items():
        check(len(mine) == len(theirs),
              f"{label}: {len(mine)} tubes against {len(theirs)} for {key}")
        free = list(theirs)
        for score, frames in mine:
            best = None
            for j, (s2, f2) in enumerate(free):
                if sorted(f2) != sorted(frames) or abs(score - s2) > EVAL_SCORE_TOL:
                    continue
                err = max(float(np.abs(np.asarray(frames[f]) - np.asarray(f2[f])).max())
                          for f in frames)
                if err <= EVAL_TUBE_TOL and (best is None or err < best[1]):
                    best = (j, err, abs(score - s2))
            check(best is not None, f"{label}: a tube of {key} (score {score:.6g}, "
                                    f"frames {min(frames)}-{max(frames)}) has no match")
            free.pop(best[0])
            box_err, score_err = max(box_err, best[1]), max(score_err, best[2])
    return len(got), box_err, score_err


def eval_phases(dev, seeded, smi_line: str, reset_counts, read_counts) -> dict:
    """Phase 16, the UCF101-24 evaluation path, and phase 17, the CLIs.
    Returns, per kernel, its launches on each evaluation run and, for K1
    and K2, their numbers at the shapes those runs gave them, for the JSON
    line."""
    import contextlib
    import io
    import pickle
    import tempfile

    from step_tpu_torch import PRESETS
    from step_tpu_torch.cli import test as cli_test
    from step_tpu_torch.cli import train as cli_train
    from step_tpu_torch.data.memory import MemoryUCF
    from step_tpu_torch.evaluate import (collect_detections, collect_video_tubes,
                                         dedupe_frame_detections, evaluate_ucf,
                                         link_frame_detections)
    from step_tpu_torch.inference import detect_clip, nms_surface
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.ops.roi_align import tube_roi_align
    from step_tpu_torch.utils.init import init_detector_

    out = {name: dict(eval_launches={}) for name in ("max_pool3x3_same",
                                                     "fused_scale_bias_relu",
                                                     "conv3x3x3_bn_relu",
                                                     "max_pool3d_same")}
    for name in ("nms_many", "tube_roi_align"):
        out[name] = dict(eval_launches={}, eval_launches_per_batch={}, eval_shapes={})

    def counted(path: str, run, hold: bool):
        """Run `path` once with the launch counts set to 0 just before and
        read just after, counting its `detect_clip` calls (its detection
        batches); with `hold`, every K1 and K2 call recorded and held
        against its plain version, K1 launched once a batch and K2
        `num_steps` times."""
        reset_counts()
        with recorded(nms_surface, lambda t, *_: tuple(t.shape), keep=hold) as k1, \
                recorded(tube_roi_align, shape_of, keep=hold) as k2, \
                call_count(detect_clip) as batches:
            result = run()
            torch.cuda.synchronize()
        counts = read_counts()
        for name, n in counts.items():
            out[name]["eval_launches"][path] = n
        if hold:
            steps = cfg.num_steps
            check(batches[0] > 0 and counts["nms_many"] == batches[0]
                  and counts["tube_roi_align"] == steps * batches[0],
                  f"{path}: launches {counts} for {batches[0]} detection batches "
                  f"(want K1 1 and K2 {steps} a batch)")
            check(sum(v[0] for v in k1.values()) == counts["nms_many"]
                  and sum(v[0] for v in k2.values()) == counts["tube_roi_align"],
                  f"{path}: recorded launches differ from the counters {counts}")
            hold_nms_calls(path, k1, out["nms_many"]["eval_shapes"])
            hold_roi_calls(path, k2, out["tube_roi_align"]["eval_shapes"])
        return result, counts, batches[0]

    # ---- 16. evaluate_ucf at full width, bf16, the main path's tree -----
    t16 = time.time()
    cfg = PRESETS["ucf_3step"].replace(score_thresh=0.0)
    model = served_model(cfg, seeded, dev)
    data = MemoryUCF(cfg, EVAL_VIDEOS, EVAL_FRAMES, EVAL_RESOLUTION, SEED + 3)
    print(f"[16] evaluate_ucf on ucf_3step, full width, BN folded, {cfg.compute_dtype}, "
          f"score_thresh 0: {EVAL_VIDEOS} synthetic videos of {EVAL_FRAMES} frames in "
          f"memory, native resolution {EVAL_RESOLUTION}, {len(data)} windows one chunk "
          f"apart", flush=True)
    for path, kw in (("evaluate_ucf_host", {}),
                     ("evaluate_ucf_device_linking", dict(device_linking=True))):
        results, counts, batches = counted(path, lambda: evaluate_ucf(model, data, **kw),
                                           True)
        check_eval_results(results, path)
        t = results.pop("timings")
        print(f"[16] {path}: {json.dumps(results)}", flush=True)
        print(f"    timings ({smi_line}): {json.dumps(t)}", flush=True)
        print(f"    launches {counts}: {batches} detection batches (counted), K1 "
              f"{counts['nms_many'] / batches:g} and K2 "
              f"{counts['tube_roi_align'] / batches:g} a batch", flush=True)
        for name in ("nms_many", "tube_roi_align"):
            out[name]["eval_launches_per_batch"][path] = counts[name] / batches
    del model

    # The evaluation of a tiny float32 detector on the card against the
    # same on the CPU (plain K1 and K2 there): each linker's tubes, matched
    # one to one within EVAL_TUBE_TOL px and EVAL_SCORE_TOL, and, through
    # evaluate_ucf, equal detection counts and mAPs within EVAL_MAP_TOL.
    tiny = cfg.replace(backbone_depth="tiny", feature_stride=8, image_size=64,
                       compute_dtype="float32")
    small = MemoryUCF(tiny, 2, 30, EVAL_RESOLUTION, SEED + 4)
    runs, tubes = {}, {}
    for d in (dev, "cpu"):
        m = init_detector_(STEPDetector(tiny).eval(), SEED).to(d)
        tubes[str(d)] = {
            "host": link_frame_detections(dedupe_frame_detections(
                collect_detections(m, small))),
            "device": collect_video_tubes(m, small)}
        runs[str(d)] = [evaluate_ucf(m, small, device_linking=link) for link in (False, True)]
    for form in ("host", "device"):
        n, box_err, score_err = same_tubes(tubes[str(dev)][form], tubes["cpu"][form],
                                           f"tiny {form} linking, card vs CPU")
        print(f"[16] tiny f32 {form} linking, card vs CPU: {n} tubes on both, matched "
              f"one to one: boxes {box_err:.3g} px (tol {EVAL_TUBE_TOL}), scores "
              f"{score_err:.3g} (tol {EVAL_SCORE_TOL})", flush=True)
    for (a, b), form in zip(zip(runs[str(dev)], runs["cpu"]), ("host", "device")):
        check(a["timings"]["n_detections"] == b["timings"]["n_detections"],
              f"tiny evaluate_ucf ({form} linking): {a['timings']['n_detections']} "
              f"detections on the card, {b['timings']['n_detections']} on the CPU")
        for key in ("frame_mAP@0.5", "video_mAP@0.2", "video_mAP@0.5"):
            same = abs(a[key] - b[key]) <= EVAL_MAP_TOL or (np.isnan(a[key])
                                                            and np.isnan(b[key]))
            check(same, f"tiny evaluate_ucf ({form} linking) {key}: {a[key]} on the "
                        f"card, {b[key]} on the CPU")
        print(f"[16] tiny f32 evaluate_ucf, {form} linking, card vs CPU: "
              f"{a['timings']['n_detections']} detections on both; frame_mAP@0.5 "
              f"{a['frame_mAP@0.5']:.6f} vs {b['frame_mAP@0.5']:.6f}, video_mAP@0.2 "
              f"{a['video_mAP@0.2']:.6f} vs {b['video_mAP@0.2']:.6f} (tol {EVAL_MAP_TOL})",
              flush=True)
    print(f"    phase 16 took {time.time() - t16:.1f} s", flush=True)

    # ---- 17. the CLIs on an on-disk UCF101-24 layout ---------------------
    t17 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        root, ckpt = os.path.join(tmp, "ucf"), os.path.join(tmp, "ckpt")
        videos = write_train_layout(root, cfg)
        print(f"[17] wrote {len(videos)} videos of {CLI_FRAMES} frames at "
              f"{cfg.image_size} px in the UCF101-24 layout in {time.time() - t17:.1f} s",
              flush=True)

        def cli(path, module, argv, expect):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                result, counts, _ = counted(path, lambda: module.main(argv), False)
            text = buf.getvalue()
            print("\n".join("    " + line for line in text.splitlines()[-12:]), flush=True)
            missing = [k for k in expect if k not in text]
            check(not missing, f"{path}: the output lacks {missing}")
            check(counts["tube_roi_align"] > 0 and counts["nms_many"] > 0,
                  f"{path}: launches {counts}")
            print(f"[17] {path}: launches {counts}", flush=True)
            return result

        state = cli("cli_train", cli_train,
                    ["--preset", "ucf_3step", "--dataset", "ucf101_24", "--data-root", root,
                     "--ckpt-dir", ckpt, "--batch-size", "2", "--steps", str(CLI_STEPS),
                     "--epochs", "1", "--eval-every-epochs", "1", "--eval-max-batches", "2",
                     "--set", "warmup_steps=1"],
                    ("epoch 0 eval:", "frame_mAP@0.5", f"trained to step {CLI_STEPS}",
                     "decoder:"))
        check(state.step == CLI_STEPS, f"cli.train stopped at step {state.step}")
        check(out["max_pool3x3_same"]["eval_launches"]["cli_train"] > 0,
              "cli_train: K5 never launched under autograd")
        del state
        keys = ("decoder:", "frame_mAP@0.5:", "video_mAP@0.2:", "video_mAP@0.5:",
                "video_mAP@0.5:0.95:", "timings:")
        for path, extra in (("cli_test_optimized", ["--optimized"]),
                            ("cli_test_device_linking", ["--device-linking"])):
            results = cli(path, cli_test, ["--data-root", root, "--ckpt-dir", ckpt,
                                           "--dump", os.path.join(tmp, "dets.pkl"),
                                           "--set", "score_thresh=0.0", *extra], keys)
            check_eval_results(results, path)
            with open(os.path.join(tmp, "dets.pkl"), "rb") as f:
                check(len(pickle.load(f)["detections"]) == results["timings"]["n_detections"],
                      f"{path}: the dump holds another number of detections")
    print(f"    phase 17 took {time.time() - t17:.1f} s", flush=True)
    return out


def served_model(cfg, state, dev):
    """The main path's tree of `cfg` (`optimize_for_inference`: BN folded,
    the Inception 1x1x1 convs fused) on the unfolded `state`, on the card in
    cfg.compute_dtype."""
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.models.optimize import optimize_for_inference

    cfg_opt, folded = optimize_for_inference(cfg, state)
    model = STEPDetector(cfg_opt).eval()
    model.load_state_dict(folded)
    return model.to(device=dev, dtype=getattr(torch, cfg.compute_dtype))


def held_run(path: str, run, reset_counts, read_counts, out: dict, key: str,
             counted=None):
    """Run `path` once with the launch counts set to 0 just before and read
    just after, every K1 and K2 call recorded and held against its plain
    version (`hold_nms_calls`, `hold_roi_calls`) into `out[...][key +
    "_shapes"]`, and the counts stored under `out[...][key + "_launches"]
    [path]`. `counted`, a function of the port, has its calls counted.
    Returns (result, counts, calls of `counted`)."""
    from step_tpu_torch.inference import nms_surface
    from step_tpu_torch.ops.roi_align import tube_roi_align

    reset_counts()
    with contextlib.ExitStack() as stack:
        k1 = stack.enter_context(recorded(nms_surface, lambda t, *_: tuple(t.shape),
                                          keep=True))
        k2 = stack.enter_context(recorded(tube_roi_align, shape_of, keep=True))
        calls = stack.enter_context(call_count(counted)) if counted else [None]
        result = run()
        torch.cuda.synchronize()
    counts = read_counts()
    for name, n in counts.items():
        out[name][key + "_launches"][path] = n
    check(sum(v[0] for v in k1.values()) == counts["nms_many"]
          and sum(v[0] for v in k2.values()) == counts["tube_roi_align"],
          f"{path}: recorded launches differ from the counters {counts}")
    hold_nms_calls(path, k1, out["nms_many"][key + "_shapes"])
    hold_roi_calls(path, k2, out["tube_roi_align"][key + "_shapes"])
    return result, counts, calls[0]


def first_grad_hooks(module) -> dict:
    """{parameter name: whether its first gradient, step 1's, is nonzero}
    for every parameter of `module`."""
    first = {}

    def keep(name):
        def hook(p):
            if name not in first:
                first[name] = p.grad.ne(0).any()
        return hook

    for name, p in module.named_parameters():
        p.register_post_accumulate_grad_hook(keep(name))
    return first


def two_stream_phases(dev, rng, smi_line: str, reset_counts, read_counts) -> dict:
    """Phase 18, the two-stream detector (`two_stream_train`). Returns, per
    kernel, its launches on each two-stream run and the numbers at the
    shapes held there, for the JSON line."""
    from step_tpu_torch import PRESETS
    from step_tpu_torch.data.pipeline import build_model_batch
    from step_tpu_torch.data.synthetic import SyntheticConfig, make_batch, make_flow
    from step_tpu_torch.inference import detect_clip, nms_surface
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.ops.conv3d import conv3x3x3_bn_relu
    from step_tpu_torch.ops.fused_bn_relu import fused_scale_bias_relu
    from step_tpu_torch.ops.pool import max_pool3x3_same
    from step_tpu_torch.train.trainer import batch_to_device
    from step_tpu_torch.utils.init import init_detector_, init_detector_train_

    out = {name: dict(two_stream_launches={}, two_stream_shapes={}) for name in KERNELS}
    cfg = PRESETS["two_stream_train"]
    T, S = cfg.total_frames, cfg.image_size
    t18 = time.time()
    seeded = init_detector_(STEPDetector(cfg).eval(), SEED).state_dict()
    model = served_model(cfg, seeded, dev)
    names = [n for n, _ in model.named_parameters()]
    check("features.fusion.conv.bias" in names
          and any(n.startswith("features.stem_flow.") and ".b012." in n for n in names)
          and not any(".bn." in n for n in names),
          "optimize_for_inference did not fold and fuse stem_flow and fusion")
    n_params = sum(p.numel() for p in model.parameters())

    def uint8_clips(b):
        return torch.from_numpy(rng.randint(0, 256, (b, T, S, S, 3)).astype(np.uint8))

    def int8_flows(b):
        return torch.from_numpy(rng.randint(-127, 128, (b, T, S, S, 2)).astype(np.int8))

    clips = {b: [uint8_clips(b) for _ in range(REQUESTS_PER_BATCH)] for b in SERVE_BATCHES}
    flows = {b: [int8_flows(b) for _ in range(REQUESTS_PER_BATCH)] for b in SERVE_BATCHES}
    print(f"[18] two_stream_train full width, {n_params} params, BN folded (both stems "
          f"and the fusion unit), {cfg.compute_dtype}: uint8 RGB and int8 flow through "
          f"detect_clip", flush=True)
    torch.cuda.reset_peak_memory_stats(dev)
    walls, counts, _ = held_run(
        "serve", lambda: serve(model, cfg, clips, dev, "two-stream", flows),
        reset_counts, read_counts, out, "two_stream")
    n_req = len(SERVE_BATCHES) * REQUESTS_PER_BATCH
    check(counts["nms_many"] == n_req and counts["tube_roi_align"] == cfg.num_steps * n_req,
          f"two-stream serving: launches {counts} for {n_req} requests (want K1 1 and K2 "
          f"{cfg.num_steps} a request)")
    medians = {b: float(np.median(t[1:])) for b, t in walls.items()}
    print(f"[18] two-stream request medians ({smi_line}): "
          f"{', '.join(f'B={b} {m:.2f} ms' for b, m in medians.items())}; launches "
          f"{counts}; peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
          flush=True)
    del model, clips

    # The kernel configuration at B=2: both stems' K3, K4 and K5 launches by
    # shape as backbone_launches lists them, the fusion unit's K4 among them.
    kcfg = cfg.replace(fused_bn_relu=True)
    kmodel = STEPDetector(kcfg).eval()
    kmodel.load_state_dict(seeded)
    kmodel = kmodel.to(dev)
    props, pm2 = STEPDetector.initial_proposals(kcfg, 2, device=dev)
    wrappers = (("conv3x3x3_bn_relu", conv3x3x3_bn_relu,
                 lambda x, w, *_: (tuple(x.shape), w.shape[0])),
                ("fused_scale_bias_relu", fused_scale_bias_relu, shape_of),
                ("max_pool3x3_same", max_pool3x3_same, shape_of))
    reset_counts()
    with contextlib.ExitStack() as stack:
        seen = {name: stack.enter_context(recorded(fn, key)) for name, fn, key in wrappers}
        kdet = detect_clip(kmodel, uint8_clips(2).to(dev), props, pm2, int8_flows(2).to(dev))
        torch.cuda.synchronize()
    counts = read_counts()
    check(bool(torch.isfinite(kdet["tube_scores"]).all()), "two-stream kernel path: not finite")
    k4s, k5s, k3s = backbone_launches(kcfg, 2)
    fusion_shape = (2, 832, T // 4 + (T % 4 > 0), S // 16, S // 16)
    check(k4s.get(fusion_shape) == 1, f"backbone_launches lists no fusion K4 at {fusion_shape}")
    for name, listed in (("conv3x3x3_bn_relu", k3s), ("fused_scale_bias_relu", k4s),
                         ("max_pool3x3_same", k5s)):
        measured = {shape: v[0] for shape, v in seen[name].items()}
        check(counts[name] == sum(measured.values()) and measured == listed,
              f"two-stream kernel path: {name} launched {measured} by shape, "
              f"backbone_launches lists {listed}")
        out[name]["two_stream_launches"]["kernel_path_b2"] = counts[name]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 18)
    r = bn_case(fusion_shape, gen)
    out["fused_scale_bias_relu"]["two_stream_shapes"][f"fusion {fusion_shape}"] = dict(
        launches=1, max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
        library_ms=r["library_ms"], bound_ms=r["bound_ms"], bound_by=r["bound_by"])
    print(f"[18] kernel configuration B=2, both stems: launches {counts}, by shape as "
          f"backbone_launches lists (K3 {sum(k3s.values())}, K4 {sum(k4s.values())}, K5 "
          f"{sum(k5s.values())}); K4 at the fusion unit [{r['rows']}, 832]: max |err| f32 "
          f"{r['err32']:.3g} (tol 1e-6), bf16 {r['max_abs_err']:.3g} (one bf16 step); "
          f"device {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_ms'] / r['ms']:.1%}), plain {r['plain_ms']:.4f} ms", flush=True)
    del kmodel, kdet

    # float32, B=1: the kernel configuration (both stems' K3, K4 and K5, the
    # fusion unit's K4) against the main path's tree, BN folded, on the same
    # uint8 RGB and int8 flow, as phase 11 holds the one-stream detector.
    cfg32 = cfg.replace(compute_dtype="float32")
    kmodel = STEPDetector(cfg32.replace(fused_bn_relu=True)).eval()
    kmodel.load_state_dict(seeded)
    kmodel = kmodel.to(dev)
    mmodel = served_model(cfg32, seeded, dev)
    props, pm1 = STEPDetector.initial_proposals(cfg, 1, device=dev)
    rgb1, flow1 = uint8_clips(1).to(dev), int8_flows(1).to(dev)
    got = detect_clip(kmodel, rgb1, props, pm1, flow1)
    want = detect_clip(mmodel, rgb1, props, pm1, flow1)
    torch.cuda.synchronize()
    d_scores = float((got["tube_scores"] - want["tube_scores"]).abs().max())
    d_tubes = float((got["tubes"] - want["tubes"]).abs().max())
    print(f"[18] f32 B=1 two-stream kernel configuration vs main path: tube scores max "
          f"|d| {d_scores:.3g} (tol {PATH_SCORE_TOL}), tubes {d_tubes:.3g} px (tol "
          f"{PATH_TUBE_TOL})", flush=True)
    check(d_scores <= PATH_SCORE_TOL and d_tubes <= PATH_TUBE_TOL,
          f"two-stream kernel configuration differs from the main path: scores "
          f"{d_scores}, tubes {d_tubes} px")
    del kmodel, mmodel, got, want

    # A tiny float32 two-stream detector on the card against the CPU.
    tiny = cfg.replace(backbone_depth="tiny", feature_stride=8, image_size=64,
                       compute_dtype="float32")
    m_cpu = init_detector_(STEPDetector(tiny).eval(), SEED)
    m_gpu = init_detector_(STEPDetector(tiny).eval(), SEED).to(dev)
    tp, tm = STEPDetector.initial_proposals(tiny, 2, device="cpu")
    clip = torch.from_numpy(rng.randint(0, 256, (2, T, 64, 64, 3)).astype(np.uint8))
    flow = torch.from_numpy(rng.randint(-127, 128, (2, T, 64, 64, 2)).astype(np.int8))
    ref = detect_clip(m_cpu, clip, tp, tm, flow)
    got = detect_clip(m_gpu, clip.to(dev), tp.to(dev), tm.to(dev), flow.to(dev))
    d_tubes = float((got["tubes"].cpu() - ref["tubes"]).abs().max())
    d_scores = float((got["tube_scores"].cpu() - ref["tube_scores"]).abs().max())
    check(d_tubes <= 1e-3 and d_scores <= 1e-4,
          f"tiny two-stream detector card vs CPU: tubes {d_tubes} px, scores {d_scores}")
    surf = nms_surface(ref["tubes"].to(dev), ref["tube_scores"].to(dev), tm.to(dev), tiny)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        check(torch.equal(surf[key].cpu(), ref[key]),
              f"tiny two-stream NMS surface on the card differs in {key}")
    print(f"[18] tiny f32 two-stream detector card vs CPU: tubes {d_tubes:.3g} px (tol "
          f"1e-3), scores {d_scores:.3g} (tol 1e-4); NMS surface equal", flush=True)

    # fit() at full width: both stems and the fusion unit trained end to end.
    tcfg = train_cfg("two_stream_train", TS_TRAIN_BATCH)
    syn = SyntheticConfig(image_size=S, num_frames=T, num_classes=cfg.num_classes,
                          max_boxes=4)
    tmodel = init_detector_train_(STEPDetector(tcfg), tcfg, SEED)
    first = first_grad_hooks(tmodel.features)

    def with_flow(state, batch, index):
        check("flow" in batch, "the two-stream training batch holds no flow")

    reset_counts()
    t0 = time.time()
    state, steps, memory = timed_fit(
        dict(cfg=tcfg, loader=synthetic_loader(tcfg, TS_TRAIN_STEPS, with_flow=True),
             num_epochs=1, model=tmodel, device=dev, seed=SEED), read_counts, with_flow)
    check(len(steps) == TS_TRAIN_STEPS == state.step,
          f"two-stream fit ran {len(steps)} steps, state at {state.step}")
    features = [n for n, _ in tmodel.features.named_parameters()]
    zero = [n for n in features if n not in first or not bool(first[n])]
    check(not zero, f"two-stream backbone parameters without a nonzero step-1 gradient: "
                    f"{zero[:5]}")
    median_ms, per_step, summary = step_summary(steps)
    for name in ("tube_roi_align", "max_pool3x3_same"):
        check(min(per_step[name]) > 0, f"two-stream training: {name} not launched in every "
                                       f"step: {per_step[name]}")
        out[name]["two_stream_launches"]["train_step"] = max(per_step[name])
    stems = {k: sum(1 for n in features if n.startswith(k))
             for k in ("stem_rgb.", "stem_flow.", "fusion.")}
    print(f"[18] two-stream fit() at full width, batch {TS_TRAIN_BATCH}, {TS_TRAIN_STEPS} "
          f"steps in {time.time() - t0:.1f} s ({smi_line}): {summary}; median of the last "
          f"8 {median_ms:.2f} ms ({TS_TRAIN_BATCH / median_ms * 1e3:.1f} clips/s); "
          f"{memory}; every backbone parameter has a nonzero step-1 gradient ({stems}); "
          f"launches a step {per_step}", flush=True)
    # The same step on one batch already on the card, no loader running: what
    # the loader's threads, which make each clip's flow in this process, add.
    raw = make_batch(SEED * 1000 + 10 ** 6, TS_TRAIN_BATCH, syn)
    raw["flow"] = np.stack([make_flow(clip) for clip in raw["rgb"]])
    fixed = batch_to_device(build_model_batch(raw, tcfg, train=True, emit_uint8=True), dev)
    fixed_losses, fixed_ms = fixed_batch_steps(state, fixed, tcfg)
    check(all(np.isfinite(fixed_losses)), f"two-stream fixed-batch losses {fixed_losses}")
    print(f"[18] 8 two-stream steps on one batch on the card, no loader: step ms "
          f"{', '.join(f'{t:.1f}' for t in fixed_ms)}; median "
          f"{float(np.median(fixed_ms)):.2f} ms (fit()'s {median_ms:.2f})", flush=True)
    del state, tmodel, fixed
    print(f"    phase 18 took {time.time() - t18:.1f} s", flush=True)
    return out


def late_fusion_phases(dev, rng, smi_line: str, reset_counts, read_counts) -> dict:
    """Phase 19, late fusion and the flow stream. Returns, per kernel, its
    launches on each run and the numbers at the shapes held there."""
    from step_tpu_torch import PRESETS
    from step_tpu_torch.data.memory import MemoryUCF
    from step_tpu_torch.evaluate import collect_video_tubes, evaluate_ucf
    from step_tpu_torch.inference import detect_clip_late_fusion, nms_surface
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.utils.init import init_detector_

    out = {name: dict(late_fusion_launches={}, late_fusion_shapes={}) for name in KERNELS}
    t19 = time.time()
    # score threshold 0, so that the random weights' detections reach the
    # evaluation (phase 16)
    cfg = PRESETS["ucf_3step"].replace(score_thresh=0.0)
    T, S, B = cfg.total_frames, cfg.image_size, 8
    flow_cfg = cfg.replace(input_stream="flow")
    m_rgb = served_model(cfg, init_detector_(STEPDetector(cfg).eval(), SEED).state_dict(), dev)
    m_flow = served_model(flow_cfg, init_detector_(STEPDetector(flow_cfg).eval(),
                                                   SEED + 1).state_dict(), dev)
    props, pmask = STEPDetector.initial_proposals(cfg, B, device=dev)
    rgb = [torch.from_numpy(rng.randint(0, 256, (B, T, S, S, 3)).astype(np.uint8))
           for _ in range(REQUESTS_PER_BATCH)]
    flow = [torch.from_numpy(rng.randint(-127, 128, (B, T, S, S, 2)).astype(np.int8))
            for _ in range(REQUESTS_PER_BATCH)]

    def requests():
        times = []
        for x, f in zip(rgb, flow):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            det = detect_clip_late_fusion(m_rgb, m_flow, x.to(dev), f.to(dev), props, pmask)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            for key, v in det.items():
                check(bool(torch.isfinite(v).all()), f"late fusion: {key} not finite")
            check(float(det["tube_scores"][:, cfg.num_proposals:].abs().max()) == 0.0,
                  "late fusion: padding proposals scored")
        return times

    times, counts, _ = held_run("detect_clip_late_fusion_b8", requests, reset_counts,
                                read_counts, out, "late_fusion")
    n = len(rgb)
    check(counts["nms_many"] == n and counts["tube_roi_align"] == 2 * cfg.num_steps * n,
          f"late fusion: launches {counts} for {n} requests (want K1 1 and K2 "
          f"{2 * cfg.num_steps} a request)")
    print(f"[19] detect_clip_late_fusion, ucf_3step RGB + flow-stream detectors, full "
          f"width, BN folded, bf16, B={B}: request wall ms "
          f"{', '.join(f'{t:.2f}' for t in times)} (first warms up), median "
          f"{np.median(times[1:]):.2f} ms ({smi_line}); launches {counts}", flush=True)

    # evaluate_ucf and collect_video_tubes with the flow stream, on synthetic
    # videos whose items carry their flow
    data = MemoryUCF(cfg, LF_VIDEOS, EVAL_FRAMES, EVAL_RESOLUTION, SEED + 19,
                     with_flow=True)
    results, counts, batches = held_run(
        "evaluate_ucf_late_fusion", lambda: evaluate_ucf(m_rgb, data, model_flow=m_flow),
        reset_counts, read_counts, out, "late_fusion", counted=detect_clip_late_fusion)
    check_eval_results(results, "evaluate_ucf late fusion")
    check(batches > 0 and counts["nms_many"] == batches
          and counts["tube_roi_align"] == 2 * cfg.num_steps * batches,
          f"evaluate_ucf late fusion: launches {counts} for {batches} fused batches")
    timings = results.pop("timings")
    print(f"[19] evaluate_ucf with model_flow, host-linked, {len(data)} windows of "
          f"{LF_VIDEOS} videos: {json.dumps(results)}; K1 1 and K2 {2 * cfg.num_steps} a "
          f"fused batch ({batches} batches); timings ({smi_line}): {json.dumps(timings)}",
          flush=True)
    tubes, counts, batches = held_run(
        "collect_video_tubes_late_fusion",
        lambda: collect_video_tubes(m_rgb, data, model_flow=m_flow),
        reset_counts, read_counts, out, "late_fusion", counted=detect_clip_late_fusion)
    check(len(tubes) > 0 and batches == LF_VIDEOS, f"collect_video_tubes with the flow "
          f"stream: {len(tubes)} tubes from {batches} fused batches")
    print(f"[19] collect_video_tubes with model_flow: {len(tubes)} tubes, {batches} fused "
          f"batches of 16 windows; launches {counts}", flush=True)
    del m_rgb, m_flow, data

    # Each of the three as a tiny float32 run, card against CPU.
    tiny = cfg.replace(backbone_depth="tiny", feature_stride=8, image_size=64,
                       compute_dtype="float32")
    small = MemoryUCF(tiny, 2, 30, EVAL_RESOLUTION, SEED + 20, with_flow=True)
    tp, tm = STEPDetector.initial_proposals(tiny, 2, device="cpu")
    clip = torch.from_numpy(rng.randint(0, 256, (2, T, 64, 64, 3)).astype(np.uint8))
    tflow = torch.from_numpy(rng.randint(-127, 128, (2, T, 64, 64, 2)).astype(np.int8))
    runs = {}
    for d in (dev, "cpu"):
        mr = init_detector_(STEPDetector(tiny).eval(), SEED).to(d)
        mf = init_detector_(STEPDetector(tiny.replace(input_stream="flow")).eval(),
                            SEED + 1).to(d)
        runs[str(d)] = (
            detect_clip_late_fusion(mr, mf, clip.to(d), tflow.to(d), tp.to(d), tm.to(d)),
            evaluate_ucf(mr, small, model_flow=mf),
            collect_video_tubes(mr, small, model_flow=mf))
    (det_g, ev_g, tubes_g), (det_c, ev_c, tubes_c) = runs[str(dev)], runs["cpu"]
    d_tubes = float((det_g["tubes"].cpu() - det_c["tubes"]).abs().max())
    d_scores = float((det_g["tube_scores"].cpu() - det_c["tube_scores"]).abs().max())
    check(d_tubes <= 1e-3 and d_scores <= 1e-4,
          f"tiny late fusion card vs CPU: tubes {d_tubes} px, scores {d_scores}")
    surf = nms_surface(det_c["tubes"].to(dev), det_c["tube_scores"].to(dev), tm.to(dev), tiny)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        check(torch.equal(surf[key].cpu(), det_c[key]),
              f"tiny late fusion NMS surface on the card differs in {key}")
    check(ev_g["timings"]["n_detections"] == ev_c["timings"]["n_detections"],
          f"tiny evaluate_ucf late fusion: {ev_g['timings']['n_detections']} detections "
          f"on the card, {ev_c['timings']['n_detections']} on the CPU")
    for key in ("frame_mAP@0.5", "video_mAP@0.2", "video_mAP@0.5"):
        same = abs(ev_g[key] - ev_c[key]) <= EVAL_MAP_TOL or (np.isnan(ev_g[key])
                                                               and np.isnan(ev_c[key]))
        check(same, f"tiny evaluate_ucf late fusion {key}: {ev_g[key]} on the card, "
                    f"{ev_c[key]} on the CPU")
    n_tubes, box_err, score_err = same_tubes(tubes_g, tubes_c,
                                             "tiny collect_video_tubes late fusion")
    print(f"[19] tiny f32 card vs CPU: detect_clip_late_fusion tubes {d_tubes:.3g} px, "
          f"scores {d_scores:.3g}, NMS surface equal; evaluate_ucf with model_flow "
          f"{ev_g['timings']['n_detections']} detections on both, frame_mAP@0.5 "
          f"{ev_g['frame_mAP@0.5']:.6f} vs {ev_c['frame_mAP@0.5']:.6f}; "
          f"collect_video_tubes {n_tubes} tubes matched one to one (boxes {box_err:.3g} px, "
          f"scores {score_err:.3g})", flush=True)
    print(f"    phase 19 took {time.time() - t19:.1f} s", flush=True)
    return out


def write_ava_layout(root: str, rng) -> dict:
    """An AVA v2.1 layout on disk, shaped like the official one: frames
    `frames/<video>/<video>_%06d.jpg` at AVA_FPS, a label map of 60
    evaluated ids among the sparse 1..80 (every fourth id is not
    evaluated), training and validation CSVs of person boxes (rows with ids
    the map does not evaluate; a person whose only action is one; two
    actions of one person on two rows), and an excluded keyframe. Returns
    the CLI's AVA arguments."""
    import cv2

    ids = [i for i in range(1, 81) if i % 4][:60]
    H, W = AVA_SIZE
    rows = []
    for v in range(AVA_VIDEOS):
        video = f"vid{v:02d}"
        os.makedirs(os.path.join(root, "frames", video), exist_ok=True)
        base = rng.randint(0, 200, (H, W, 3)).astype(np.uint8)
        for fn in range(1, AVA_FRAMES + 1):
            img = np.roll(base, 3 * fn, axis=1)
            cv2.imwrite(os.path.join(root, "frames", video, f"{video}_{fn:06d}.jpg"), img)
        for ts in range(2, 2 + 5):
            for person in range(1 + (ts + v) % 3):
                x1, y1 = rng.uniform(0.0, 0.5, 2)
                box = [x1, y1, x1 + rng.uniform(0.2, 0.5), y1 + rng.uniform(0.3, 0.5)]
                actions = ([4 * (ts + person)] if person == 2 else
                           [ids[(7 * ts + 3 * person + v) % 60],
                            ids[(5 * ts + person) % 60], 4 * (1 + v)])
                rows += [f"{video},{ts},{box[0]:.3f},{box[1]:.3f},{min(box[2], 1):.3f},"
                         f"{min(box[3], 1):.3f},{a},{person}" for a in actions]
    for name in ("ava_train.csv", "ava_val.csv"):
        with open(os.path.join(root, name), "w") as f:
            f.write("\n".join(rows) + "\n")
    with open(os.path.join(root, "label_map.pbtxt"), "w") as f:
        f.write("".join(f'item {{\n  name: "action {i}"\n  id: {i}\n}}\n' for i in ids))
    with open(os.path.join(root, "excluded.csv"), "w") as f:
        f.write("vid00,4\n")
    return dict(label_map=os.path.join(root, "label_map.pbtxt"), exclusions="excluded.csv",
                fps=AVA_FPS)


def ava_phases(dev, rng, smi_line: str, reset_counts, read_counts) -> dict:
    """Phase 20, `ava_3step`: serving, the C = 60 NMS surface, `evaluate_ava`
    on an on-disk layout, and the command lines. Returns, per kernel, its
    launches on each run and the numbers at the shapes held there."""
    import io
    import pickle
    import tempfile

    from step_tpu_torch import PRESETS
    from step_tpu_torch.cli import test as cli_test
    from step_tpu_torch.cli import train as cli_train
    from step_tpu_torch.data.ava import AVADataset
    from step_tpu_torch.eval.ava_eval import AVALabelMap
    from step_tpu_torch.evaluate import evaluate_ava
    from step_tpu_torch.inference import (class_scores_from_logits, detect_clip, nms_surface,
                                          nms_surface_plain)
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.utils.init import init_detector_

    out = {name: dict(ava_launches={}, ava_shapes={}) for name in KERNELS}
    t20 = time.time()
    cfg = PRESETS["ava_3step"]
    T, S = cfg.total_frames, cfg.image_size
    model = served_model(cfg, init_detector_(STEPDetector(cfg).eval(), SEED + 2).state_dict(),
                         dev)
    clips = {b: [torch.from_numpy(rng.randint(0, 256, (b, T, S, S, 3)).astype(np.uint8))
                 for _ in range(REQUESTS_PER_BATCH)] for b in SERVE_BATCHES}
    print(f"[20] ava_3step full width ({cfg.num_classes} sigmoid classes, context), BN "
          f"folded, {cfg.compute_dtype}", flush=True)
    walls, counts, _ = held_run("serve", lambda: serve(model, cfg, clips, dev, "ava"),
                                reset_counts, read_counts, out, "ava")
    n_req = len(SERVE_BATCHES) * REQUESTS_PER_BATCH
    check(counts["nms_many"] == n_req and counts["tube_roi_align"] == cfg.num_steps * n_req,
          f"AVA serving: launches {counts} for {n_req} requests")
    medians = {b: float(np.median(t[1:])) for b, t in walls.items()}
    print(f"[20] AVA request medians ({smi_line}): "
          f"{', '.join(f'B={b} {m:.2f} ms' for b, m in medians.items())}; launches {counts}",
          flush=True)
    # the C = 60 surface of a B=8 request's own tubes and scores, with the
    # scores in bfloat16 as well, by raw bits
    B = max(SERVE_BATCHES)
    props, pmask = STEPDetector.initial_proposals(cfg, B, device=dev)
    with torch.inference_mode():
        raw = model(clips[B][0].to(dev), props)
    tubes = raw["tubes"][-1]
    scores = class_scores_from_logits(raw["cls_logits"][-1], cfg) * pmask[..., None]
    survivors = 0
    for sc in (scores, scores.to(torch.bfloat16)):
        got, want = nms_surface(tubes, sc, pmask, cfg), nms_surface_plain(tubes, sc, pmask, cfg)
        torch.cuda.synchronize()
        check(got["frame_mask"].shape == (B, T, 60, min(cfg.max_detections, cfg.max_proposals)),
              f"AVA surface shape {tuple(got['frame_mask'].shape)}")
        for key in ("frame_boxes", "frame_scores", "frame_mask"):
            check(torch.equal(raw_bits(got[key]), raw_bits(want[key])),
                  f"K1 at C=60, {sc.dtype} scores, differs from plain in {key}")
        survivors = int(want["frame_mask"].sum())
    print(f"[20] K1 at C=60, B={B} ({B * T * 60} problems), f32 and bf16 scores: the plain "
          f"version's bits; {survivors} survivors", flush=True)
    del model, clips

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "ava")
        t0 = time.time()
        args = write_ava_layout(root, rng)
        print(f"[20] wrote an AVA layout of {AVA_VIDEOS} videos x {AVA_FRAMES} frames at "
              f"{AVA_SIZE} px, {AVA_FPS} fps, in {time.time() - t0:.1f} s", flush=True)
        lm = AVALabelMap.from_pbtxt(args["label_map"])
        check(lm.num_classes == cfg.num_classes, f"label map of {lm.num_classes} ids")
        ds = AVADataset(root, cfg, "ava_val.csv", fps=AVA_FPS, label_map=lm,
                        exclusions_file=args["exclusions"])
        check(("vid00", 4.0) not in ds.keyframes and len(ds) == AVA_VIDEOS * 5 - 1,
              f"AVA keyframes {ds.keyframes}")
        model = served_model(cfg, init_detector_(STEPDetector(cfg).eval(),
                                                 SEED + 2).state_dict(), dev)
        t0 = time.time()
        results, counts, batches = held_run(
            "evaluate_ava", lambda: evaluate_ava(model, ds, dump_path=os.path.join(tmp, "d.pkl")),
            reset_counts, read_counts, out, "ava", counted=detect_clip)
        wall = time.time() - t0
        m = results["frame_mAP@0.5"]
        check(np.isfinite(m) and 0.0 <= m <= 1.0, f"evaluate_ava frame_mAP@0.5 = {m}")
        check(batches == -(-len(ds) // 4) and counts["nms_many"] == batches
              and counts["tube_roi_align"] == cfg.num_steps * batches,
              f"evaluate_ava: launches {counts} for {batches} batches of 4")
        with open(os.path.join(tmp, "d.pkl"), "rb") as f:
            dets = pickle.load(f)["detections"]
        check(len(dets) > 0 and all(0 <= c < 60 and float(np.max(b)) <= 1.0 + 1e-6
                                    for _, c, _, b in dets),
              "evaluate_ava's dump: no detections, or boxes not normalized")
        print(f"[20] evaluate_ava on {len(ds)} keyframes ({batches} batches of 4): "
              f"frame_mAP@0.5 {m:.6f}, {len(dets)} detections; wall {wall:.2f} s "
              f"({smi_line}); launches {counts}", flush=True)
        del model

        ckpt = os.path.join(tmp, "ckpt")
        ava = ["--label-map", args["label_map"], "--exclusions", args["exclusions"],
               "--fps", str(AVA_FPS)]

        def cli(path, module, argv, expect, evaluates=False):
            """Run a command line in-process; training launches K2, an
            evaluation K1 once and K2 num_steps times a detect_clip batch."""
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                result, counts, batches = held_run(
                    path, lambda: module.main(argv), reset_counts, read_counts, out, "ava",
                    counted=detect_clip if evaluates else None)
            text = buf.getvalue()
            print("\n".join("    " + line for line in text.splitlines()[-6:]), flush=True)
            missing = [k for k in expect if k not in text]
            check(not missing, f"{path}: the output lacks {missing}")
            if evaluates:
                check(batches > 0 and counts["nms_many"] == batches
                      and counts["tube_roi_align"] == cfg.num_steps * batches,
                      f"{path}: launches {counts} for {batches} detect_clip batches")
            else:
                check(counts["tube_roi_align"] > 0, f"{path}: launches {counts}")
            print(f"[20] {path}: launches {counts}", flush=True)
            return result

        t0 = time.time()
        state = cli("cli_train_ava", cli_train,
                    ["--preset", "ava_3step", "--dataset", "ava", "--data-root", root,
                     "--annotation-file", "ava_train.csv", "--ckpt-dir", ckpt,
                     "--batch-size", "2", "--steps", str(CLI_STEPS), "--epochs", "1",
                     "--set", "warmup_steps=1", *ava],
                    (f"trained to step {CLI_STEPS}",))
        check(state.step == CLI_STEPS, f"cli.train --dataset ava stopped at {state.step}")
        del state
        results = cli("cli_test_ava", cli_test,
                      ["--preset", "ava_3step", "--data-root", root, "--ckpt-dir", ckpt,
                       "--annotation-file", "ava_val.csv", *ava],
                      ("restored step", "frame_mAP@0.5:"), evaluates=True)
        m = results["frame_mAP@0.5"]
        check(np.isnan(m) or 0.0 <= m <= 1.0, f"cli.test --preset ava_3step: mAP {m}")
        print(f"[20] cli.train --dataset ava ({CLI_STEPS} steps, B=2) then cli.test "
              f"--preset ava_3step: {time.time() - t0:.1f} s, frame_mAP@0.5 {m:.4f}",
              flush=True)
    print(f"    phase 20 took {time.time() - t20:.1f} s", flush=True)
    return out



def write_train_layout(root: str, cfg) -> list:
    """`write_ucf_layout`'s 4 videos of CLI_FRAMES frames at cfg.image_size
    under `root`, with its test split copied into the training split (the
    layout writes a test split only). Returns the video names."""
    import pickle

    from step_tpu_torch.data.synthetic import write_ucf_layout

    videos = write_ucf_layout(root, EVAL_VIDEOS, num_classes=cfg.num_classes,
                              image_size=cfg.image_size, frames_lo=CLI_FRAMES,
                              frames_hi=CLI_FRAMES, seed=SEED)
    gt_path = os.path.join(root, "UCF101v2-GT.pkl")
    with open(gt_path, "rb") as f:
        gt = pickle.load(f)
    gt["train_videos"] = [videos]
    with open(gt_path, "wb") as f:
        pickle.dump(gt, f)
    return videos


def i3d_checkpoint(path: str, num_classes: int = 400) -> dict:
    """Write a seeded full-width Kinetics-shaped I3D to `path` with
    `torch.save`, in the piergiaj/pytorch-i3d naming with a DataParallel
    `module.` prefix and `num_batches_tracked` beside each BatchNorm, as the
    public files come; the weights are `init_detector_`'s serving draw on
    `I3DClassifier` (BN near the identity, so bf16 activations stay finite).
    Returns the classifier state_dict the file must convert to."""
    from step_tpu_torch.models.i3d import I3DClassifier
    from step_tpu_torch.utils.init import init_detector_

    sd = init_detector_(I3DClassifier(num_classes).eval(), SEED + 21).state_dict()
    out = {}
    for key, value in sd.items():
        name = key.split(".", 1)[1] if key.startswith(("stem.", "tail.")) else key
        name = name.replace(".conv.", ".conv3d.")
        if name.startswith("logits."):
            name = "logits.conv3d." + name[len("logits."):]
        out["module." + name] = value.clone()
        if name.endswith(".bn.running_var"):
            out["module." + name.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(1)
    torch.save(out, path)
    return sd


def timed_fit(fit_kwargs: dict, read_counts, before_step=None):
    """`fit(**fit_kwargs)` with each step (`train_step`, or with a `mesh`
    the step `make_parallel_train_step` made) timed between CUDA events and
    its launches counted, and `before_step(state, batch, index)` called
    before each. Returns (state, [(ms, launches, metrics)], memory): memory says
    the peak allocated during fit() and what was allocated before it (what
    earlier phases still hold counts in the peak)."""
    from step_tpu_torch.train import fit as fit_module
    from step_tpu_torch.train.trainer import make_parallel_train_step, train_step

    events = []

    def timed(step, state, batch):
        if before_step is not None:
            before_step(state, batch, len(events))
        before = read_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        result = step(state, batch)
        end.record()
        after = read_counts()
        events.append((start, end, {k: after[k] - before[k] for k in after}, result[1]))
        return result

    def timed_step(state, batch, cfg_):
        return timed(lambda s, b: train_step(s, b, cfg_), state, batch)

    def timed_parallel(cfg_, model, mesh):
        step = make_parallel_train_step(cfg_, model, mesh)
        return lambda state, batch: timed(step, state, batch)

    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated() / 2 ** 30
    fit_module.train_step = timed_step
    fit_module.make_parallel_train_step = timed_parallel
    try:
        state = fit_module.fit(**fit_kwargs)
        torch.cuda.synchronize()
    finally:
        fit_module.train_step = train_step
        fit_module.make_parallel_train_step = make_parallel_train_step
    steps = [(a.elapsed_time(b), counts, m) for a, b, counts, m in events]
    for _, _, m in steps:
        for key, v in m.items():
            check(bool(torch.isfinite(v).all()), f"training metric {key} not finite: {v}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    return state, steps, f"peak memory {peak:.2f} GiB ({before:.2f} GiB allocated before fit())"


def step_summary(steps) -> tuple[float, dict, str]:
    """(median ms of the last 8 steps, {kernel: sorted launches a step},
    the step times and losses as text)."""
    median = float(np.median([ms for ms, _, _ in steps][-8:]))
    per_step = {k: sorted({c[k] for _, c, _ in steps}) for k in steps[0][1]}
    text = (f"step ms {', '.join(f'{ms:.1f}' for ms, _, _ in steps)}; losses "
            f"{', '.join(f'{float(m['loss']):.3f}' for _, _, m in steps)}")
    return median, per_step, text


def synthetic_loader(cfg, steps: int, with_flow: bool = False):
    """The port's DataLoader over `steps` batches of synthetic clips of
    `cfg` (4 threads)."""
    from step_tpu_torch.data.loader import DataLoader
    from step_tpu_torch.data.synthetic import SyntheticConfig
    from step_tpu_torch.train_eval_synth import SyntheticClips

    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=4)
    return DataLoader(SyntheticClips(syn, steps * cfg.batch_size, SEED * 1000,
                                     with_flow=with_flow), cfg, seed=SEED, num_workers=4)


def train_cfg(preset: str, batch: int, **over):
    """`preset` as phase 14 trains it: synthetic clips, remat "dots", AdamW
    (warmup 2, lr 1e-3)."""
    from step_tpu_torch import PRESETS

    return PRESETS[preset].replace(dataset="synthetic", batch_size=batch, remat_steps=True,
                                   remat_policy="dots", optimizer="adamw", warmup_steps=2,
                                   learning_rate=1e-3, total_steps=1000, **over)


def pretrained_phases(dev, smi_line: str, reset_counts, read_counts) -> dict:
    """Phase 21, training from a Kinetics I3D checkpoint. Returns, per
    kernel, its launches on each run, for the JSON line."""
    import contextlib
    import io
    import tempfile

    from step_tpu_torch.cli import train as cli_train
    from step_tpu_torch.models.convert import convert_torch_i3d, inflate_rgb_to_flow

    out = {name: dict(pretrained_launches={}) for name in KERNELS}
    t21 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rgb_imagenet.pt")
        i3d_checkpoint(path)
        want = {k: v.to(dev) for k, v in convert_torch_i3d(
            torch.load(path), include_logits=False).items()}
        cfg = train_cfg("ucf_3step", TRAIN_BATCH)
        seen = {}

        def loaded(state, batch, index):
            """Before the first step, every stem and tail tensor equals the
            checkpoint's, bit for bit."""
            if index:
                return
            sd = state.model.state_dict()
            targets = [("stem.", "features.stem_rgb.")]
            if state.model.cfg.two_stream:
                targets.append(("stem.", "features.stem_flow."))
            targets += [("tail.", f"steps.{s}.tail.")
                        for s in range(state.model.cfg.num_steps)]
            n = 0
            for src, dst in targets:
                for key, value in want.items():
                    if key.startswith(src):
                        name = dst + key[len(src):]
                        if name == "features.stem_flow.Conv3d_1a_7x7.conv.weight":
                            value = inflate_rgb_to_flow(value)
                        check(torch.equal(sd[name], value),
                              f"{name} differs from the checkpoint's before the first step")
                        n += 1
            moments = state.opt_state["mu"]
            check(all(float(m.abs().max()) == 0 for m in moments),
                  "the optimizer's moments are not fresh after the pretrained load")
            seen[state.model.cfg.two_stream] = n

        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            state, steps, memory = timed_fit(
                dict(cfg=cfg, loader=synthetic_loader(cfg, TRAIN_STEPS), num_epochs=1,
                     device=dev, seed=SEED, pretrained_i3d=path), read_counts, loaded)
        text = buf.getvalue()
        check("pretrained I3D: scheme='piergiaj'" in text and "missing=0" in text
              and "initialized backbone from" in text,
              f"fit(pretrained_i3d=...) printed no report: {text[-300:]}")
        check(len(steps) == TRAIN_STEPS == state.step, f"fit ran {len(steps)} steps")
        median, per_step, summary = step_summary(steps)
        for name in ("tube_roi_align", "max_pool3x3_same"):
            check(min(per_step[name]) > 0, f"pretrained fit: {name} not launched in every "
                                           f"step: {per_step[name]}")
        for name in KERNELS:
            out[name]["pretrained_launches"]["train_step"] = max(per_step[name])
        print(f"[21] {text.splitlines()[0]}", flush=True)
        print(f"[21] fit(pretrained_i3d=...) ucf_3step full width, B={TRAIN_BATCH}, "
              f"{TRAIN_STEPS} steps ({smi_line}): all {seen[False]} stem and tail tensors "
              f"the checkpoint's before step 1, moments fresh; {summary}; median of the "
              f"last 8 {median:.2f} ms ({TRAIN_BATCH / median * 1e3:.1f} clips/s); "
              f"{memory}; launches a step {per_step}", flush=True)
        del state

        # two_stream_train at B=2: the flow stem is the RGB stem with its
        # first conv inflated
        tcfg = train_cfg("two_stream_train", 2)
        with contextlib.redirect_stdout(io.StringIO()):
            state, steps, _ = timed_fit(
                dict(cfg=tcfg, loader=synthetic_loader(tcfg, 2, with_flow=True),
                     num_epochs=1, device=dev, seed=SEED, pretrained_i3d=path),
                read_counts, loaded)
        check(seen.get(True, 0) > seen[False] and state.step == 2,
              f"two-stream pretrained start: {seen}")
        print(f"[21] two_stream_train B=2: {seen[True]} tensors loaded, the flow stem's "
              f"Conv3d_1a the inflated RGB kernel, the rest the RGB stem's; 2 steps, "
              f"losses {', '.join(f'{float(m['loss']):.3f}' for _, _, m in steps)}",
              flush=True)
        del state

        root, ckpt = os.path.join(tmp, "ucf"), os.path.join(tmp, "ckpt")
        write_train_layout(root, cfg)
        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            state = cli_train.main(["--preset", "ucf_3step", "--dataset", "ucf101_24",
                                    "--data-root", root, "--ckpt-dir", ckpt,
                                    "--batch-size", "2", "--steps", str(CLI_STEPS),
                                    "--epochs", "1", "--pretrained-i3d", path,
                                    "--set", "warmup_steps=1"])
            torch.cuda.synchronize()
        counts = read_counts()
        text = buf.getvalue()
        for name, n in counts.items():
            out[name]["pretrained_launches"]["cli_train"] = n
        check(state.step == CLI_STEPS and "initialized backbone from" in text
              and counts["tube_roi_align"] > 0 and counts["max_pool3x3_same"] > 0,
              f"cli.train --pretrained-i3d: step {state.step}, launches {counts}")
        print("\n".join("    " + line for line in text.splitlines()[-4:]), flush=True)
        print(f"[21] cli.train --pretrained-i3d on the on-disk layout, {CLI_STEPS} steps at "
              f"B=2: launches {counts}", flush=True)
    print(f"    phase 21 took {time.time() - t21:.1f} s", flush=True)
    return out


def int8_phases(dev, smi_line: str, reset_counts, read_counts) -> dict:
    """Phase 22, AdamW with int8 moments. Returns, per kernel, its launches
    a step, for the JSON line."""
    from step_tpu_torch.data.pipeline import build_model_batch
    from step_tpu_torch.data.synthetic import SyntheticConfig, make_batch
    from step_tpu_torch.train import optim_int8
    from step_tpu_torch.train.trainer import (Optimizer, batch_to_device, create_train_state,
                                              make_schedule, train_step)

    out = {name: dict(int8_launches={}) for name in KERNELS}
    t22 = time.time()
    cfg = train_cfg("ucf_3step", TRAIN_BATCH, adam_moments="int8")
    reset_counts()
    state, steps, memory = timed_fit(dict(cfg=cfg, loader=synthetic_loader(cfg, TRAIN_STEPS),
                                          num_epochs=1, device=dev, seed=SEED), read_counts)
    check(len(steps) == TRAIN_STEPS == state.step and state.opt_state["mu"].dtype == torch.int8,
          f"int8 fit ran {len(steps)} steps with moments {state.opt_state['mu'].dtype}")
    median, per_step, summary = step_summary(steps)
    for name in KERNELS:
        out[name]["int8_launches"]["train_step"] = max(per_step[name])
    params = state.trainable()
    n = sum(p.numel() for p in params)
    size = optim_int8.state_bytes(state.opt_state)
    # kernels in one step and in the optimizer's update alone, int8 against
    # float32 moments on the same model and batch
    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=4)
    fixed = batch_to_device(build_model_batch(make_batch(SEED + 22, TRAIN_BATCH, syn), cfg,
                                              train=True, emit_uint8=True), dev)
    grads = [torch.randn_like(p) * 1e-3 for p in params]
    kernels, update_ms = {}, {}
    for label in ("int8", "float32"):
        opt = Optimizer(cfg.replace(adam_moments=label))
        state.optimizer, state.opt_state = opt, opt.init(params, state.trainable_names())
        step_kernels = cuda_kernels_in(lambda: train_step(state, fixed, state.model.cfg))
        update_kernels, device = profiled(lambda: opt.update(params, grads, state.opt_state))
        update_ms[label] = (device, cuda_ms(lambda: opt.update(params, grads, state.opt_state),
                                            iters=10))
        kernels[label] = (step_kernels, update_kernels)
    print(f"[22] fit() with adam_moments='int8', ucf_3step full width, B={TRAIN_BATCH}, "
          f"{TRAIN_STEPS} steps ({smi_line}): {summary}; median of the last 8 "
          f"{median:.2f} ms ({TRAIN_BATCH / median * 1e3:.1f} clips/s); {memory}; "
          f"launches a step {per_step}", flush=True)
    print(f"[22] optimizer state {size} bytes for {n} trainable parameters: "
          f"{size / n:.4f} bytes a parameter (float32 moments {8 * n} bytes, 8); "
          f"kernels a step {kernels['int8'][0]} (float32 moments {kernels['float32'][0]}), "
          f"in the update alone {kernels['int8'][1]} ({kernels['float32'][1]}); the update's "
          f"device time {update_ms['int8'][0]:.3f} ms ({update_ms['float32'][0]:.3f} ms), "
          f"between CUDA events {update_ms['int8'][1]:.3f} ms ({update_ms['float32'][1]:.3f} "
          f"ms)", flush=True)
    check(2.03 <= size / n <= 2.04, f"int8 state takes {size / n} bytes a parameter")
    del state, grads, params, fixed

    # One tiny float32 step on the card against the CPU (the bound of
    # tests/test_torch_port_gpu.py::test_int8_train_step_on_card_matches_cpu)
    tiny = cfg.replace(backbone_depth="tiny", feature_stride=8, image_size=64,
                       compute_dtype="float32", batch_size=2, dropout_rate=0.0,
                       max_gt_tubes=2, warmup_steps=0, remat_steps=False)
    tsyn = SyntheticConfig(image_size=64, num_frames=tiny.total_frames,
                           num_classes=tiny.num_classes, max_boxes=2)
    tbatch = build_model_batch(make_batch(SEED, 2, tsyn), tiny, train=True)
    runs = []
    for d in (dev, "cpu"):
        st = create_train_state(tiny, seed=SEED, device=d)
        loss = float(train_step(st, batch_to_device(tbatch, d), tiny)[1]["loss"])
        runs.append((loss, {k: v.cpu() for k, v in st.model.state_dict().items()},
                     {k: st.opt_state[k].cpu() for k in ("mu", "nu", "mu_scale",
                                                         "nu_scale")}))
    (l_gpu, sd_gpu, q_gpu), (l_cpu, sd_cpu, q_cpu) = runs
    check(abs(l_gpu - l_cpu) <= 1e-5 * abs(l_cpu), f"tiny int8 step loss {l_gpu} vs {l_cpu}")
    lr = make_schedule(tiny)(0)
    far, total, worst = far_weights(sd_gpu, sd_cpu, lr,
                                    [k for k in sd_cpu if "running_" not in k])
    check(far <= 1e-3 * total, f"tiny int8 step: {far} of {total} weights beyond 1e-5")
    codes = {k: float((q_gpu[k] != q_cpu[k]).float().mean()) for k in ("mu", "nu")}
    for k in ("mu", "nu"):
        a = optim_int8.dequantize_blockwise(q_gpu[k], q_gpu[k + "_scale"])
        b = optim_int8.dequantize_blockwise(q_cpu[k], q_cpu[k + "_scale"])
        absmax = torch.maximum(q_gpu[k + "_scale"], q_cpu[k + "_scale"])[:, None]
        check(bool(((a - b).abs() <= 0.08 * b.abs() + 0.01 * absmax).all()),
              f"tiny int8 step: {k} on the card beyond one level and 1% of its block's "
              f"largest value from the CPU's")
    print(f"[22] tiny f32 int8 step card vs CPU: loss {l_gpu:.6f} vs {l_cpu:.6f}; weights "
          f"{far} of {total} beyond 1e-5 (tol 0.1%), max |d| {worst:.3g} (tol 2 lr = "
          f"{2 * lr:.3g}); codes differ on {codes}, each moment within one level (8%) or "
          f"1% of its block's largest value", flush=True)
    print(f"    phase 22 took {time.time() - t22:.1f} s", flush=True)
    return out


def frame_fc_phases(dev, rng, smi_line: str, reset_counts, read_counts) -> dict:
    """Phase 23, the "frame_fc" regression head. Returns, per kernel, its
    launches on each run and the numbers at the shapes held there."""
    from step_tpu_torch import PRESETS
    from step_tpu_torch.inference import detect_clip
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.utils.init import init_detector_, init_detector_train_

    out = {name: dict(frame_fc_launches={}, frame_fc_shapes={}) for name in KERNELS}
    t23 = time.time()
    cfg = PRESETS["ucf_3step"].replace(reg_head="frame_fc")
    T, S = cfg.total_frames, cfg.image_size
    seeded = init_detector_(STEPDetector(cfg).eval(), SEED).state_dict()
    model = served_model(cfg, seeded, dev)
    check(tuple(model.steps[0].reg.weight.shape) == (4 * T, 5 * 7 * 7 * 64),
          f"frame_fc Dense {tuple(model.steps[0].reg.weight.shape)}")

    def clips(b, n):
        return [torch.from_numpy(rng.randint(0, 256, (b, T, S, S, 3)).astype(np.uint8))
                for _ in range(n)]

    walls, counts, _ = held_run(
        "serve", lambda: serve(model, cfg, {b: clips(b, REQUESTS_PER_BATCH)
                                            for b in SERVE_BATCHES}, dev, "frame_fc"),
        reset_counts, read_counts, out, "frame_fc")
    n_req = len(SERVE_BATCHES) * REQUESTS_PER_BATCH
    check(counts["nms_many"] == n_req and counts["tube_roi_align"] == cfg.num_steps * n_req,
          f"frame_fc serving: launches {counts} for {n_req} requests")
    medians = {b: float(np.median(t[1:])) for b, t in walls.items()}
    print(f"[23] frame_fc ucf_3step, BN folded, bf16: request medians ({smi_line}): "
          f"{', '.join(f'B={b} {m:.2f} ms' for b, m in medians.items())}; launches "
          f"{counts}", flush=True)
    del model

    # float32, B=1: the kernel configuration against the main path's tree
    cfg32 = cfg.replace(compute_dtype="float32")
    kmodel = STEPDetector(cfg32.replace(fused_bn_relu=True)).eval()
    kmodel.load_state_dict(seeded)
    kmodel = kmodel.to(dev)
    mmodel = served_model(cfg32, seeded, dev)
    props, pm1 = STEPDetector.initial_proposals(cfg, 1, device=dev)
    clip = clips(1, 1)[0].to(dev)
    got = detect_clip(kmodel, clip, props, pm1)
    want = detect_clip(mmodel, clip, props, pm1)
    torch.cuda.synchronize()
    d_scores = float((got["tube_scores"] - want["tube_scores"]).abs().max())
    d_tubes = float((got["tubes"] - want["tubes"]).abs().max())
    check(d_scores <= PATH_SCORE_TOL and d_tubes <= PATH_TUBE_TOL,
          f"frame_fc kernel configuration differs from the main path: scores "
          f"{d_scores}, tubes {d_tubes} px")
    print(f"[23] f32 B=1 frame_fc kernel configuration vs main path: tube scores max |d| "
          f"{d_scores:.3g} (tol {PATH_SCORE_TOL}), tubes {d_tubes:.3g} px (tol "
          f"{PATH_TUBE_TOL})", flush=True)
    del kmodel, mmodel, got, want

    tcfg = train_cfg("ucf_3step", TRAIN_BATCH, reg_head="frame_fc")
    reset_counts()
    state, steps, memory = timed_fit(
        dict(cfg=tcfg, loader=synthetic_loader(tcfg, 4), num_epochs=1, device=dev,
             seed=SEED, model=init_detector_train_(STEPDetector(tcfg), tcfg, SEED)),
        read_counts)
    check(len(steps) == 4 == state.step, f"frame_fc fit ran {len(steps)} steps")
    _, per_step, summary = step_summary(steps)
    for name in ("tube_roi_align", "max_pool3x3_same"):
        check(min(per_step[name]) > 0, f"frame_fc training: {name} not launched in every "
                                       f"step: {per_step[name]}")
    for name in KERNELS:
        out[name]["frame_fc_launches"]["train_step"] = max(per_step[name])
    print(f"[23] frame_fc fit() B={TRAIN_BATCH}, 4 steps: {summary}; {memory}; "
          f"launches a step {per_step}", flush=True)
    del state
    print(f"    phase 23 took {time.time() - t23:.1f} s", flush=True)
    return out


def classifier_launches(B: int, T: int = 64, S: int = 224):
    """The K4, K5 and K3 launches of one bf16 `I3DClassifier` request of the
    kernel configuration at batch B on T frames of S px, keyed as
    `backbone_launches` keys them: the stem as the detector's (Conv3d_1a on
    the stem kernel, no K4), then MaxPool_5a and the tail's two blocks on
    the whole clip's features."""
    from step_tpu_torch.models.i3d import INCEPTION_CHANNELS

    up = lambda n, s: -(-n // s)  # noqa: E731
    T1, S1 = up(T, 2), up(S, 2)
    S2 = up(S1, 2)
    S3 = up(S2, 2)
    T4, S4 = up(T1, 2), up(S3, 2)
    T5, S5 = up(T4, 2), up(S4, 2)
    k4 = {(B, 64, T1, S2, S2): 1}
    k3 = {((B, 64, T1, S2, S2), 192): 1}
    k5 = {}
    where = {"Mixed_3": (T1, S3), "Mixed_4": (T4, S4), "Mixed_5": (T5, S5)}
    cin = 192
    for name, c in INCEPTION_CHANNELS.items():
        t, s = where[name[:7]]
        k5[(B, cin, t, s, s)] = k5.get((B, cin, t, s, s), 0) + 1
        for width in (c[0], c[1], c[3], c[5]):
            k4[(B, width, t, s, s)] = k4.get((B, width, t, s, s), 0) + 1
        for cin3, cout in ((c[1], c[2]), (c[3], c[4])):
            key = ((B, cin3, t, s, s), cout)
            k3[key] = k3.get(key, 0) + 1
        cin = c[0] + c[2] + c[4] + c[5]
    return k4, k5, k3


@contextlib.contextmanager
def held_backbone(errors: dict):
    """Each K3, K4 and K5 call the port's modules make while the block runs,
    held against its plain version on its own inputs as it is made (K5 by
    raw bits, K4 within one bf16 step, K3 by `k3_close`); yields
    {kernel: {shape: launches}} and fills `errors` with each kernel's
    largest |error|."""
    from step_tpu_torch.ops.conv3d import conv3x3x3_bn_relu, conv3x3x3_bn_relu_plain
    from step_tpu_torch.ops.fused_bn_relu import (fused_scale_bias_relu,
                                                  fused_scale_bias_relu_plain)
    from step_tpu_torch.ops.pool import max_pool3x3_same, max_pool3x3_same_plain

    seen = {}

    def holding(name, fn, plain, key, close):
        def run(*args, **kwargs):
            before = launched()
            got = fn(*args, **kwargs)
            want = plain(*args)
            err = float((got.float() - want.float()).abs().max())
            check(close(got, want, *args), f"{name} at {key(*args)} {got.dtype} differs "
                                           f"from plain on its inputs: max |err| {err}")
            errors[name] = max(errors.get(name, 0.0), err)
            shapes = seen.setdefault(name, {})
            shapes[key(*args)] = shapes.get(key(*args), 0) + launched() - before
            return got
        return fn, run

    pairs = [holding("max_pool3x3_same", max_pool3x3_same, max_pool3x3_same_plain,
                     shape_of, lambda a, b, _: torch.equal(raw_bits(a), raw_bits(b))),
             holding("fused_scale_bias_relu", fused_scale_bias_relu,
                     fused_scale_bias_relu_plain, shape_of,
                     lambda a, b, *_: bf16_close(a, b)),
             holding("conv3x3x3_bn_relu", conv3x3x3_bn_relu, conv3x3x3_bn_relu_plain,
                     lambda x, w, *_: (tuple(x.shape), w.shape[0]),
                     lambda a, b, x, w, scale, _: k3_close(a, b, x, w, scale))]
    with contextlib.ExitStack() as stack:
        for fn, run in pairs:
            stack.enter_context(swapped(fn, run))
        yield seen


def classifier_phases(dev, rng, smi_line: str, reset_counts, read_counts) -> dict:
    """Phase 24, `I3DClassifier` and `cli.classify`. Returns, per kernel,
    its launches on each run and its numbers at the classifier's shapes."""
    import contextlib
    import io
    import tempfile

    import cv2

    from step_tpu_torch.cli import classify as cli_classify
    from step_tpu_torch.models.convert import convert_torch_i3d, load_torch_checkpoint
    from step_tpu_torch.models.i3d import I3DClassifier
    from step_tpu_torch.preprocess import device_preprocess

    out = {name: dict(classifier_launches={}, classifier_shapes={}) for name in KERNELS}
    t24 = time.time()
    T, S = CLASSIFY_FRAMES, CLASSIFY_SIZE
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "i3d_kinetics.pt")
        i3d_checkpoint(path)
        sd = convert_torch_i3d(load_torch_checkpoint(path))

        def build(fused: bool):
            model = I3DClassifier(400, fused_bn_relu=fused).eval()
            model.load_state_dict(sd)
            return model.to(dev)

        def classify(model, clip, dtype=torch.bfloat16):
            with torch.no_grad():
                logits = model(device_preprocess(clip.to(dev)).to(dtype))
                return logits, torch.softmax(logits.to(torch.float32), dim=-1)

        clips = {b: [torch.from_numpy(rng.randint(0, 256, (b, T, S, S, 3)).astype(np.uint8))
                     for _ in range(REQUESTS_PER_BATCH)] for b in SERVE_BATCHES}
        medians = {}
        for config, fused in (("main", False), ("kernel", True)):
            model = build(fused)
            for b, batch in clips.items():
                times = []
                reset_counts()
                for clip in batch:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    logits, probs = classify(model, clip)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    check(tuple(logits.shape) == (b, 400) and logits.dtype == torch.bfloat16
                          and bool(torch.isfinite(logits).all()),
                          f"classifier {config} B={b}: logits {tuple(logits.shape)} "
                          f"{logits.dtype}")
                counts = read_counts()
                medians[(config, b)] = float(np.median(times[1:]))
                if not fused:      # the pool kernels alone
                    pools = {"max_pool3x3_same": len(batch) * sum(
                                 classifier_launches(b, T, S)[1].values()),
                             "max_pool3d_same": len(batch) * CLASSIFIER_STRIDED}
                    check(all(counts[k] == pools.get(k, 0) for k in counts),
                          f"the main configuration launched {counts}, not {pools}")
                    out["max_pool3d_same"]["classifier_launches"][f"main_b{b}"] = \
                        counts["max_pool3d_same"]
                    continue
                check(counts["max_pool3d_same"] == len(batch) * CLASSIFIER_STRIDED,
                      f"classifier kernel configuration B={b}: strided pools {counts}")
                for name in ("max_pool3x3_same", "fused_scale_bias_relu",
                             "conv3x3x3_bn_relu", "max_pool3d_same"):
                    out[name]["classifier_launches"][f"kernel_b{b}"] = counts[name]
                # one more request, each K3, K4 and K5 call held against
                # plain and counted by shape against classifier_launches
                errors = {}
                reset_counts()
                with held_backbone(errors) as seen:
                    classify(model, batch[0])
                    torch.cuda.synchronize()
                k4s, k5s, k3s = classifier_launches(b, T, S)
                for name, listed in (("conv3x3x3_bn_relu", k3s),
                                     ("fused_scale_bias_relu", k4s),
                                     ("max_pool3x3_same", k5s)):
                    check(seen.get(name) == listed,
                          f"classifier B={b}: {name} launched {seen.get(name)} by "
                          f"shape, classifier_launches lists {listed}")
                    check(counts[name] == len(batch) * sum(listed.values()),
                          f"classifier B={b}: {counts[name]} {name} launches in "
                          f"{len(batch)} requests, {sum(listed.values())} a request")
                print(f"[24] classifier kernel configuration B={b}: every launch held "
                      f"against plain on its own inputs (max |err| {errors}); K3 "
                      f"{sum(k3s.values())}, K4 {sum(k4s.values())}, K5 "
                      f"{sum(k5s.values())} a request, by shape as "
                      f"classifier_launches lists", flush=True)
            del model
        print(f"[24] I3DClassifier, {T} frames at {S} px, bf16, request medians of "
              f"{REQUESTS_PER_BATCH - 1} ({smi_line}): "
              f"{', '.join(f'{c} B={b} {m:.2f} ms' for (c, b), m in medians.items())}",
              flush=True)

        # every shape of a B=1 request against plain, timed
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 24)
        k4s, k5s, k3s = classifier_launches(1, T, S)
        for name, listed, case in (("max_pool3x3_same", k5s, lambda sh: pool_case(sh, gen)),
                                   ("fused_scale_bias_relu", k4s,
                                    lambda sh: bn_case(sh, gen)),
                                   ("conv3x3x3_bn_relu", k3s,
                                    lambda sh: conv_case(sh[0], sh[1], rng, dev))):
            total = dict(ms=0.0, bound_ms=0.0, plain_ms=0.0, library_ms=0.0)
            for shape, launches in listed.items():
                r = case(shape)
                for key in total:
                    total[key] += launches * (r[key] or 0.0)
                out[name]["classifier_shapes"][f"b1 {shape}"] = dict(
                    ms=r["ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"],
                    max_abs_err=r["max_abs_err"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], launches=launches)
                print(f"    {name} {shape} x{launches}: held against plain (max |err| "
                      f"{r['max_abs_err']:.3g}); bf16 device {r['ms']:.4f} ms, bound "
                      f"{r['bound_ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%}), plain "
                      f"{r['plain_ms']:.4f} ms, library "
                      f"{'none' if r['library_ms'] is None else f'{r['library_ms']:.4f} ms'}",
                      flush=True)
            print(f"[24] {name} at every B=1 classifier shape ({len(listed)} shapes, "
                  f"{sum(listed.values())} launches): device {total['ms']:.4f} ms a "
                  f"request, bound {total['bound_ms']:.4f} ms, plain "
                  f"{total['plain_ms']:.4f} ms", flush=True)

        # float32 logits: the kernel configuration against the main one
        clip = clips[1][0]
        want, p_want = classify(build(False), clip, torch.float32)
        got, p_got = classify(build(True), clip, torch.float32)
        d_logits = float((got - want).abs().max()) / float(want.abs().max())
        d_probs = float((p_got - p_want).abs().max())
        check(d_logits <= 1e-3 and d_probs <= PATH_SCORE_TOL,
              f"f32 classifier kernel configuration vs main: logits {d_logits} of their "
              f"scale, probabilities {d_probs}")
        print(f"[24] f32 B=1 classifier kernel configuration vs main: logits max |d| "
              f"{d_logits:.3g} of their scale (tol 1e-3), probabilities {d_probs:.3g} "
              f"(tol {PATH_SCORE_TOL})", flush=True)

        # cli.classify on a written frame directory and the written checkpoint
        frames = os.path.join(tmp, "frames")
        os.makedirs(frames)
        for i in range(T + 6):
            cv2.imwrite(os.path.join(frames, f"{i:05d}.jpg"),
                        rng.randint(0, 256, (240, 320, 3)).astype(np.uint8))
        argv = ["--frames-dir", frames, "--torch-ckpt", path, "--top-k", "5",
                "--num-frames", str(T), "--image-size", str(S)]
        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            probs = cli_classify.main(argv)
        lines = buf.getvalue().strip().splitlines()
        args = cli_classify.parse_args(argv)
        _, ref = classify(build(False), torch.from_numpy(cli_classify.load_frames(args)))
        d = float(np.abs(probs - ref[0].cpu().numpy()).max())
        check(len(lines) == 5 and d <= 1e-3,
              f"cli.classify printed {lines}; probabilities {d} from the model's")
        print("\n".join("    " + line for line in lines), flush=True)
        print(f"[24] cli.classify on {T + 6} written frames and the written checkpoint "
              f"(device {args.device}): top 5 printed, probabilities within {d:.3g} of "
              f"the classifier's on the same clip", flush=True)
    print(f"    phase 24 took {time.time() - t24:.1f} s", flush=True)
    return out


@contextlib.contextmanager
def launcher_calls(name: str):
    """The calls of the launcher `kernels.<name>` while the block runs: the
    kernels' custom operators look it up at each call, so this sees the
    calls a loaded program makes. Yields a list of each call's (args,
    kwargs)."""
    from step_tpu_torch import kernels

    launcher = getattr(kernels, name)
    calls = []

    def rec(*args, **kwargs):
        calls.append((args, kwargs))
        return launcher(*args, **kwargs)

    setattr(kernels, name, rec)
    try:
        yield calls
    finally:
        setattr(kernels, name, launcher)


def quiet_main(module, argv):
    """`module.main(argv)` with its standard output captured → (result,
    text)."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = module.main(argv)
    return result, buf.getvalue()


def matched_detections(got: list, want: list, label: str) -> list:
    """Pair each detection of `got` one to one with a detection of `want`
    (both of one video) of the same frame and class whose score is within rtol 1e-5 / atol
    1e-6 and whose box is within rtol 1e-4 / atol 1e-3 px
    (`tests/test_serve_protocol.py`'s bounds); fails if one has none. The
    pairs are sought by value, not by rank: at score threshold 0 a frame's
    ten detections of a class can lie an ulp apart, and two paths that
    agree to a few ulps may rank them differently. Returns the largest
    score and box differences over the pairs."""
    groups: dict = {}
    for fkey, c, score, box in want:
        groups.setdefault((fkey[1], c), []).append((score, box))
    worst = [0.0, 0.0]
    for fkey, c, score, box in got:
        group = groups.get((fkey[1], c), [])
        for i, (s, b) in enumerate(group):
            if (abs(score - s) <= 1e-6 + 1e-5 * abs(s)
                    and bool(np.all(np.abs(box - b) <= 1e-3 + 1e-4 * np.abs(b)))):
                worst = [max(worst[0], abs(score - s)),
                         max(worst[1], float(np.abs(box - b).max()))]
                del group[i]
                break
        else:
            fail(f"{label}: frame {fkey[1]} class {c}: score {score}, box {box} has no "
                 f"counterpart among the {len(group)} left")
    check(not any(groups.values()), f"{label}: detections left unmatched")
    return worst


def serving_phases(dev, rng, seeded, smi_line: str, reset_counts, read_counts) -> dict:
    """Phases 25-27: the exported program, `cli.serve` and `cli.demo`.
    Returns, per kernel, its launches on each served run, and for K1 and K2
    their device time, error and bound inside the B=8 program, for the JSON
    line."""
    import pickle
    import tempfile

    from step_tpu_torch import PRESETS, kernels
    from step_tpu_torch.cli import demo as cli_demo
    from step_tpu_torch.cli import export as cli_export
    from step_tpu_torch.cli import serve as cli_serve
    from step_tpu_torch.cli import test as cli_test
    from step_tpu_torch.cli import train as cli_train
    from step_tpu_torch.inference import _surface_plain, detect_clip
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.ops.roi_align import tube_roi_align_plain
    from step_tpu_torch.utils import export
    from step_tpu_torch.utils.vis import extract_frames, write_video

    out = {name: dict(served_launches={}) for name in KERNELS}

    def launches(path: str) -> dict:
        counts = read_counts()
        for name, n in counts.items():
            out[name]["served_launches"][path] = n
        return counts

    # ---- 25. the exported program: ucf_3step --optimized, bf16 ----------
    t25 = time.time()
    cfg = PRESETS["ucf_3step"]
    T, S = cfg.total_frames, cfg.image_size
    model = served_model(cfg, seeded, dev)
    scfg = model.cfg
    weights = export.serving_weights(model.state_dict(), scfg, dev)
    sd_bytes = sum(v.numel() * v.element_size() for v in weights.values())
    blobs, export_s = {}, {}
    for b in (8, 1):
        t0 = time.time()
        blobs[b] = export.export_detect_fn(scfg, b, model=model, device=dev)
        export_s[b] = time.time() - t0
    nodes = export.program_op_counts(blobs[8])
    print(f"[25] exported ucf_3step --optimized, {scfg.compute_dtype}, B=8 in "
          f"{export_s[8]:.1f} s (B=1 {export_s[1]:.1f} s): {len(blobs[8])} bytes against "
          f"the state dict's {sd_bytes} ({len(blobs[8]) / sd_bytes:.2%}); nodes {nodes}",
          flush=True)
    check(len(blobs[8]) < 0.1 * sd_bytes,
          f"the program takes {len(blobs[8])} bytes, 10% or more of the weights' {sd_bytes}")
    # Each step's tail is two `step::inception_block` nodes, whose pools run
    # inside them, and its reduction one `step::conv1x1x1_bias_relu`.
    blocks = 2 * scfg.num_steps
    want_nodes = {"nms_surface": 1, "tube_roi_align": scfg.num_steps, "stem_conv": 1,
                  "max_pool3x3_same": sum(backbone_launches(scfg, 8)[1].values()) - blocks,
                  "max_pool3d_same": sum(strided_launches(scfg, 8).values()),
                  "inception_block": blocks, "conv1x1x1_bias_relu": scfg.num_steps}
    check(nodes == want_nodes, f"the program holds {nodes}, not {want_nodes}")
    t0 = time.time()
    runs = {b: export.load_detect_fn(blob) for b, blob in blobs.items()}
    print(f"    loaded both programs in {time.time() - t0:.1f} s", flush=True)
    served_ms, eager_ms = {}, {}
    for b in (8, 1):
        props, pmask = STEPDetector.initial_proposals(scfg, b, device=dev)
        clip = torch.from_numpy(rng.randint(0, 256, (b, T, S, S, 3)).astype(np.uint8)).to(dev)
        reset_counts()
        with launcher_calls("nms_many_forward") as k1, \
                launcher_calls("tube_roi_align_forward") as k2:
            got = runs[b](weights, clip, props, pmask)
            torch.cuda.synchronize()
        counts = launches(f"program_b{b}")
        check(counts["nms_many"] == 1 == len(k1)
              and counts["tube_roi_align"] == scfg.num_steps == len(k2),
              f"the B={b} program launched {counts} (K1 {len(k1)}, K2 {len(k2)} calls)")
        want = detect_clip(model, clip, props, pmask)
        for key, v in got.items():
            check(v.shape == want[key].shape and bool(torch.isfinite(v).all()),
                  f"program B={b}: {key} {tuple(v.shape)} or not finite")
        d_scores = float((got["tube_scores"].float() - want["tube_scores"].float()).abs().max())
        if b == 8:
            # every kernel call the program made, held against its plain
            # version on its own inputs, then timed on them
            (a1, kw1), (a2, kw2) = k1[0], k2[-1]
            plain = _surface_plain(a1[0].transpose(1, 2), a1[1][:, 0], a1[2][:, 0],
                                   a1[3].shape[-1], a1[4], a1[5])
            k1_err = 0.0
            for name, g, w in zip(("frame_boxes", "frame_scores", "frame_mask"),
                                  (kw1["out_boxes"], kw1["out_scores"], a1[3]), plain):
                check(torch.equal(raw_bits(g), raw_bits(w)),
                      f"K1 in the program differs from plain in {name}")
                k1_err = max(k1_err, float((g.float() - w.float()).abs().max()))
            k2_err = 0.0
            for a, _ in k2:
                want2 = tube_roi_align_plain(a[0], a[1], a[2].shape[3], a[3], a[4])
                k2_err = max(k2_err, float((a[2].float() - want2.float()).abs().max()))
                check(bf16_close(a[2], want2), "K2 in the program differs from plain")
            k1_ms = device_ms(lambda: kernels.nms_many_forward(*a1, **kw1))
            k2_ms = device_ms(lambda: kernels.tube_roi_align_forward(*a2, **kw2))
            out["nms_many"].update(served_ms=k1_ms, served_max_abs_err=k1_err)
            out["tube_roi_align"].update(served_ms=k2_ms, served_max_abs_err=k2_err)
            print(f"[25] B=8 program: K1 and K2 held against plain on the program's own "
                  f"inputs (K1 bits equal, max |err| {k1_err:.3g}; K2 max |err| "
                  f"{k2_err:.3g}); device K1 "
                  f"{k1_ms:.4f} ms on [{', '.join(map(str, a1[0].shape))}] boxes, K2 "
                  f"{k2_ms:.4f} ms on [{', '.join(map(str, a2[0].shape))}]", flush=True)
        served_ms[b], served_all = median_wall_ms(
            lambda: runs[b](weights, clip, props, pmask), SERVED_REQUESTS)
        eager_ms[b], eager_all = median_wall_ms(
            lambda: detect_clip(model, clip, props, pmask), SERVED_REQUESTS)
        print(f"[25] B={b} served program ({smi_line}): median "
              f"{served_ms[b]:.2f} ms ({', '.join(f'{t:.2f}' for t in served_all)}), "
              f"{b / served_ms[b] * 1e3:.1f} clips/s; eager detect_clip {eager_ms[b]:.2f} ms "
              f"({', '.join(f'{t:.2f}' for t in eager_all)}); launches {counts}; tube "
              f"scores against eager max |d| {d_scores:.3g}", flush=True)
    out["nms_many"]["served_request_ms"] = served_ms
    out["tube_roi_align"]["served_request_ms"] = served_ms
    del runs, blobs, model, weights

    # float32, TF32 off: the program against eager detect_clip on its model
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on")
    model32 = served_model(cfg.replace(compute_dtype="float32"), seeded, dev)
    run32 = export.load_detect_fn(export.export_detect_fn(model32.cfg, 8, model=model32,
                                                          device=dev))
    props, pmask = STEPDetector.initial_proposals(scfg, 8, device=dev)
    clip = torch.from_numpy(rng.randint(0, 256, (8, T, S, S, 3)).astype(np.uint8)).to(dev)
    got = run32(export.serving_weights(model32.state_dict(), model32.cfg, dev), clip,
                props, pmask)
    want = detect_clip(model32, clip, props, pmask)
    d_scores = float((got["tube_scores"] - want["tube_scores"]).abs().max())
    d_tubes = float((got["tubes"] - want["tubes"]).abs().max())
    same_mask = torch.equal(got["frame_mask"], want["frame_mask"])
    print(f"[25] f32 B=8 program against eager detect_clip: tube scores max |d| "
          f"{d_scores:.3g} (tol {STREAM_SCORE_TOL}), tubes {d_tubes:.3g} px (tol "
          f"{STREAM_TUBE_TOL}), frame_mask {'equal' if same_mask else 'DIFFERS'}", flush=True)
    check(d_scores <= STREAM_SCORE_TOL and d_tubes <= STREAM_TUBE_TOL and same_mask,
          f"the f32 program differs from eager: scores {d_scores}, tubes {d_tubes} px, "
          f"frame_mask equal {same_mask}")
    del model32, run32
    print(f"    phase 25 took {time.time() - t25:.1f} s", flush=True)

    # ---- 26. cli.export then cli.serve against cli.test --dump ----------
    t26 = time.time()
    native = os.environ.get("STEP_TPU_DISABLE_NATIVE")
    os.environ["STEP_TPU_DISABLE_NATIVE"] = "1"         # cv2 on both sides
    with tempfile.TemporaryDirectory() as tmp:
        root, ckpt = os.path.join(tmp, "ucf"), os.path.join(tmp, "ckpt")
        videos = write_train_layout(root, cfg)
        quiet_main(cli_train, ["--preset", "ucf_3step", "--dataset", "ucf101_24",
                               "--data-root", root, "--ckpt-dir", ckpt, "--batch-size", "2",
                               "--steps", str(CLI_STEPS), "--epochs", "1",
                               "--set", "warmup_steps=1"])
        f32 = ["--optimized", "--set", "compute_dtype=float32", "--set", "score_thresh=0.0"]
        dump, prog = os.path.join(tmp, "dets.pkl"), os.path.join(tmp, "detect.pt2")
        quiet_main(cli_test, ["--data-root", root, "--ckpt-dir", ckpt, "--dump", dump,
                              *f32])
        with open(dump, "rb") as f:
            test_dets = pickle.load(f)["detections"]
        t0 = time.time()
        nbytes, _ = quiet_main(cli_export, ["--batch-size", "8", "--out", prog, *f32])
        print(f"[26] trained {CLI_STEPS} steps on {len(videos)} on-disk videos of "
              f"{CLI_FRAMES} frames; cli.export --optimized (f32) {nbytes} bytes in "
              f"{time.time() - t0:.1f} s", flush=True)
        # one directory of every video (links), then each video alone
        vdir = os.path.join(tmp, "videos")
        os.makedirs(vdir)
        for v in videos:
            os.symlink(os.path.join(root, "rgb-images", v),
                       os.path.join(vdir, os.path.basename(v)))

        def serve(frames, out_path):
            return quiet_main(cli_serve, ["--program", prog, "--ckpt-dir", ckpt,
                                          "--frames-dir", frames, "--out", out_path,
                                          "--batch-size", "8", *f32])

        reset_counts()
        t0 = time.time()
        together, text = serve(vdir, os.path.join(tmp, "all.pkl"))
        wall = time.time() - t0
        counts = launches("cli_serve")
        clips = sum(int(line.split(": ")[1].split()[0]) for line in text.splitlines()
                    if line.endswith("clips served"))
        check(counts["nms_many"] == len(videos)
              and counts["tube_roi_align"] == cfg.num_steps * len(videos),
              f"cli.serve over {len(videos)} videos of one batch each launched {counts}")
        print(f"[26] cli.serve over {len(videos)} videos ({smi_line}): {wall:.2f} s "
              f"with the program's load and the checkpoint's fold, {wall / len(videos):.2f} "
              f"s a video, {clips / wall:.2f} clips/s; {len(together)} detections; "
              f"launches {counts}", flush=True)
        for v in videos:
            name = os.path.basename(v)
            alone, _ = serve(os.path.join(root, "rgb-images", v),
                             os.path.join(tmp, f"{name}.pkl"))
            mine = [d for d in together if d[0][0] == name]
            check(len(mine) == len(alone) > 0
                  and all((a[0], a[1], a[2]) == (b[0], b[1], b[2])
                          and np.array_equal(a[3], b[3]) for a, b in zip(mine, alone)),
                  f"cli.serve of {name} in a directory differs from its own serve")
            wanted = [d for d in test_dets if d[0][0] == v]
            check(len(wanted) == len(alone), f"cli.serve of {v}: {len(alone)} detections, "
                                             f"cli.test --dump {len(wanted)}")
            worst = matched_detections(alone, wanted, v)
            print(f"[26] {v}: cli.serve alone = in the directory; = cli.test --optimized "
                  f"--dump: {len(alone)} detections, frames and classes equal, scores "
                  f"max |d| {worst[0]:.3g}, boxes {worst[1]:.3g} px", flush=True)
    if native is None:
        del os.environ["STEP_TPU_DISABLE_NATIVE"]
    else:
        os.environ["STEP_TPU_DISABLE_NATIVE"] = native
    print(f"    phase 26 took {time.time() - t26:.1f} s", flush=True)

    # ---- 27. cli.demo at the streaming preset ---------------------------
    t27 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.mp4"), os.path.join(tmp, "out.mp4")
        H, W = DEMO_SIZE
        frames = []
        for f in range(DEMO_FRAMES):
            img = np.full((H, W, 3), 0.2, np.float32) + rng.rand(H, W, 3).astype(np.float32) * 0.1
            img[60:160, 40 + 2 * f: 120 + 2 * f] = (0.9, 0.3, 0.2)
            frames.append(img)
        write_video(src, frames)
        n_in = extract_frames(src).shape[0]
        reset_counts()
        t0 = time.time()
        n, _ = quiet_main(cli_demo, ["--video", src, "--output", dst, "--score-thresh", "0.0"])
        wall = time.time() - t0
        counts = launches("cli_demo")
        n_out = extract_frames(dst).shape[0]
        print(f"[27] cli.demo, streaming preset, random weights ({smi_line}): {n_in} frames "
              f"of {W}x{H} in, {n_out} out, {wall:.2f} s; launches {counts}", flush=True)
        check(n == n_in == n_out == DEMO_FRAMES, f"cli.demo read {n_in}, wrote {n_out}")
        check(counts["nms_many"] > 0 and counts["tube_roi_align"] > 0,
              f"cli.demo launched {counts}")
    print(f"    phase 27 took {time.time() - t27:.1f} s", flush=True)
    return out


@contextlib.contextmanager
def held_backbone_launches(errors: dict):
    """Each K3, K4 and K5 launch while the block runs, at its launcher
    (`kernels.*_forward`, which the operators look up at each call, so a
    loaded program's launches are seen), held against its plain version on
    its own inputs as it is made (K5 by raw bits, K4 within one bf16 step,
    K3 by `k3_close`); yields {kernel: [(shape, bound dict), ...]}, one
    entry a launch, and fills `errors` with each kernel's largest |error|."""
    from step_tpu_torch import kernels
    from step_tpu_torch.ops.conv3d import conv3x3x3_bn_relu_plain, unpack_kernel_weight
    from step_tpu_torch.ops.fused_bn_relu import fused_scale_bias_relu_plain
    from step_tpu_torch.ops.pool import max_pool3x3_same_plain

    ncdhw = lambda t: t.permute(0, 4, 1, 2, 3)  # noqa: E731  (the kernels' NDHWC views)
    seen = {}

    def pool(x, out):
        got, want = ncdhw(out), max_pool3x3_same_plain(ncdhw(x))
        return ("max_pool3x3_same", tuple(got.shape), got, want,
                torch.equal(raw_bits(got), raw_bits(want)),
                bound(2 * x.numel() * x.element_size(), 26 * x.numel(), F32_FLOPS))

    def bn_relu(x, scale, bias, out):
        want = fused_scale_bias_relu_plain(x, scale, bias)
        return ("fused_scale_bias_relu", tuple(x.shape), out, want, bf16_close(out, want),
                bound(2 * x.numel() * x.element_size() + 2 * scale.numel() * 4,
                      3 * x.numel(), F32_FLOPS))

    def conv(x, w, scale, bias, out, **_):
        xc, K = ncdhw(x), scale.shape[0]
        weight = unpack_kernel_weight(w, xc.shape[1], K)
        got, want = ncdhw(out), conv3x3x3_bn_relu_plain(xc, weight, scale, bias)
        flop = 2 * out.numel() * 27 * xc.shape[1]
        peak = BF16_TENSOR_FLOPS if x.dtype == torch.bfloat16 else F32_FLOPS
        return ("conv3x3x3_bn_relu", (tuple(xc.shape), K), got, want,
                k3_close(got, want, xc, weight, scale),
                bound((x.numel() + weight.numel() + out.numel()) * x.element_size()
                      + 2 * K * 4, flop, peak))

    saved = {}
    for name, hold in (("max_pool3x3_forward", pool), ("scale_bias_relu_forward", bn_relu),
                       ("conv3x3x3_bn_relu_forward", conv)):
        launcher = saved[name] = getattr(kernels, name)

        def run(*args, _launcher=launcher, _hold=hold, **kwargs):
            _launcher(*args, **kwargs)
            kernel, shape, got, want, ok, b = _hold(*args, **kwargs)
            err = float((got.float() - want.float()).abs().max())
            check(ok, f"{kernel} at {shape} {got.dtype} in the program differs from plain "
                      f"on its inputs: max |err| {err}")
            errors[kernel] = max(errors.get(kernel, 0.0), err)
            seen.setdefault(kernel, []).append((shape, b))

        setattr(kernels, name, run)
    try:
        yield seen
    finally:
        for name, launcher in saved.items():
            setattr(kernels, name, launcher)


def device_ms_by_kernel(fn, fragments: dict) -> tuple[dict, float]:
    """One call of `fn` under torch.profiler → ({label: (launches, device
    ms)} for the CUDA kernels whose names hold one of `fragments[label]`,
    the device ms of all its kernels)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if device_work(e)]
    out = {label: [0, 0.0] for label in fragments}
    for e in events:
        for label, keys in fragments.items():
            if any(k in e.key for k in keys):
                out[label][0] += e.count
                out[label][1] += e.self_device_time_total / 1e3
                break
    return ({k: tuple(v) for k, v in out.items()},
            sum(e.self_device_time_total for e in events) / 1e3)


BACKBONE_KERNEL_NAMES = {"conv3x3x3_bn_relu": ("igemm_kernel", "conv_f32_kernel"),
                         "fused_scale_bias_relu": ("scale_bias_relu_kernel",),
                         "max_pool3x3_same": ("max_pool3x3_kernel",)}


def kernel_program_phases(dev, rng, seeded, smi_line: str, reset_counts,
                          read_counts) -> dict:
    """Phase 30: the kernel configuration as an exported program. Returns,
    per kernel, its launches in each served request and, for K3, K4 and
    K5, their launches, device ms, bound and error inside the B=8 program,
    for the JSON line."""
    from step_tpu_torch import PRESETS
    from step_tpu_torch.inference import detect_clip
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.models.i3d import Unit3D
    from step_tpu_torch.ops.conv3d import pack_conv_weight
    from step_tpu_torch.utils import export

    t30 = time.time()
    out = {name: dict(kernel_program_launches={}) for name in KERNELS}
    cfg = PRESETS["ucf_3step"]
    kcfg = cfg.replace(fused_bn_relu=True)
    T, S = cfg.total_frames, cfg.image_size
    k4_shapes, k5_shapes, k3_shapes = backbone_launches(cfg, 8)
    want_nodes = {"conv3x3x3_bn_relu": sum(k3_shapes.values()),
                  "scale_bias_relu": sum(k4_shapes.values()),
                  "max_pool3x3_same": sum(k5_shapes.values()),
                  "max_pool3d_same": sum(strided_launches(cfg, 8).values()),
                  "nms_surface": 1, "tube_roi_align": cfg.num_steps, "stem_conv": 1}
    node_of = {"conv3x3x3_bn_relu": "conv3x3x3_bn_relu",
               "fused_scale_bias_relu": "scale_bias_relu",
               "max_pool3x3_same": "max_pool3x3_same", "nms_many": "nms_surface",
               "tube_roi_align": "tube_roi_align", "max_pool3d_same": "max_pool3d_same"}

    def model_of(c):
        m = STEPDetector(c).eval()
        m.load_state_dict(seeded)
        return m.to(dev)                    # float32 parameters, activations in c's dtype

    def exported(c, m, b):
        return export.export_detect_fn(c, b, model=m, device=dev)

    model = model_of(kcfg)
    weights = export.serving_weights(model.state_dict(), kcfg, dev)
    sd_bytes = sum(v.numel() * v.element_size() for v in weights.values())
    blobs, export_s = {}, {}
    for b in (8, 1):
        t0 = time.time()
        blobs[b] = exported(kcfg, model, b)
        export_s[b] = time.time() - t0
    nodes = export.program_op_counts(blobs[8])
    print(f"[30] exported the kernel configuration of ucf_3step (unfolded, fused_bn_relu, "
          f"traced on the card), {kcfg.compute_dtype}, B=8 in "
          f"{export_s[8]:.1f} s (B=1 {export_s[1]:.1f} s): {len(blobs[8])} bytes against "
          f"the state dict's {sd_bytes} ({len(blobs[8]) / sd_bytes:.2%}); nodes {nodes}",
          flush=True)
    check(len(blobs[8]) < 0.1 * sd_bytes,
          f"the program takes {len(blobs[8])} bytes, 10% or more of the weights' {sd_bytes}")
    check(nodes == want_nodes, f"the B=8 program holds {nodes}, backbone_launches lists "
                               f"{want_nodes}")
    runs = {b: export.load_detect_fn(blob) for b, blob in blobs.items()}
    errors, served_ms, eager_ms = {}, {}, {}
    for b in (8, 1):
        props, pmask = STEPDetector.initial_proposals(kcfg, b, device=dev)
        clip = torch.from_numpy(rng.randint(0, 256, (b, T, S, S, 3)).astype(np.uint8)).to(dev)
        reset_counts()
        with held_backbone_launches(errors) as held:
            got = runs[b](weights, clip, props, pmask)      # no switch in the environment
            torch.cuda.synchronize()
        counts = read_counts()
        for name, n in counts.items():
            out[name]["kernel_program_launches"][f"program_b{b}"] = n
        b_nodes = export.program_op_counts(blobs[b])
        check(all(counts[k] == b_nodes[node_of[k]] for k in counts)
              and all(len(held[k]) == counts[k] for k in held),
              f"the B={b} program launched {counts}, its nodes are {b_nodes}")
        for key, v in got.items():
            check(bool(torch.isfinite(v).all()), f"kernel program B={b}: {key} not finite")
        if b == 8:
            for name in BACKBONE_KERNEL_NAMES:
                calls = held.get(name, [])
                out[name].update(kernel_program_max_abs_err=errors.get(name),
                                 kernel_program_bound_ms=sum(c[1]["bound_ms"] for c in calls))
            by_kernel, total_ms = device_ms_by_kernel(
                lambda: runs[8](weights, clip, props, pmask), BACKBONE_KERNEL_NAMES)
            units = [u for u in model.modules() if isinstance(u, Unit3D) and u.conv_bn_relu]
            n_pack, pack_ms = profiled(lambda: [pack_conv_weight(u.conv.weight,
                                                                      torch.bfloat16)
                                                for u in units])
            for name, (n, ms) in by_kernel.items():
                out[name].update(kernel_program_ms=ms, kernel_program_kernels=n)
                print(f"[30] B=8 program, {name}: {len(held.get(name, []))} launches held "
                      f"against plain on their own inputs (max |err| {errors.get(name)}); device "
                      f"{ms:.4f} ms over {n} kernels (profiler), bound "
                      f"{out[name]['kernel_program_bound_ms']:.4f} ms", flush=True)
            out["conv3x3x3_bn_relu"].update(kernel_program_pack_ms=pack_ms)
            print(f"[30] B=8 program: all kernels {total_ms:.3f} ms of device time; K3's "
                  f"bf16 weight layout made in the program from the {len(units)} units' "
                  f"float32 weights: {pack_ms:.4f} ms over {n_pack} kernels (profiler)",
                  flush=True)
        served_ms[b], served_all = median_wall_ms(
            lambda: runs[b](weights, clip, props, pmask), SERVED_REQUESTS)
        want = detect_clip(model, clip, props, pmask)
        eager_ms[b], eager_all = median_wall_ms(
            lambda: detect_clip(model, clip, props, pmask), SERVED_REQUESTS)
        d_scores = float((got["tube_scores"].float() - want["tube_scores"].float()).abs().max())
        print(f"[30] B={b} kernel program ({smi_line}): median {served_ms[b]:.2f} ms "
              f"({', '.join(f'{t:.2f}' for t in served_all)}); eager kernel configuration "
              f"{eager_ms[b]:.2f} ms ({', '.join(f'{t:.2f}' for t in eager_all)}); launches "
              f"{counts}; tube scores against eager max |d| {d_scores:.3g}", flush=True)
    for name in KERNELS:
        out[name]["kernel_program_request_ms"] = served_ms
        out[name]["kernel_eager_request_ms"] = eager_ms
    del runs, blobs, model, weights

    # float32, TF32 off: the program against the eager kernel configuration
    check(not torch.backends.cudnn.allow_tf32 and not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on")
    kcfg32 = kcfg.replace(compute_dtype="float32")
    model32 = model_of(kcfg32)
    run32 = export.load_detect_fn(exported(kcfg32, model32, 8))
    props, pmask = STEPDetector.initial_proposals(kcfg32, 8, device=dev)
    clip = torch.from_numpy(rng.randint(0, 256, (8, T, S, S, 3)).astype(np.uint8)).to(dev)
    got = run32(export.serving_weights(model32.state_dict(), kcfg32, dev), clip, props, pmask)
    want = detect_clip(model32, clip, props, pmask)
    d_scores = float((got["tube_scores"] - want["tube_scores"]).abs().max())
    d_tubes = float((got["tubes"] - want["tubes"]).abs().max())
    same_mask = torch.equal(got["frame_mask"], want["frame_mask"])
    print(f"[30] f32 B=8 kernel program against the eager kernel configuration: tube "
          f"scores max |d| {d_scores:.3g} (tol {STREAM_SCORE_TOL}), tubes {d_tubes:.3g} px "
          f"(tol {STREAM_TUBE_TOL}), frame_mask {'equal' if same_mask else 'DIFFERS'}",
          flush=True)
    check(d_scores <= STREAM_SCORE_TOL and d_tubes <= STREAM_TUBE_TOL and same_mask,
          f"the f32 kernel program differs from eager: scores {d_scores}, tubes {d_tubes} "
          f"px, frame_mask equal {same_mask}")
    print(f"    phase 30 took {time.time() - t30:.1f} s", flush=True)
    return out


BRIDGE_SYNTH = ["--steps", "4", "--batch", "2", "--image-size", "64", "--classes", "2",
                "--eval-clips", "8", "--eval-batch", "4", "--tag", "bridge",
                "--set", "backbone_depth=tiny,feature_stride=8,score_thresh=0.0,"
                         "warmup_steps=1"]


def bridge_phases(dev, smi_line: str, reset_counts, read_counts) -> dict:
    """Phase 31: the variables files and checkpoints of `train_eval_synth`
    on the card. Returns, per kernel, its launches in each run."""
    import tempfile

    from step_tpu_torch import train_eval_synth
    from step_tpu_torch.convert import from_jax_variables
    from step_tpu_torch.data.loader import DataLoader
    from step_tpu_torch.data.pipeline import build_model_batch
    from step_tpu_torch.data.synthetic import make_batch
    from step_tpu_torch.inference import detect_clip
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.train.fit import fit
    from step_tpu_torch.utils.msgpack_codec import read_variables

    t31 = time.time()
    out = {name: dict(bridge_launches={}) for name in KERNELS}
    maps = ("frame_mAP@0.5", "frame_mAP@0.2")
    argv = [*BRIDGE_SYNTH, "--device", dev.type]
    args = train_eval_synth.parse_args(argv)
    cfg = train_eval_synth.synth_config(args)
    syn = train_eval_synth.synth_data(cfg, args)

    def synth(label, *extra):
        reset_counts()
        record, _ = quiet_main(train_eval_synth, [*argv, *extra])
        counts = read_counts()
        for name, n in counts.items():
            out[name]["bridge_launches"][label] = n
        check(dev.type != "cuda" or (counts["nms_many"] > 0 and counts["tube_roi_align"] > 0),
              f"{label}: launches {counts}")
        check(record["device"] == torch.cuda.get_device_name(dev)
              and all(0.0 <= record[k] <= 1.0 for k in maps), f"{label}: {record}")
        return record

    with tempfile.TemporaryDirectory() as tmp:
        v1, v2, ckpt = (os.path.join(tmp, n) for n in ("v1.msgpack", "v2.msgpack", "ckpt"))
        trained = synth("train_save", "--save-variables", v1)
        loaded = synth("load_variables", "--load-variables", v1)
        print(f"[31] train_eval_synth ({cfg.backbone_depth}, {cfg.image_size} px, "
              f"{args.steps} steps, {smi_line}): trained {[trained[k] for k in maps]} "
              f"(loss {trained['loss_curve']}), --load-variables in a fresh call "
              f"{[loaded[k] for k in maps]}; {os.path.getsize(v1)} bytes of variables",
              flush=True)
        check(all(loaded[k] == trained[k] for k in maps) and loaded["train_s"] == 0.0,
              f"--load-variables evaluates {loaded}, training evaluated {trained}")

        clips = train_eval_synth.SyntheticClips(syn, args.steps * cfg.batch_size, 7)
        state = fit(cfg, DataLoader(clips, cfg, shuffle=False, seed=7), num_epochs=1,
                    ckpt_dir=ckpt, device=dev, handle_signals=False)
        state.model.eval()
        direct = train_eval_synth.evaluate(state.model, cfg, syn, args.eval_clips,
                                           args.eval_batch, dev)
        restored = synth("load_ckpt_dir", "--load-ckpt-dir", ckpt, "--save-variables", v2)
        check(all(restored[k] == direct[k] for k in maps),
              f"--load-ckpt-dir evaluates {restored}, the fit() model {direct}")
        sd = state.model.state_dict()
        reread = from_jax_variables(read_variables(v2), cfg)
        check(reread.keys() == sd.keys()
              and all(torch.equal(reread[k], sd[k].cpu()) for k in sd),
              "the variables file re-read differs from the fit() model's weights")
        model = STEPDetector(cfg).eval()
        model.load_state_dict(reread)
        model = model.to(dev)
        raw = make_batch(train_eval_synth.EVAL_SEED, args.eval_batch, syn)
        rgb = torch.from_numpy(build_model_batch(raw, cfg, train=False)["rgb"]).to(dev)
        props, pmask = STEPDetector.initial_proposals(cfg, args.eval_batch, device=dev)
        a, b = detect_clip(state.model, rgb, props, pmask), detect_clip(model, rgb, props, pmask)
        check(all(torch.equal(a[k], b[k]) for k in a),
              "detections from the re-read variables differ from the fit() model's")
        print(f"[31] fit() {state.step} steps → --load-ckpt-dir "
              f"{[restored[k] for k in maps]} = the fit() model's "
              f"{[direct[k] for k in maps]}; its --save-variables re-read by the port's "
              f"decoder equals the weights bit for bit ({len(sd)} tensors) and detects "
              f"the same; launches {read_counts()}", flush=True)
    try:
        import tensorstore  # noqa: F401
        print("[31] tensorstore is installed, but the JAX package that writes orbax "
              "checkpoints is not: the orbax reader is held by the CPU tests", flush=True)
    except ImportError:
        print("[31] the orbax reader (utils/jax_checkpoint.py) is NOT run here: this "
              "machine has no tensorstore; the CPU tests hold it, and a JAX run reaches "
              "the card through convert_jax_checkpoint", flush=True)
    print(f"    phase 31 took {time.time() - t31:.1f} s", flush=True)
    return out


# Phase 32: the benches at a reduced size; the fields each JSON line must
# hold (a value, or null where the run leaves it out).
BENCH_B, BENCH_ITERS, BENCH_CHUNKS = 8, 5, 8
BENCH_TINY = "backbone_depth=tiny,feature_stride=8,image_size=64,compute_dtype=float32"
BENCH_FIELDS = {
    "bench": ("metric", "value", "unit", "vs_baseline", "vs_baseline_denominator", "mfu",
              "request_flops", "request_ms_median", "p50_latency_ms", "p90_latency_ms",
              "latency_chained_mean_ms", "latency_readback_overhead_ms",
              "latency_semantics", "batch", "iters", "compile_s", "peak_memory_gib",
              "cudnn_benchmark", "config", "device"),
    "bench_train": ("metric", "value", "unit", "step_ms", "timed_steps", "mfu",
                    "step_flops", "batch", "remat_steps", "freeze_submodules",
                    "compile_s", "peak_memory_gib", "config", "device"),
    "bench_stream": ("metric", "chunks", "clip_batch", "iters", "stream_ms_per_video",
                     "stream_clips_per_sec", "per_clip_ms_per_video",
                     "per_clip_clips_per_sec", "speedup", "stem_ms", "refine_nms_ms",
                     "config", "device"),
    "bench_linking_stream": ("metric", "clips", "clip_batch", "iters",
                             "detect_ms_per_video", "link_ms_per_video",
                             "link_share_pct", "clips_per_sec_end_to_end",
                             "link_ms_by_bucket", "memory", "config", "device"),
}


def bench_phases(dev, smi_line: str, reset_counts, read_counts) -> dict:
    """Phase 32: each bench's `main(argv)` at a reduced size. Returns, per
    kernel, its launches in each bench run."""
    from step_tpu_torch import bench, bench_linking_stream, bench_stream, bench_train

    t32 = time.time()
    out = {name: dict(bench_launches={}) for name in KERNELS}
    kind = torch.cuda.get_device_name(dev)

    def run(label, module, argv, launched=()):
        reset_counts()
        rc, text = quiet_main(module, argv)
        counts = read_counts()
        check(rc == 0, f"[32] {label}: exit code {rc}")
        rec = json.loads(text.strip().splitlines()[-1])
        for name, n in counts.items():
            out[name]["bench_launches"][label] = n
        for name in launched:
            check(counts[name] > 0, f"[32] {label}: {name} never launched ({counts})")
        return rec, counts

    def held(label, module, argv, launched):
        rec, counts = run(label, module, argv, launched)
        missing = [k for k in BENCH_FIELDS[module.__name__.rsplit(".", 1)[1]]
                   if rec.get(k) is None]
        check(not missing, f"[32] {label}: fields missing or null: {missing}")
        check(rec["device"]["name"] == kind and rec["device"]["platform"] == "gpu"
              and rec["device"]["count"] == torch.cuda.device_count(),
              f"[32] {label}: device {rec['device']}")
        if "mfu" in rec:
            check(rec["mfu"] is not None and 0.0 < rec["mfu"] <= 1.05,
                  f"[32] {label}: mfu {rec['mfu']}")
        print(f"[32] {label} ({smi_line}): {json.dumps(rec)}; launches {counts}",
              flush=True)
        return rec

    serve = {}
    for config, launched in (("main", ("nms_many", "tube_roi_align")),
                             ("kernel", KERNELS)):
        serve[config] = held(f"bench --config {config}", bench,
                             ["--config", config, "--batch", str(BENCH_B),
                              "--iters", str(BENCH_ITERS)], launched)
    check(serve["main"]["request_flops"] == serve["kernel"]["request_flops"],
          f"[32] the configurations count {serve['main']['request_flops']} and "
          f"{serve['kernel']['request_flops']} FLOPs")
    train = held("bench_train", bench_train,
                 ["--batch", str(BENCH_B), "--iters", "4", "--skip-fit"],
                 ("tube_roi_align", "max_pool3x3_same"))
    held("bench_stream", bench_stream,
         ["--chunks", str(BENCH_CHUNKS), "--clip-batch", str(BENCH_CHUNKS), "--decompose"],
         ("nms_many", "tube_roi_align"))
    held("bench_linking_stream", bench_linking_stream,
         ["--clips", str(BENCH_CHUNKS), "--clip-batch", str(BENCH_CHUNKS)],
         ("nms_many", "tube_roi_align"))

    # The counter on the card against the CPU: the custom operators are one
    # op each on both, and the backwards (cuDNN's convolution_backward, K2's
    # plain backward) count alike.
    for config in ("main", "kernel"):
        tiny = ["--config", config, "--batch", "2", "--iters", "2", "--set", BENCH_TINY]
        card, _ = run(f"bench tiny {config}", bench, tiny + ["--device", "cuda"])
        cpu, _ = run(f"bench tiny {config} cpu", bench, tiny + ["--device", "cpu"])
        check(card["request_flops"] == cpu["request_flops"],
              f"[32] tiny {config} request: {card['request_flops']} FLOPs on the card, "
              f"{cpu['request_flops']} on the CPU")
    from step_tpu_torch import PRESETS
    from step_tpu_torch.train.trainer import batch_to_device, create_train_state
    from step_tpu_torch.utils.cli import apply_overrides

    cfg = apply_overrides(PRESETS["ucf_3step"], [BENCH_TINY]).replace(batch_size=2)
    host = bench_train.make_batches(cfg, 1)[0]
    flops = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        state = create_train_state(cfg, 0, device=d)
        flops[where] = bench_train.step_flops(cfg, state.model, batch_to_device(host, d), d)
    check(flops["card"] == flops["cpu"],
          f"[32] tiny train step: {flops['card']} FLOPs on the card, {flops['cpu']} on the CPU")
    print(f"[32] FLOPs a request: {serve['main']['request_flops']} in both configurations "
          f"at B={BENCH_B}; a train step {train['step_flops']} at B={BENCH_B}; the tiny "
          f"detector's request and train step ({flops['card']}) count alike on the card "
          f"and the CPU", flush=True)
    print(f"    phase 32 took {time.time() - t32:.1f} s", flush=True)
    return out


def free_port() -> int:
    """A free TCP port on 127.0.0.1 for a process group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def held_calls():
    """Every K1, K2 and K5 call the port makes while the block runs, each
    held against its plain version on the same inputs as it is made: K1
    (`nms_surface`) and K5 (`max_pool3x3_same`, also the forward of the
    training step's stride-1 pools) by raw bits, K2 (`tube_roi_align`, under
    autograd in training) within one bf16 step (float32: 1e-4). Yields
    {kernel: [calls held, max |err|]}."""
    from step_tpu_torch.inference import nms_surface, nms_surface_plain
    from step_tpu_torch.ops.pool import max_pool3x3_same, max_pool3x3_same_plain
    from step_tpu_torch.ops.roi_align import tube_roi_align, tube_roi_align_plain

    held = {"nms_many": [0, 0.0], "tube_roi_align": [0, 0.0], "max_pool3x3_same": [0, 0.0]}

    def nms(*args):
        got = nms_surface(*args)
        want = nms_surface_plain(*args)
        for key in ("frame_boxes", "frame_scores", "frame_mask"):
            check(torch.equal(raw_bits(got[key]), raw_bits(want[key])),
                  f"K1 at {list(args[0].shape)} differs from plain in {key}")
        held["nms_many"][0] += 1
        return got

    def roi(features, tubes, *args):
        got = tube_roi_align(features, tubes, *args)
        with torch.no_grad():
            want = tube_roi_align_plain(features.detach(), tubes.detach(), *args)
            err = float((got.detach().float() - want.float()).abs().max())
            ok = (bf16_close(got.detach(), want) if got.dtype == torch.bfloat16
                  else torch.allclose(got.detach(), want, rtol=1e-4, atol=1e-4))
        check(ok, f"K2 at {list(features.shape)} {got.dtype} differs from plain: {err}")
        held["tube_roi_align"][0] += 1
        held["tube_roi_align"][1] = max(held["tube_roi_align"][1], err)
        return got

    def pool(x):
        got = max_pool3x3_same(x)
        check(torch.equal(raw_bits(got), raw_bits(max_pool3x3_same_plain(x))),
              f"K5 at {list(x.shape)} {x.dtype} differs from plain")
        held["max_pool3x3_same"][0] += 1
        return got

    with swapped(nms_surface, nms), swapped(tube_roi_align, roi), \
            swapped(max_pool3x3_same, pool):
        yield held


def step_profile(fn) -> dict:
    """One call of `fn` under torch.profiler: its CUDA kernels, those of
    NCCL among them and their device ms, the collectives the host issued
    (`nccl:*` / `gloo:*` events), and the device ms of all kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = [e for e in events if device_work(e)]
    nccl = [e for e in cuda if "nccl" in e.key.lower()]
    return dict(kernels=sum(e.count for e in cuda),
                device_ms=sum(e.self_device_time_total for e in cuda) / 1e3,
                nccl_kernels=sum(e.count for e in nccl),
                nccl_ms=sum(e.self_device_time_total for e in nccl) / 1e3,
                collectives={e.key: e.count for e in events
                             if e.device_type == torch.autograd.DeviceType.CPU
                             and e.key.startswith(("nccl:", "gloo:"))})


def kernel_counters():
    """(reset, read) of the launch counts of each of KERNELS
    (`KERNEL_OPS`)."""
    from step_tpu_torch.ops.kernel_op import LAUNCHES

    def reset():
        for ops in KERNEL_OPS.values():
            for op in ops:
                LAUNCHES[op] = 0

    def read():
        return {name: sum(LAUNCHES[op] for op in ops) for name, ops in KERNEL_OPS.items()}

    return reset, read


def dp_loader(cfg, process_count: int, process_index: int):
    """Process `process_index`'s DataLoader of a `process_count`-process
    run over DP2_STEPS global batches of synthetic clips: its share of the
    global batch, its strided slice of each epoch."""
    from step_tpu_torch.data.loader import DataLoader
    from step_tpu_torch.data.synthetic import SyntheticConfig
    from step_tpu_torch.train_eval_synth import SyntheticClips

    syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                          num_classes=cfg.num_classes, max_boxes=4)
    return DataLoader(SyntheticClips(syn, DP2_STEPS * cfg.batch_size, SEED * 1000), cfg,
                      batch_size=cfg.batch_size // process_count, seed=SEED, num_workers=4,
                      process_count=process_count, process_index=process_index)


class InterleavedBatches:
    """The one-process loader of a two-process run's global batches: batch k
    is the ranks' batches k interleaved, row i of rank r at i·2 + r, where
    `process_shard` took it from."""

    def __init__(self, cfg):
        self.loaders = [dp_loader(cfg, 2, r) for r in range(2)]

    def epoch(self, epoch, start=0):
        for parts in zip(*(ld.epoch(epoch, start) for ld in self.loaders)):
            yield {k: np.stack([p[k] for p in parts], axis=1).reshape(-1, *parts[0][k].shape[1:])
                   for k in parts[0] if k != "meta"}


def dp_eval_setup(dev, dtype=torch.bfloat16):
    """The evaluation of phases 28-29: `ucf_3step` at full width in `dtype`
    with seeded weights, score threshold 0, on DP_EVAL_VIDEOS synthetic
    videos (10 windows each: batches of 8 and 2)."""
    from step_tpu_torch import PRESETS
    from step_tpu_torch.data.memory import MemoryUCF
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.utils.init import init_detector_

    cfg = PRESETS["ucf_3step"].replace(score_thresh=0.0,
                                       compute_dtype=str(dtype).removeprefix("torch."))
    model = init_detector_(STEPDetector(cfg).eval(), SEED + 5).to(dev, dtype)
    return model, MemoryUCF(cfg, DP_EVAL_VIDEOS, EVAL_FRAMES, EVAL_RESOLUTION, SEED + 6)


def dp_worker(rank: int, world: int, port: int, tmp: str) -> None:
    """One rank of phase 29, in a process of its own: a gloo group on the
    one card. `fit(mesh=...)` at full width in float32, global
    B=TRAIN_BATCH, on its loader, then `evaluate_ucf` and
    `collect_video_tubes` over the mesh in float32, every
    K1, K2 and K5 call held against plain; writes what it computed to
    `<tmp>/rank<r>.pt` (a failure's traceback to `rank<r>.err`)."""
    import traceback

    try:
        import torch.distributed as dist

        from step_tpu_torch.evaluate import collect_video_tubes, evaluate_ucf
        from step_tpu_torch.models.detector import STEPDetector
        from step_tpu_torch.parallel import create_mesh, init_distributed
        from step_tpu_torch.utils.init import init_detector_train_

        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        check(init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo")
              == (rank, world), "init_distributed")
        mesh = create_mesh()
        reset, read = kernel_counters()
        cfg = train_cfg("ucf_3step", TRAIN_BATCH, compute_dtype="float32")
        model = init_detector_train_(STEPDetector(cfg), cfg, SEED)
        reset()
        with held_calls() as held_train:
            state, steps, memory = timed_fit(
                dict(cfg=cfg, loader=dp_loader(cfg, world, rank), num_epochs=1,
                     model=model, device=dev, seed=SEED, mesh=mesh), read)
        sd = {k: v.cpu() for k, v in state.model.state_dict().items()}
        del state, model
        emodel, data = dp_eval_setup(dev, torch.float32)
        reset()
        with held_calls() as held_eval:
            results = evaluate_ucf(emodel, data, mesh=mesh,
                                   dump_path=os.path.join(tmp, f"dets{rank}.pkl"))
            tubes = collect_video_tubes(emodel, data, mesh=mesh)
            torch.cuda.synchronize()
        torch.save(dict(steps=[(ms, c, {k: v.cpu() for k, v in m.items()})
                               for ms, c, m in steps],
                        memory=memory, state=sd, held_train=held_train, results=results,
                        tubes=tubes, held_eval=held_eval, eval_launches=read(),
                        backend=str(dist.get_backend())),
                   os.path.join(tmp, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise


def parallel_phases(dev, smi_line: str, reset_counts, read_counts) -> dict:
    """Phase 28, data parallelism on one rank (NCCL), and phase 29, two ranks
    on the one card (gloo). The sharded runs are held against the plain ones
    in float32: in bf16 a last-bit difference of BatchNorm's statistics
    (sums over the group against means) flips a bf16 rounding of some
    activations, and two AdamW steps grow that to a loss 1.5% apart (a
    one-rank bf16 run of this phase). Returns, per kernel, its launches on
    each run, for the JSON line."""
    import io
    import pickle
    import tempfile

    import torch.distributed as dist

    from step_tpu_torch.cli import test as cli_test
    from step_tpu_torch.cli import train as cli_train
    from step_tpu_torch.evaluate import collect_video_tubes, evaluate_ucf
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.parallel import create_mesh, init_distributed
    from step_tpu_torch.train.trainer import (batch_to_device, make_parallel_train_step,
                                              make_schedule, train_step)
    from step_tpu_torch.utils.init import init_detector_train_

    out = {name: dict(parallel_launches={}) for name in KERNELS}

    def fits(label, cfg, mesh, loader, hold, n=DP_STEPS):
        """fit() of `n` steps from phase 14's init: (state, steps, held,
        memory)."""
        model = init_detector_train_(STEPDetector(cfg), cfg, SEED)
        reset_counts()
        with held_calls() if hold else contextlib.nullcontext({}) as held:
            state, steps, memory = timed_fit(
                dict(cfg=cfg, loader=loader, num_epochs=1, model=model, device=dev,
                     seed=SEED, mesh=mesh), read_counts)
        check(len(steps) == n == state.step, f"{label}: {len(steps)} steps")
        return state, steps, held, memory

    def fit_diff(got_steps, got_sd, want_steps, want_sd, cfg) -> dict:
        """How far two fits are apart: the largest relative difference of a
        step's loss, the weights beyond 1e-5 (fatal if one is more than 2 lr
        a step apart) and the largest, and the BN statistics' largest
        difference relative to their tensor's largest value."""
        got_l = [float(m["loss"]) for _, _, m in got_steps]
        want_l = [float(m["loss"]) for _, _, m in want_steps]
        lr = sum(make_schedule(cfg)(s) for s in range(len(want_l)))
        far, total, worst = far_weights(got_sd, want_sd, lr,
                                        [k for k in want_sd if "running_" not in k])
        stat = max(float((got_sd[k].float() - want_sd[k].float()).abs().max()
                         / want_sd[k].float().abs().max().clamp(min=1e-3))
                   for k in want_sd if "running_" in k)
        return dict(losses=got_l, loss_rel=max(abs(a - b) / abs(b)
                                               for a, b in zip(got_l, want_l)),
                    far=far, total=total, worst=worst, lr=lr, stat=stat)

    def same_fit(label, got, spread, weights_like_spread: bool = True) -> str:
        """`got` (a `fit_diff` against a plain run) within the bounds: losses
        a step within 1e-3 relative; weights within 2 lr a step, and no more
        of them beyond 1e-5 than 1.5 times `spread`, the `fit_diff` of a
        second plain run against the first (the card's training is not
        bitwise repeatable: its backward sums with atomics), and BN
        statistics no further apart than 3 times its (one pair of runs
        estimates that tail loosely); or 0.1% and 1e-2 if those are more
        (two plain runs of phase 28 were 6e-4 to 3e-3 apart). Without
        `weights_like_spread` the share and the statistics are reported,
        not held: two ranks perturb more than a rerun does (halves of the
        batch through the convolutions, sums over two ranks), and AdamW
        turns the perturbation into steps of either sign."""
        far_tol = max(1e-3 * got["total"], 1.5 * spread["far"])
        stat_tol = max(1e-2, 3 * spread["stat"])
        check(got["loss_rel"] <= 1e-3, f"{label}: losses {got['losses']}, "
                                       f"{got['loss_rel']:.3g} apart")
        if weights_like_spread:
            check(got["far"] <= far_tol, f"{label}: {got['far']} of {got['total']} "
                                         f"weights beyond 1e-5, tol {far_tol:.0f}")
            check(got["stat"] <= stat_tol,
                  f"{label}: BN statistics {got['stat']:.3g} apart")
        else:
            far_tol = stat_tol = float("nan")
        return (f"losses {', '.join(f'{v:.5f}' for v in got['losses'])} (max rel "
                f"{got['loss_rel']:.3g}, tol 1e-3; a second plain run "
                f"{spread['loss_rel']:.3g}); weights {got['far']} of {got['total']} beyond "
                f"1e-5 (a second plain run {spread['far']}; tol {far_tol:.0f}), max |d| "
                f"{got['worst']:.3g} (tol 2 lr a step = {2 * got['lr']:.3g}); BN statistics "
                f"{got['stat']:.3g} relative (a second plain run {spread['stat']:.3g}, tol "
                f"{stat_tol:.3g})")

    def check_per_step(label, steps):
        per = {k: sorted({c[k] for _, c, _ in steps}) for k in steps[0][1]}
        check(per["tube_roi_align"] == [6] and per["max_pool3x3_same"] == [19],
              f"{label}: launches a step {per} (want K2 6 and K5 19, as phase 14)")
        return per

    # ---- 28. one rank on NCCL --------------------------------------------
    t28 = time.time()
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()), RANK="0",
               WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    cfg = train_cfg("ucf_3step", TRAIN_BATCH)
    cfg32 = cfg.replace(compute_dtype="float32")
    try:
        check(init_distributed() == (0, 1), "init_distributed on one rank")
        mesh = create_mesh()
        print(f"[28] one rank: backend {dist.get_backend()}, mesh {mesh}", flush=True)
        plain, p_steps, _, _ = fits("plain fit", cfg32, None,
                                    synthetic_loader(cfg32, DP_STEPS), False)
        p_sd = plain.model.state_dict()
        again, a_steps, _, _ = fits("plain fit again", cfg32, None,
                                    synthetic_loader(cfg32, DP_STEPS), False)
        spread = fit_diff(a_steps, again.model.state_dict(), p_steps, p_sd, cfg32)
        del again
        sharded, s_steps, held, memory = fits("sharded fit", cfg32, mesh,
                                              synthetic_loader(cfg32, DP_STEPS), True)
        per = check_per_step("sharded fit", s_steps)
        check(held["tube_roi_align"][0] == 6 * DP_STEPS
              and held["max_pool3x3_same"][0] == 19 * DP_STEPS,
              f"sharded fit: calls held {held}")
        for name in KERNELS:
            out[name]["parallel_launches"]["sharded_fit_step"] = max(
                c[name] for _, c, _ in s_steps)
        text = same_fit("sharded fit against plain fit",
                        fit_diff(s_steps, sharded.model.state_dict(), p_steps, p_sd, cfg32),
                        spread)
        print(f"[28] fit(mesh=create_mesh()) ucf_3step full width, float32, B={TRAIN_BATCH}, "
              f"{DP_STEPS} steps, against plain fit() on the same seed and batches: {text}; "
              f"{memory}", flush=True)
        print(f"    launches a step {per}; every call held against plain: K2 "
              f"{held['tube_roi_align'][0]} (max |err| {held['tube_roi_align'][1]:.3g}, one "
              f"bf16 step), K5 {held['max_pool3x3_same'][0]} (raw bits)", flush=True)

        del plain, sharded
        # The step alone on one fixed batch, in bf16 (the training
        # configuration), sharded and plain in turns from the same init.
        from step_tpu_torch.data.pipeline import build_model_batch
        from step_tpu_torch.data.synthetic import SyntheticConfig, make_batch
        from step_tpu_torch.train.trainer import create_train_state

        sharded, plain = (create_train_state(cfg, seed=SEED, device=dev) for _ in range(2))

        syn = SyntheticConfig(image_size=cfg.image_size, num_frames=cfg.total_frames,
                              num_classes=cfg.num_classes, max_boxes=4)
        fixed = batch_to_device(build_model_batch(make_batch(SEED + 77, TRAIN_BATCH, syn),
                                                  cfg, train=True, emit_uint8=True), dev)
        pstep = make_parallel_train_step(cfg, sharded.model, mesh)
        steps_of = {"sharded": lambda: pstep(sharded, fixed),
                    "plain": lambda: train_step(plain, fixed, cfg)}
        ms = {k: [] for k in steps_of}
        for _ in range(DP_TIMED):
            for k, fn in steps_of.items():
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                ms[k].append(start.elapsed_time(end))
        med = {k: float(np.median(v[1:])) for k, v in ms.items()}
        prof = {k: step_profile(fn) for k, fn in steps_of.items()}
        print(f"[28] the bf16 step alone on one fixed batch, {DP_TIMED} in turns ({smi_line}): "
              f"sharded median {med['sharded']:.2f} ms ({', '.join(f'{v:.1f}' for v in ms['sharded'])}), "
              f"plain {med['plain']:.2f} ms ({', '.join(f'{v:.1f}' for v in ms['plain'])}), "
              f"ratio {med['sharded'] / med['plain']:.3f}", flush=True)
        print(f"    profiler, one step each: {json.dumps(prof)}", flush=True)
        out["tube_roi_align"]["parallel_step_ms"] = med
        out["tube_roi_align"]["parallel_step_profile"] = prof
        del plain, sharded, pstep, fixed, steps_of

        emodel, data = dp_eval_setup(dev)
        with tempfile.TemporaryDirectory() as tmp:
            runs = {}
            for label, m in (("unsharded", None), ("sharded", mesh)):
                reset_counts()
                with held_calls() as held_e:
                    res = evaluate_ucf(emodel, data, mesh=m,
                                       dump_path=os.path.join(tmp, f"{label}.pkl"))
                    torch.cuda.synchronize()
                counts = read_counts()
                with open(os.path.join(tmp, f"{label}.pkl"), "rb") as f:
                    runs[label] = (res, pickle.load(f)["detections"], counts, held_e)
            (r_s, d_s, c_s, h_s), (r_u, d_u, _, _) = runs["sharded"], runs["unsharded"]
        check_eval_results(r_s, "sharded evaluate_ucf")
        check(len(d_s) == len(d_u) > 0 and all(
            a[:3] == b[:3] and np.array_equal(a[3], b[3]) for a, b in zip(d_s, d_u)),
            "sharded evaluate_ucf's detections differ from the unsharded run's")
        for key in ("frame_mAP@0.5", "video_mAP@0.2", "video_mAP@0.5", "video_mAP@0.5:0.95"):
            check(r_s[key] == r_u[key] or (np.isnan(r_s[key]) and np.isnan(r_u[key])),
                  f"sharded evaluate_ucf {key}: {r_s[key]} against {r_u[key]}")
        check(c_s["nms_many"] > 0 and c_s["tube_roi_align"] == 3 * c_s["nms_many"]
              and h_s["nms_many"][0] == c_s["nms_many"]
              and h_s["tube_roi_align"][0] == c_s["tube_roi_align"],
              f"sharded evaluate_ucf: launches {c_s}, held {h_s}")
        for name in KERNELS:
            out[name]["parallel_launches"]["sharded_evaluate_ucf"] = c_s[name]
        print(f"[28] evaluate_ucf(mesh=...) on {len(data)} windows, bf16, score_thresh 0: "
              f"{len(d_s)} detections equal to the unsharded run's, mAPs equal "
              f"(frame_mAP@0.5 {r_s['frame_mAP@0.5']:.4f}); launches {c_s}, every K1 "
              f"(raw bits) and K2 call held (max |err| {h_s['tube_roi_align'][1]:.3g})",
              flush=True)
        del emodel

        with tempfile.TemporaryDirectory() as tmp:
            root, ckpt = os.path.join(tmp, "ucf"), os.path.join(tmp, "ckpt")
            write_train_layout(root, cfg)
            for path, module, argv, expect, kernels_run in (
                    ("cli_train_distributed", cli_train,
                     ["--preset", "ucf_3step", "--dataset", "ucf101_24", "--data-root", root,
                      "--ckpt-dir", ckpt, "--batch-size", "2", "--steps", str(CLI_STEPS),
                      "--epochs", "1", "--distributed", "--set", "warmup_steps=1"],
                     ("distributed: process 0/1", f"trained to step {CLI_STEPS}"),
                     ("tube_roi_align", "max_pool3x3_same")),
                    ("cli_test_sharded", cli_test,
                     ["--data-root", root, "--ckpt-dir", ckpt, "--max-batches", "2",
                      "--set", "score_thresh=0.0", "--sharded"],
                     ("sharded eval over 1 devices", "frame_mAP@0.5:", "timings:"),
                     ("nms_many", "tube_roi_align"))):
                buf = io.StringIO()
                reset_counts()
                with contextlib.redirect_stdout(buf):
                    module.main(argv)
                    torch.cuda.synchronize()
                counts = read_counts()
                text = buf.getvalue()
                missing = [k for k in expect if k not in text]
                check(not missing and all(counts[k] > 0 for k in kernels_run),
                      f"{path}: the output lacks {missing}; launches {counts}")
                for name in KERNELS:
                    out[name]["parallel_launches"][path] = counts[name]
                print("\n".join("    " + line for line in text.splitlines()[-6:]), flush=True)
                print(f"[28] {path}: launches {counts}", flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(f"    phase 28 took {time.time() - t28:.1f} s", flush=True)

    # ---- 29. two ranks on the one card, gloo -----------------------------
    t29 = time.time()
    torch.cuda.empty_cache()
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        port = free_port()
        procs = [ctx.Process(target=dp_worker, args=(r, 2, port, tmp)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        for r, p in enumerate(procs):
            if p.is_alive():
                p.kill()
                p.join()
            err = os.path.join(tmp, f"rank{r}.err")
            check(p.exitcode == 0, f"phase 29 rank {r} exited {p.exitcode}: "
                  + (open(err).read()[-3000:] if os.path.exists(err) else ""))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        dets = []
        for r in range(2):
            with open(os.path.join(tmp, f"dets{r}.pkl"), "rb") as f:
                dets.append(pickle.load(f)["detections"])
    print(f"[29] two ranks on the one card, backend {ranks[0]['backend']}: both ran "
          f"fit(mesh=...) and the evaluation in {time.time() - t29:.1f} s", flush=True)
    r0, r1 = ranks
    for a, b in zip(r0["steps"], r1["steps"]):
        check(all(torch.equal(a[2][k], b[2][k]) for k in a[2]),
              "phase 29: the ranks' metrics differ")
    check(all(torch.equal(r0["state"][k], r1["state"][k]) for k in r0["state"]),
          "phase 29: the ranks' final weights differ")
    for r, rank in enumerate(ranks):
        check(len(rank["steps"]) == DP2_STEPS, f"rank {r}: {len(rank['steps'])} steps")
        check_per_step(f"rank {r}", rank["steps"])
        held = rank["held_train"]
        check(held["tube_roi_align"][0] == 6 * DP2_STEPS
              and held["max_pool3x3_same"][0] == 19 * DP2_STEPS,
              f"rank {r}: calls held {held}")
    for name in ("nms_many", "tube_roi_align", "max_pool3x3_same"):
        out[name]["parallel_launches"]["two_rank_fit_step"] = max(
            c[name] for _, c, _ in r0["steps"])
        out[name]["parallel_launches"]["two_rank_evaluation"] = r0["eval_launches"][name]
    two_ms = float(np.median([ms for ms, _, _ in r0["steps"]][1:]))
    cfg = train_cfg("ucf_3step", TRAIN_BATCH, compute_dtype="float32")
    runs = [fits("one-process fit", cfg, None, InterleavedBatches(cfg), False, DP2_STEPS)
            for _ in range(2)]
    (one, o_steps, _, _), (again, a_steps, _, _) = runs
    o_sd = {k: v.cpu() for k, v in one.model.state_dict().items()}
    spread = fit_diff(a_steps, {k: v.cpu() for k, v in again.model.state_dict().items()},
                      o_steps, o_sd, cfg)
    del runs, again
    text = same_fit("two-rank fit against one process",
                    fit_diff(r0["steps"], r0["state"], o_steps, o_sd, cfg), spread,
                    weights_like_spread=False)
    one_ms = float(np.median([ms for ms, _, _ in o_steps][1:]))
    out["tube_roi_align"]["two_rank_step_ms"] = dict(two_rank=two_ms, one_process=one_ms)
    print(f"[29] fit(mesh) float32 at a global B={TRAIN_BATCH} ({TRAIN_BATCH // 2} a rank), "
          f"{DP2_STEPS} steps: both ranks' metrics and final weights equal bit for bit; "
          f"against one process on the same global batches: {text}", flush=True)
    print(f"    step ms ({smi_line}): rank 0 {', '.join(f'{ms:.1f}' for ms, _, _ in r0['steps'])} "
          f"(median after the first {two_ms:.2f}); one process "
          f"{', '.join(f'{ms:.1f}' for ms, _, _ in o_steps)} (median {one_ms:.2f}); "
          f"{r0['memory']}", flush=True)
    print(f"    every K2 and K5 call held in each rank: K2 "
          f"{[r['held_train']['tube_roi_align'][0] for r in ranks]} (max |err| "
          f"{max(r['held_train']['tube_roi_align'][1] for r in ranks):.3g}), K5 "
          f"{[r['held_train']['max_pool3x3_same'][0] for r in ranks]} (raw bits)", flush=True)
    del one
    emodel, data = dp_eval_setup(dev, torch.float32)
    with tempfile.TemporaryDirectory() as tmp:
        want = evaluate_ucf(emodel, data, dump_path=os.path.join(tmp, "dets.pkl"))
        with open(os.path.join(tmp, "dets.pkl"), "rb") as f:
            want_dets = pickle.load(f)["detections"]
    want_tubes = collect_video_tubes(emodel, data)
    for r, rank in enumerate(ranks):
        label = f"rank {r} two-rank evaluate_ucf"
        check(rank["results"]["timings"]["n_detections"] == want["timings"]["n_detections"],
              f"{label}: {rank['results']['timings']['n_detections']} detections against "
              f"{want['timings']['n_detections']}")
        worst = [0.0, 0.0]
        for video in {d[0][0] for d in want_dets}:
            w = matched_detections([d for d in dets[r] if d[0][0] == video],
                                   [d for d in want_dets if d[0][0] == video], label)
            worst = [max(a, b) for a, b in zip(worst, w)]
        for key in ("frame_mAP@0.5", "video_mAP@0.2", "video_mAP@0.5"):
            a, b = rank["results"][key], want[key]
            check(abs(a - b) <= EVAL_MAP_TOL or (np.isnan(a) and np.isnan(b)),
                  f"{label} {key}: {a} against {b}")
        n, box_err, score_err = same_tubes(rank["tubes"], want_tubes,
                                           f"rank {r} two-rank collect_video_tubes")
        held = rank["held_eval"]
        check(held["nms_many"][0] == rank["eval_launches"]["nms_many"] > 0
              and held["tube_roi_align"][0] == rank["eval_launches"]["tube_roi_align"],
              f"rank {r} evaluation: held {held}, launches {rank['eval_launches']}")
        print(f"[29] rank {r}: evaluate_ucf(mesh) {len(dets[r])} detections matched one to "
              f"one with the unsharded run's (scores {worst[0]:.3g}, boxes {worst[1]:.3g} "
              f"px), mAPs within {EVAL_MAP_TOL}; collect_video_tubes(mesh) {n} tubes "
              f"matched (boxes {box_err:.3g} px, scores {score_err:.3g}); K1 "
              f"{held['nms_many'][0]} and K2 {held['tube_roi_align'][0]} calls held",
              flush=True)
    print(f"    phase 29 took {time.time() - t29:.1f} s", flush=True)
    return out


def main() -> None:
    t_start = time.time()
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test runs only on the card")
    from step_tpu_torch import PRESETS, kernels
    from step_tpu_torch.inference import detect_clip, nms_surface, nms_surface_plain
    from step_tpu_torch.models.detector import STEPDetector
    from step_tpu_torch.models.optimize import optimize_for_inference
    from step_tpu_torch.ops.nms import _f32, nms_many, nms_many_plain, premask_scores
    from step_tpu_torch.ops.roi_align import tube_roi_align, tube_roi_align_plain
    from step_tpu_torch.utils.init import init_detector_

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    # ---- 1. device -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"[1] device {kind} (count {count}), torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; nvidia-smi name, power limit:", flush=True)
    print(smi.stdout.strip(), flush=True)

    # ---- 2. build --------------------------------------------------------
    t0 = time.time()
    path, log = kernels.build()
    kernels.library()
    print(f"[2] kernels built in {time.time() - t0:.1f} s → {path.name}", flush=True)
    for line in log.splitlines():
        if ("registers" in line or "spill" in line or "Compiling entry" in line
                or "wgmma" in line):
            print("    " + line.strip())
    n_hgmma = hgmma_count(path, kernels.nvcc_path())
    n_stem_hgmma = hgmma_count(path, kernels.nvcc_path(), "stem_conv_kernel")
    n_tube_hgmma = hgmma_count(path, kernels.nvcc_path(), "tube_conv_kernel")
    print(f"    HGMMA instructions in the implicit GEMM's kernels (K3, the 1x1x1 conv): "
          f"{n_hgmma}; in the stem conv kernels: {n_stem_hgmma}; in the tube conv "
          f"kernels: {n_tube_hgmma}", flush=True)

    rng = np.random.RandomState(SEED)
    results = {}

    # ---- 3. K1: NMS ------------------------------------------------------
    cfg = PRESETS["ucf_3step"]
    B, T, C, P = 8, cfg.total_frames, cfg.num_classes, cfg.max_proposals
    K = min(cfg.max_detections, P)
    thr, sthr = cfg.nms_thresh, cfg.score_thresh
    # Problems apart through nms_many: (a) B=8, (b) B=64, the streaming
    # batch, (c) one problem, K1's latency floor, at the serving P and K;
    # (d) P=64 and P=1024; and K > P.
    nms_ms = {}
    for label, N, p, k in (("B=8", B * T * C, P, K), ("B=64", 64 * T * C, P, K),
                           ("N=1", 1, P, K), ("P=64", B * T * C, 64, K),
                           ("P=1024", B * T, 1024, K), ("K>P", 500, 12, 20)):
        # (the last of two rows for N=1: the first is all invalid)
        boxes, scores, valid = (torch.from_numpy(a[-N:]).to(dev)
                                for a in nms_inputs(rng, max(N, 2), p))
        idx_k, mask_k = nms_many(boxes, scores, thr, k, sthr, valid)
        idx_p, mask_p = nms_many_plain(boxes, premask_scores(scores, sthr, valid), thr, k)
        torch.cuda.synchronize()
        check(torch.equal(idx_k, idx_p) and torch.equal(mask_k, mask_p),
              f"K1 nms kernel differs from plain at {label}: "
              f"{int((idx_k != idx_p).sum())} idx, {int((mask_k != mask_p).sum())} mask")
        kept = mask_k.sum(dim=1)
        keep_idx, keep_mask = torch.empty_like(idx_k), torch.empty_like(mask_k)
        nms_ms[label] = device_ms(lambda: kernels.nms_many_forward(
            boxes[:, None], scores[:, None, :, None], valid[:, None],
            keep_mask.view(N, 1, 1, k), _f32(thr), _f32(sthr),
            keep_idx=keep_idx.view(N, 1, 1, k)))
        # Bytes: boxes, scores and valid read (24 a box), indices and mask
        # written (8 a slot).
        case_bound = bound(N * p * 24 + N * k * 8, float(kept.sum()) * p * 13, F32_FLOPS)
        print(f"[3] K1 nms exact at {label}: {N} problems (P={p}, K={k}), "
              f"{int(boxes.isnan().any(-1).sum())} NaN and {int(boxes.isinf().any(-1).sum())} "
              f"infinite boxes; {int((kept == 0).sum())} empty, "
              f"{int(((kept > 0) & (kept < k)).sum())} exhausted before K, "
              f"{int((kept == k).sum())} full; kernel device {nms_ms[label]:.4f} ms, "
              f"bound {case_bound['bound_ms']:.6f} ms", flush=True)
    # The surface as the main path calls it, at B=8 and B=64, scores in
    # float32 and bfloat16: one launch on the compact tubes, scores and mask.
    # Bytes: those read once, frame_boxes, frame_scores and frame_mask
    # written once; each kept box takes one IoU pass over its problem's P
    # boxes (~13 f32 ops). K1's earlier interface read B*T*C expanded copies
    # of the boxes, scores and valid mask (24 bytes a box) and wrote indices
    # and mask (8 bytes a slot): its bound is printed beside.
    surface_bound = {}
    for b in (B, 64):
        tubes, tscores, pmask = surface_inputs(rng, b, P, T, C, dev)
        for scores in (tscores, tscores.to(torch.bfloat16)):
            got = nms_surface(tubes, scores, pmask, cfg)
            want = nms_surface_plain(tubes, scores, pmask, cfg)
            torch.cuda.synchronize()
            for key in ("frame_boxes", "frame_scores", "frame_mask"):
                check(got[key].dtype == want[key].dtype
                      and torch.equal(raw_bits(got[key]), raw_bits(want[key])),
                      f"K1 nms_surface B={b} {scores.dtype} differs from plain in {key}")
        out = {key: torch.empty_like(v) for key, v in got.items() if key.startswith("frame")}
        nms_ms[b] = device_ms(lambda: kernels.nms_many_forward(
            tubes.transpose(1, 2), tscores[:, None].expand(b, T, P, C),
            pmask[:, None].expand(b, T, P), out["frame_mask"], _f32(thr), _f32(sthr),
            out_boxes=out["frame_boxes"], out_scores=out["frame_scores"]))
        ops = float(got["frame_mask"].sum()) * P * 13
        surface_bound[b] = bound(tubes.numel() * 4 + tscores.numel() * 4 + pmask.numel() * 4
                                 + b * T * C * K * (16 + 4 + 4), ops, F32_FLOPS)
        old_bound = bound(b * T * C * (P * 24 + K * 8), ops, F32_FLOPS)
        print(f"[3] K1 nms_surface B={b}: the plain version's bits with f32 and bf16 "
              f"scores; kernel device {nms_ms[b]:.4f} ms "
              f"({surface_bound[b]['bound_ms'] / nms_ms[b]:.1%} of the "
              f"{surface_bound[b]['bound_ms']:.6f} ms bound; the expanded interface's "
              f"{old_bound['bound_ms']:.6f} ms)", flush=True)
        if b == B:
            surf = (tubes, tscores, pmask)
    tubes, tscores, pmask = surf
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        nms_surface(tubes, tscores, pmask, cfg)
        torch.cuda.synchronize()
    surface_launches = sum(e.count for e in prof.key_averages() if device_work(e))
    nms_wrapper_ms = cuda_ms(lambda: nms_surface(tubes, tscores, pmask, cfg))
    nms_plain_ms = cuda_ms(lambda: nms_surface_plain(tubes, tscores, pmask, cfg))
    print(f"[3] K1 nms_surface B={B}: wrapper {nms_wrapper_ms:.4f} ms, plain "
          f"{nms_plain_ms:.4f} ms; N=1 floor {nms_ms['N=1']:.4f} ms; {surface_launches} "
          f"kernel launches in one nms_surface call (profiler)", flush=True)
    check(1 <= surface_launches <= 2,
          f"one nms_surface call launched {surface_launches} kernels, more than 2")
    results["nms_many"] = dict(max_abs_err=0.0, ms=nms_ms[B], wrapper_ms=nms_wrapper_ms,
                               plain_ms=nms_plain_ms, library_ms=None, **surface_bound[B],
                               floor_ms=nms_ms["N=1"],
                               surface_launches=surface_launches)

    # ---- 4. K2: tube ROI-align ------------------------------------------
    Tp, Hf = 5, cfg.image_size // cfg.feature_stride
    feat_np, tubes_np = roi_inputs(rng, B, Tp, Hf, 832, P, T, cfg.image_size)
    feat32 = torch.from_numpy(feat_np).to(dev)
    tubes = torch.from_numpy(tubes_np).to(dev)
    roi = lambda f: tube_roi_align(f, tubes, cfg.pooled_size,  # noqa: E731
                                   1.0 / cfg.feature_stride, cfg.sampling_ratio)
    plain = lambda f: tube_roi_align_plain(f, tubes, cfg.pooled_size,  # noqa: E731
                                           1.0 / cfg.feature_stride,
                                           cfg.sampling_ratio)
    out_k, out_p = roi(feat32), plain(feat32)
    torch.cuda.synchronize()
    err32 = float((out_k - out_p).abs().max())
    check(out_k.shape == (B, P, Tp, 7, 7, 832), f"K2 shape {tuple(out_k.shape)}")
    check(torch.allclose(out_k, out_p, rtol=1e-4, atol=1e-4),
          f"K2 roi_align float32 differs from plain: max |err| {err32}")
    check(float(out_p[:, 0].abs().max()) == 0.0,
          "K2 box outside the map pooled non-zero")
    feat16 = feat32.to(torch.bfloat16)
    out_k, out_p = roi(feat16), plain(feat16)
    torch.cuda.synchronize()
    check(out_k.dtype == torch.bfloat16, f"K2 bf16 output dtype {out_k.dtype}")
    err16 = float((out_k.float() - out_p.float()).abs().max())
    check(bf16_close(out_k, out_p),
          f"K2 roi_align bfloat16 differs from plain: max |err| {err16}")
    roi_out = torch.empty_like(out_k)
    roi_ms = device_ms(lambda: kernels.tube_roi_align_forward(
        feat16, tubes, roi_out, 1.0 / cfg.feature_stride, cfg.sampling_ratio))
    roi_wrapper_ms = cuda_ms(lambda: roi(feat16))
    roi_plain_ms = cuda_ms(lambda: plain(feat16))
    # Bytes: the feature map and the boxes read once, the output written
    # once; operations: 4 corners x 2 f32 ops per sample per output element.
    roi_bound = bound(feat16.numel() * 2 + tubes.numel() * 4 + out_k.numel() * 2,
                      out_k.numel() * cfg.sampling_ratio ** 2 * 8, F32_FLOPS)
    print(f"[4] K2 roi_align on [{B},{Tp},{Hf},{Hf},832]: max |err| f32 {err32:.3g} "
          f"(tol 1e-4), bf16 {err16:.3g} (rtol 2^-7); bf16 kernel device "
          f"{roi_ms:.4f} ms, wrapper {roi_wrapper_ms:.4f} ms, plain "
          f"{roi_plain_ms:.4f} ms, bound {roi_bound['bound_ms']:.4f} ms "
          f"({roi_bound['bound_ms'] / roi_ms:.1%} of it)", flush=True)
    results["tube_roi_align"] = dict(max_abs_err=err16, ms=roi_ms,
                                     wrapper_ms=roi_wrapper_ms,
                                     plain_ms=roi_plain_ms, library_ms=None,
                                     **roi_bound)
    # The adaptive branch: boxes up to 800 px wide, 50 feature cells, so
    # ceil(50 / 7) = 8 samples per axis are capped at adaptive_max_ratio = 2.
    big = tubes.clone()
    big[:, 4:8] = torch.tensor([-300.0, -200.0, 500.0, 450.0], device=dev)
    for f, tol in ((feat32, 1e-4), (feat16, None)):
        got = tube_roi_align(f, big, cfg.pooled_size, 1.0 / cfg.feature_stride, 0)
        want = tube_roi_align_plain(f, big, cfg.pooled_size, 1.0 / cfg.feature_stride, 0)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        ok = (torch.allclose(got, want, rtol=tol, atol=tol) if tol
              else bf16_close(got, want))
        check(ok and got.dtype == f.dtype,
              f"K2 roi_align {f.dtype} sampling_ratio=0 differs from plain: "
              f"max |err| {err}")
        print(f"    sampling_ratio=0, {f.dtype}: max |err| {err:.3g}", flush=True)
    roi0_ms = device_ms(lambda: kernels.tube_roi_align_forward(
        feat16, big, roi_out, 1.0 / cfg.feature_stride, 0))
    print(f"    sampling_ratio=0, bf16 kernel device {roi0_ms:.4f} ms", flush=True)

    # ---- 5. tiny float32 detector: card against CPU ---------------------
    tiny = cfg.replace(backbone_depth="tiny", feature_stride=8, image_size=64,
                       compute_dtype="float32")
    model_cpu = init_detector_(STEPDetector(tiny).eval(), SEED)
    model_gpu = init_detector_(STEPDetector(tiny).eval(), SEED).to(dev)
    props, pmask = STEPDetector.initial_proposals(tiny, 2, device="cpu")
    clip = torch.from_numpy(rng.randint(0, 256, (2, T, 64, 64, 3)).astype(np.uint8))
    ref = detect_clip(model_cpu, clip, props, pmask)
    got = detect_clip(model_gpu, clip.to(dev), props.to(dev), pmask.to(dev))
    d_tubes = float((got["tubes"].cpu() - ref["tubes"]).abs().max())
    d_scores = float((got["tube_scores"].cpu() - ref["tube_scores"]).abs().max())
    check(d_tubes <= 1e-3 and d_scores <= 1e-4,
          f"tiny detector card vs CPU: tubes {d_tubes} px, scores {d_scores}")
    surf = nms_surface(ref["tubes"].to(dev), ref["tube_scores"].to(dev),
                       pmask.to(dev), tiny)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        check(torch.equal(surf[key].cpu(), ref[key]),
              f"tiny detector NMS surface on the card differs in {key}")
    print(f"[5] tiny f32 detector card vs CPU: tubes {d_tubes:.3g} px, "
          f"scores {d_scores:.3g}; NMS surface equal", flush=True)

    # ---- 6. the main path: full-width ucf_3step, bf16 -------------------
    t0 = time.time()
    model = init_detector_(STEPDetector(cfg).eval(), SEED)
    cfg_opt, folded = optimize_for_inference(cfg, model.state_dict())
    model = STEPDetector(cfg_opt).eval()
    model.load_state_dict(folded)
    model = model.to(device=dev, dtype=getattr(torch, cfg.compute_dtype))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[6] ucf_3step {cfg.backbone_depth}, {n_params} params, BN folded, "
          f"fused_inception={cfg_opt.fused_inception}, {cfg.compute_dtype}: built "
          f"in {time.time() - t0:.1f} s", flush=True)

    def new_clips(batches, n):
        return {b: [torch.from_numpy(rng.randint(0, 256, (b, T, cfg.image_size,
                                                          cfg.image_size, 3)
                                                 ).astype(np.uint8))
                    for _ in range(n)] for b in batches}

    reset_counts, read_counts = kernel_counters()
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    serve(model, cfg, new_clips(SERVE_BATCHES, REQUESTS_PER_BATCH), dev, "main path")
    main_launches = read_counts()
    print(f"    launches during serving: {main_launches}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    for name in ("nms_many", "tube_roi_align"):
        check(main_launches[name] > 0, f"kernel {name} never launched on the main path")
    # Every pool of a request runs a hand-written kernel: K5 at each stride-1
    # pool `backbone_launches` lists, the strided kernel at the stem's three.
    main_req = len(SERVE_BATCHES) * REQUESTS_PER_BATCH
    main_pools = {"max_pool3x3_same": sum(backbone_launches(cfg, 1)[1].values()),
                  "max_pool3d_same": sum(strided_launches(cfg, 1).values())}
    for name, n in main_pools.items():
        check(main_launches[name] == main_req * n,
              f"{name}: {main_launches[name]} launches on the main path in {main_req} "
              f"requests, not {n} a request")
    check(not any(main_launches[k] for k in ("fused_scale_bias_relu", "conv3x3x3_bn_relu")),
          f"the main path launched K3 or K4: {main_launches}")
    print(f"    pools of the main path: K5 {main_pools['max_pool3x3_same']} and the strided "
          f"kernel {main_pools['max_pool3d_same']} a request, as listed", flush=True)
    del model

    # ---- 7. K5: 3x3x3 max pool, at every launch shape of a B=8 request --
    k4_shapes, k5_shapes, _ = backbone_launches(cfg, B)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    pool_req = dict(ms=0.0, bound_ms=0.0, plain_ms=0.0)
    for shape, n in k5_shapes.items():
        r = pool_case(shape, gen)
        for key in pool_req:
            pool_req[key] += n * r[key]
        print(f"[7] K5 max_pool3x3 {list(shape)} x{n} a request: the plain version's "
              f"bits in f32 and bf16, NaN payloads included; bf16 kernel device "
              f"{r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} of the "
              f"{r['bound_ms']:.4f} ms bound), wrapper {r['wrapper_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms", flush=True)
    print(f"    K5 per B={B} request ({sum(k5_shapes.values())} launches): device "
          f"{pool_req['ms']:.4f} ms, bound {pool_req['bound_ms']:.4f} ms "
          f"({pool_req['bound_ms'] / pool_req['ms']:.1%}), plain "
          f"{pool_req['plain_ms']:.4f} ms", flush=True)
    # The tail shape (the last) stands for K5 in the JSON line. The plain
    # version is one PyTorch call, F.max_pool3d, so it is also the library's.
    results["max_pool3x3_same"] = dict(r, request_ms=pool_req["ms"],
                                       request_bound_ms=pool_req["bound_ms"])

    # ---- 8. K4: BN + ReLU, at every launch shape of a B=8 request ---------
    bn_req = dict(ms=0.0, bound_ms=0.0, plain_ms=0.0)
    for shape, n in k4_shapes.items():
        r = bn_case(shape, gen)
        for key in bn_req:
            bn_req[key] += n * r[key]
        print(f"[8] K4 bn_relu [{r['rows']}, {shape[1]}] x{n} a request: max |err| f32 "
              f"{r['err32']:.3g} (tol 1e-6), bf16 {r['max_abs_err']:.3g} (one bf16 "
              f"step); bf16 kernel device {r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%} "
              f"of the {r['bound_ms']:.4f} ms bound), wrapper {r['wrapper_ms']:.4f} ms, "
              f"plain {r['plain_ms']:.4f} ms", flush=True)
        if shape == next(iter(k4_shapes)):      # Conv3d_2b's output stands for K4
            results["fused_scale_bias_relu"] = {k: v for k, v in r.items()
                                                if k not in ("err32", "rows")}
    print(f"    K4 per B={B} request ({sum(k4_shapes.values())} launches): device "
          f"{bn_req['ms']:.4f} ms, bound {bn_req['bound_ms']:.4f} ms "
          f"({bn_req['bound_ms'] / bn_req['ms']:.1%}), plain "
          f"{bn_req['plain_ms']:.4f} ms", flush=True)
    results["fused_scale_bias_relu"].update(request_ms=bn_req["ms"],
                                            request_bound_ms=bn_req["bound_ms"])

    # ---- 9. K3: 3x3x3 conv + BN + ReLU -----------------------------------
    check(n_hgmma > 0, "K3's bf16 kernels hold no HGMMA instruction")
    for shape, K in (((8, 64, 9, 56, 56), 192), ((128, 160, 5, 7, 7), 320),
                     ((8, 24, 5, 14, 14), 64), ((8, 96, 5, 14, 14), 208)):
        r = conv_case(shape, K, rng, dev)
        print(f"[9] K3 conv3x3x3_bn_relu {list(shape)}->{K}: max |err| f32 "
              f"{r['err32']:.3g} (tol 1e-4), bf16 {r['max_abs_err']:.3g} (one bf16 "
              f"step); bf16 kernel device {r['ms']:.4f} ms "
              f"({r['flop'] / r['ms'] / 1e9:.1f} TFLOP/s, "
              f"{r['bound_ms'] / r['ms']:.1%} of the {r['bound_ms']:.4f} ms bound), "
              f"wrapper {r['wrapper_ms']:.4f} ms; weight re-layout from the f32 "
              f"parameter (cached per unit) {r['pack_ms']:.4f} ms; cuDNN bf16 (BN "
              f"folded) + ReLU {r['library_ms']:.4f} ms; plain (f32 conv) "
              f"{r['plain_ms']:.4f} ms", flush=True)
        if shape[0] == 128:
            results["conv3x3x3_bn_relu"] = {k: v for k, v in r.items()
                                            if k not in ("err32", "flop", "pack_ms")}

    # ---- 10. the kernel path: unfolded, fused_bn_relu, K5 pools, bf16 ----
    kcfg = cfg.replace(fused_bn_relu=True)
    t0 = time.time()
    seeded = init_detector_(STEPDetector(cfg).eval(), SEED).state_dict()
    kmodel = STEPDetector(kcfg).eval()
    kmodel.load_state_dict(seeded)
    kmodel = kmodel.to(dev)        # float32 parameters, bf16 activations
    print(f"[10] ucf_3step {cfg.backbone_depth}, unfolded, fused_bn_relu, "
          f"{cfg.compute_dtype}: built in "
          f"{time.time() - t0:.1f} s", flush=True)
    reset_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    serve(kmodel, kcfg, new_clips(SERVE_BATCHES, KERNEL_PATH_REQUESTS), dev,
          "kernel path")
    kernel_launches = read_counts()
    print(f"    launches during serving: {kernel_launches}; peak memory "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB", flush=True)
    for name, n in kernel_launches.items():
        check(n > 0, f"kernel {name} never launched on the kernel path")
    n_req = len(SERVE_BATCHES) * KERNEL_PATH_REQUESTS
    for name, shapes in (("fused_scale_bias_relu", k4_shapes),
                         ("max_pool3x3_same", k5_shapes),
                         ("max_pool3d_same", strided_launches(cfg, B))):
        check(kernel_launches[name] == n_req * sum(shapes.values()),
              f"{name}: {kernel_launches[name]} launches in {n_req} requests, but "
              f"phases 7-8 list {sum(shapes.values())} a request")

    # ---- 11. float32, B=1: the kernel path against the main path ---------
    del kmodel
    cfg32 = cfg.replace(compute_dtype="float32")
    kmodel = STEPDetector(cfg32.replace(fused_bn_relu=True)).eval()
    kmodel.load_state_dict(seeded)
    kmodel = kmodel.to(dev)
    cfg_opt32, folded32 = optimize_for_inference(cfg32, seeded)
    mmodel = STEPDetector(cfg_opt32).eval()
    mmodel.load_state_dict(folded32)
    mmodel = mmodel.to(dev)
    props, pmask = STEPDetector.initial_proposals(cfg, 1, device=dev)
    clip = new_clips((1,), 1)[1][0].to(dev)
    got = detect_clip(kmodel, clip, props, pmask)
    want = detect_clip(mmodel, clip, props, pmask)
    torch.cuda.synchronize()
    d_scores = float((got["tube_scores"] - want["tube_scores"]).abs().max())
    d_tubes = float((got["tubes"] - want["tubes"]).abs().max())
    print(f"[11] f32 B=1 kernel path vs main path: tube scores max |d| "
          f"{d_scores:.3g} (tol {PATH_SCORE_TOL}), tubes {d_tubes:.3g} px "
          f"(tol {PATH_TUBE_TOL})", flush=True)
    check(d_scores <= PATH_SCORE_TOL and d_tubes <= PATH_TUBE_TOL,
          f"kernel path differs from the main path: scores {d_scores}, "
          f"tubes {d_tubes} px")

    del kmodel, mmodel, got, want
    video = video_phases(dev, rng, seeded, reset_counts, read_counts)
    training = training_phases(dev, rng, reset_counts, read_counts)
    evaluation = eval_phases(dev, seeded, smi.stdout.strip(), reset_counts, read_counts)
    two_stream = two_stream_phases(dev, rng, smi.stdout.strip(), reset_counts, read_counts)
    late_fusion = late_fusion_phases(dev, rng, smi.stdout.strip(), reset_counts, read_counts)
    ava = ava_phases(dev, rng, smi.stdout.strip(), reset_counts, read_counts)
    pretrained = pretrained_phases(dev, smi.stdout.strip(), reset_counts, read_counts)
    int8 = int8_phases(dev, smi.stdout.strip(), reset_counts, read_counts)
    frame_fc = frame_fc_phases(dev, rng, smi.stdout.strip(), reset_counts, read_counts)
    classifier = classifier_phases(dev, rng, smi.stdout.strip(), reset_counts, read_counts)
    serving = serving_phases(dev, rng, seeded, smi.stdout.strip(), reset_counts, read_counts)
    parallel = parallel_phases(dev, smi.stdout.strip(), reset_counts, read_counts)
    kernel_program = kernel_program_phases(dev, rng, seeded, smi.stdout.strip(),
                                           reset_counts, read_counts)
    bridge = bridge_phases(dev, smi.stdout.strip(), reset_counts, read_counts)
    benches = bench_phases(dev, smi.stdout.strip(), reset_counts, read_counts)
    pools_b32 = pool_b32_phase(dev, {k: main_launches[k] // main_req for k in main_pools})
    vit = vit_phase(dev, rng, smi.stdout.strip(), reset_counts, read_counts)
    stem = stem_phase(dev, rng, smi.stdout.strip(), n_stem_hgmma)
    blocks = inception_phase(dev, rng, smi.stdout.strip(), n_tube_hgmma)
    pools = attn_pool_phase(dev, rng, smi.stdout.strip())

    launches = {**{k: main_launches[k] for k in ("nms_many", "tube_roi_align",
                                                 "max_pool3x3_same", "max_pool3d_same")},
                **{k: kernel_launches[k] for k in ("fused_scale_bias_relu",
                                                   "conv3x3x3_bn_relu")}}
    meta = {
        "nms_many": ("step_tpu_torch/csrc/nms.cu", "step_tpu/ops/nms_pallas.py:38"),
        "tube_roi_align": ("step_tpu_torch/csrc/roi_align.cu",
                           "step_tpu/ops/roi_align_pallas.py:55"),
        "max_pool3x3_same": ("step_tpu_torch/csrc/pool3d.cu",
                             "step_tpu/ops/pool_pallas.py:42"),
        "fused_scale_bias_relu": ("step_tpu_torch/csrc/bn_relu.cu",
                                  "step_tpu/ops/fused_bn_relu.py:32"),
        "conv3x3x3_bn_relu": ("step_tpu_torch/csrc/conv3d.cu",
                              "step_tpu/ops/conv3d_pallas.py:45"),
        "max_pool3d_same": ("step_tpu_torch/csrc/pool3d_same.cu", None),
    }
    foreign = sorted(m for m in sys.modules
                     if m.split(".")[0] == "step_tpu" or m.startswith("jax"))
    check(not foreign, f"JAX or the JAX package was imported: {foreign[:5]}")
    print(f"all phases took {time.time() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results.get(name, {}), **video[name],
         **training[name],
         **evaluation[name], **two_stream[name], **late_fusion[name], **ava[name],
         **pretrained[name], **int8[name], **frame_fc[name], **classifier[name],
         **serving[name], **parallel[name], **kernel_program[name], **bridge[name],
         **benches[name], **pools_b32.get(name, {}), **vit[name]}
        for name, (src, rep) in meta.items()] + [
        {"name": "stem_conv", "route": "cuda", "source": "step_tpu_torch/csrc/stem_conv.cu",
         "replaces": None, **stem},
        {"name": "inception_block", "route": "cuda",
         "source": "step_tpu_torch/csrc/gemm.cu, step_tpu_torch/csrc/conv3d.cu",
         "replaces": "step_tpu/ops/conv3d_pallas.py:45 (the 3x3x3 convs)", **blocks},
        {"name": "attn_pool", "route": "cuda", "source": "step_tpu_torch/csrc/attn_pool.cu",
         "replaces": None, **pools}]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))


if __name__ == "__main__":
    main()
