"""The detector's configuration: `StepConfig` and the five named presets.

A copy of `step_tpu/config.py` (fields, defaults, validation, `replace`,
`PRESETS`), kept here so that the port imports nothing of the JAX package.
The fields and their defaults must stay those of the JAX package: the
tests hold `dataclasses.asdict` of each preset against it. Code of the port
reads a config only through its attributes, so the JAX package's
`StepConfig` works wherever this one does.

Knobs that choose a TPU lowering (`stem_s2d`, `conv3d_impl`, `roi_impl`,
`scan_unroll`, `scan_broadcast_inputs`, `head_compact`, `nms_impl`) and the
training fields are carried for that parity; the port's detector reads the
model fields and ignores the rest (`models/detector.py`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration of one detector."""

    # ---- dataset / task ----
    dataset: str = "ucf101_24"          # "ucf101_24" | "ava" | "synthetic"
    num_classes: int = 24               # foreground classes (background handled separately)
    multilabel: bool = False            # AVA: per-class sigmoid; UCF: softmax(+bg)

    # ---- clip geometry ----
    frames_per_chunk: int = 6           # T: frames in the central chunk
    num_chunks: int = 3                 # chunk axis [fore, mid, back]
    image_size: int = 224               # square input resolution
    temporal_stride: int = 1            # frame sampling stride inside a chunk

    # ---- backbone ----
    backbone: str = "i3d"               # I3D (Inflated Inception-v1)
    backbone_depth: str = "full"        # "full" | "tiny" (shallow, spatial
                                        #   stride 8: set feature_stride=8)
    two_stream: bool = False            # RGB + optical-flow trunks in one model
    two_stream_fusion: str = "conv"     # "conv" (1x1x1 feature fusion) | "late"
    input_stream: str = "rgb"           # "rgb" | "flow" (single-stream input)
    late_fusion_weight: float = 0.5     # RGB weight of late score fusion
    feature_stride: int = 16            # spatial stride at the shared features (Mixed_4f)
    compute_dtype: str = "bfloat16"     # activations; parameters stay float32
    uint8_transfer: bool = True         # clips travel as uint8, normalized on device
    stem_s2d: bool = True               # TPU lowering of the first conv
    conv3d_impl: str = "direct"         # TPU lowering of the 3D convs
    chunk_stem: bool = False            # run each chunk through the stem alone
    # Inference variants (models/optimize.py builds the matching weights):
    # BN folded into the conv; the three 1x1x1 Inception branch convs as
    # one; the two 3x3x3 branch convs as one block-diagonal conv.
    bn_folded: bool = False
    fused_inception: bool = False
    fused_inception3: str = "none"      # "none" | "tail" | "all"
    head_compact: bool = False          # run the tail on active slots only
    fused_bn_relu: bool = False         # BN + ReLU (and 3x3x3 conv) as kernels

    # ---- progressive refinement ----
    num_steps: int = 3                  # S refinement steps
    scan_unroll: bool = False           # TPU lowering of the step loop
    scan_broadcast_inputs: bool = False  # TPU lowering of the step loop
    num_proposals: int = 11             # initial hand-placed cuboids
    max_proposals: int = 16             # padded proposal capacity (>= num_proposals)
    pooled_size: int = 7                # ROI-align output grid (7x7)
    sampling_ratio: int = 2             # bilinear samples per bin and axis; <= 0: adaptive
    roi_impl: str = "kron"              # TPU lowering of ROI-align
    temporal_extension: bool = True     # step >= 2 extends tubes into neighbour chunks
    reg_head: str = "grid"              # "grid" | "frame_fc"
    cuboid_layout: str = "default"      # "default" | "grid3"
    iou_thresholds: Tuple[float, ...] = (0.4, 0.5, 0.6)
    step_loss_weights: Tuple[float, ...] = (1.0, 1.0, 1.0)
    reg_loss_weight: float = 1.0
    use_context: bool = True            # scene-context feature in the cls branch
    box_variances: Tuple[float, float] = (0.1, 0.2)

    # ---- inference ----
    score_thresh: float = 0.05
    nms_thresh: float = 0.5
    max_detections: int = 32            # per-frame, per-class survivor cap
    link_iou_weight: float = 1.0
    link_tubes_per_class: int = 4
    link_trim_thresh: float = 0.05
    link_suppress_iou: float = 0.5
    nms_impl: str = "pallas"            # TPU lowering of NMS
    tube_nms_thresh: float = 0.0

    # ---- training ----
    batch_size: int = 8
    max_gt_tubes: int = 8
    optimizer: str = "adamw"            # "adamw" | "sgd"
    momentum: float = 0.9
    adam_mu_dtype: str = "float32"      # "float32" | "bfloat16"
    adam_moments: str = "float32"       # "float32" | "int8"
    neg_pos_ratio: float = 3.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    cls_prior: float = 0.01
    freeze_submodules: tuple = ()
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 500
    total_steps: int = 20000
    lr_schedule: str = "warmup_cosine"  # "warmup_cosine" | "step"
    lr_decay_milestones: tuple = ()
    lr_decay_rate: float = 0.1
    dropout_rate: float = 0.3
    remat_steps: bool = True
    remat_policy: str = "dots"          # "full" | "dots"
    gt_jitter_proposals: int = 0
    grad_accum_steps: int = 1

    # ---- parallelism ----
    mesh_shape: Tuple[int, ...] = (8,)
    mesh_axes: Tuple[str, ...] = ("data",)

    # ---------------------------------------------------------------- helpers
    @property
    def total_frames(self) -> int:
        """Frames across the chunk axis (e.g. 3*6 = 18)."""
        return self.frames_per_chunk * self.num_chunks

    @property
    def num_cls_outputs(self) -> int:
        """Classifier logits: +1 background column for softmax datasets."""
        return self.num_classes if self.multilabel else self.num_classes + 1

    @property
    def feature_size(self) -> int:
        return self.image_size // self.feature_stride

    @property
    def active_proposals(self) -> int:
        """Slots that can ever hold a real proposal."""
        return min(self.max_proposals,
                   self.num_proposals + self.gt_jitter_proposals)

    def replace(self, **kw) -> "StepConfig":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        if self.max_proposals < self.num_proposals:
            raise ValueError("max_proposals must be >= num_proposals")
        if len(self.iou_thresholds) < self.num_steps:
            raise ValueError("need an IoU threshold per refinement step")
        if len(self.step_loss_weights) < self.num_steps:
            raise ValueError("need a loss weight per refinement step")
        if self.num_chunks % 2 != 1:
            raise ValueError("num_chunks must be odd (central chunk + symmetric neighbors)")
        if self.fused_inception and not self.bn_folded:
            raise ValueError("fused_inception requires bn_folded (the merged "
                             "1x1x1 conv carries per-branch BN in its "
                             "folded weights)")
        if self.fused_inception3 not in ("none", "tail", "all"):
            raise ValueError("fused_inception3 must be 'none', 'tail' or "
                             f"'all', got {self.fused_inception3!r}")
        if self.fused_inception3 != "none" and not self.fused_inception:
            raise ValueError("fused_inception3 requires fused_inception "
                             "(the merged 3x3x3 conv reads the contiguous "
                             "[b1r | b2r] slice of the fused-1x1 output)")
        if isinstance(self.freeze_submodules, str):
            raise ValueError("freeze_submodules must be a tuple of names, "
                             f"got the string {self.freeze_submodules!r} — "
                             "write ('features',)")
        unknown = set(self.freeze_submodules) - {"features", "context", "steps"}
        if unknown:
            raise ValueError(f"unknown freeze_submodules {sorted(unknown)}; "
                             "valid: features, context, steps")
        if self.remat_policy not in ("full", "dots"):
            raise ValueError("remat_policy must be 'full' or 'dots', got "
                             f"{self.remat_policy!r}")
        if self.grad_accum_steps < 1:
            raise ValueError("grad_accum_steps must be >= 1, got "
                             f"{self.grad_accum_steps}")
        if self.adam_moments not in ("float32", "int8"):
            raise ValueError("adam_moments must be 'float32' or 'int8', "
                             f"got {self.adam_moments!r}")
        if self.adam_moments == "int8" and self.adam_mu_dtype != "float32":
            raise ValueError("adam_moments='int8' stores mu as int8 blocks;"
                             " the adam_mu_dtype knob does not apply — "
                             "leave it 'float32'")
        if self.batch_size % self.grad_accum_steps:
            raise ValueError(
                "batch_size (the EFFECTIVE batch) must divide into "
                f"grad_accum_steps equal micro-batches; got {self.batch_size}"
                f" % {self.grad_accum_steps} != 0")


# The five BASELINE.json configs as named presets.
PRESETS = {
    # 1. UCF101-24, one 6-frame clip, one refinement step, 112 px.
    "pr1_ref": StepConfig(
        dataset="ucf101_24",
        num_classes=24,
        frames_per_chunk=6,
        num_chunks=1,
        num_steps=1,
        temporal_extension=False,
        image_size=112,
        batch_size=1,
        iou_thresholds=(0.5,),
        step_loss_weights=(1.0,),
    ),
    # 2. UCF101-24, three refinement steps, temporal extension to 18 frames.
    "ucf_3step": StepConfig(
        dataset="ucf101_24",
        num_classes=24,
        frames_per_chunk=6,
        num_chunks=3,
        num_steps=3,
        temporal_extension=True,
    ),
    # 3. AVA v2.1 keyframe detection, multilabel, with the context branch.
    "ava_3step": StepConfig(
        dataset="ava",
        num_classes=60,
        multilabel=True,
        frames_per_chunk=6,
        num_chunks=3,
        num_steps=3,
        temporal_extension=True,
        use_context=True,
    ),
    # 4. Batched streaming inference over multi-clip videos.
    "streaming": StepConfig(
        dataset="ucf101_24",
        num_classes=24,
        frames_per_chunk=6,
        num_chunks=3,
        num_steps=3,
        temporal_extension=True,
        batch_size=16,
        score_thresh=0.01,
    ),
    # 5. Two-stream I3D (RGB + optical flow), trained end to end.
    "two_stream_train": StepConfig(
        dataset="ucf101_24",
        num_classes=24,
        two_stream=True,
        frames_per_chunk=6,
        num_chunks=3,
        num_steps=3,
        temporal_extension=True,
    ),
}
