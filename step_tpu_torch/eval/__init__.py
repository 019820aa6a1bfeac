"""Host-side evaluation: frame- and video-mAP, AVA's keyframe evaluator and
score calibration, copies of `step_tpu/eval` (numpy only)."""
