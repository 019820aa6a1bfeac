"""Host-side evaluation: frame- and video-mAP and score calibration, copies
of `step_tpu/eval` (numpy only)."""
