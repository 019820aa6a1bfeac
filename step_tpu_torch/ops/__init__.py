"""Tube ROI-align and batched NMS (port of `step_tpu/ops`): each a plain
PyTorch version and a wrapper that launches the CUDA kernel on the card."""
