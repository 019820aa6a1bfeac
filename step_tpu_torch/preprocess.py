"""Input normalization on the device.

Port of `step_tpu/preprocess.py`: `device_preprocess` (RGB) and
`device_preprocess_flow` (optical flow). The clip travels to the card as
uint8 RGB or int8 flow and is normalized there.
"""

from __future__ import annotations

import torch

# ImageNet/Kinetics statistics in [0, 1] scale.
RGB_MEAN = (0.485, 0.456, 0.406)
RGB_STD = (0.229, 0.224, 0.225)


def device_preprocess(rgb: torch.Tensor) -> torch.Tensor:
    """uint8 [0, 255] or float [0, 1] RGB `[..., 3]` → normalized float32."""
    x = rgb.to(torch.float32)
    if rgb.dtype == torch.uint8:
        x = x / 255.0
    mean = torch.tensor(RGB_MEAN, dtype=torch.float32, device=rgb.device)
    std = torch.tensor(RGB_STD, dtype=torch.float32, device=rgb.device)
    return (x - mean) / std


def device_preprocess_flow(flow: torch.Tensor) -> torch.Tensor:
    """int8 [-127, 127] (the wire format, `data/pipeline.py::
    flow_to_int8_wire`) or float [-1, 1] flow `[..., 2]` → float32: int8
    divides by 127.0, float passes through."""
    x = flow.to(torch.float32)
    if flow.dtype == torch.int8:
        x = x / 127.0
    return x
