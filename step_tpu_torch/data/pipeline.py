"""The clip wire format (`step_tpu/data/pipeline.py:32-39`).

`step_tpu/data/pipeline.py` imports `jax.numpy`, so the port keeps its own
copy of the quantizer, held equal to the original by
`tests/test_torch_port_video.py`.
"""

from __future__ import annotations

import numpy as np


def rgb_to_uint8_wire(rgb: np.ndarray) -> np.ndarray:
    """The [0, 1] float → uint8 wire quantizer, rounding half up (not
    numpy's round half to even), so every surface that ships uint8
    quantizes bit-identically."""
    return (np.clip(rgb, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
