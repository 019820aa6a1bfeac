"""Kernel K2's share of its roofline: the least time of the traced
requests' tube ROI-aligns (the larger of the configuration's bytes over
3.35 TB/s and its operations over 67 TFLOP/s of float32) over the device
time of K2's launches (`ops/roi_align.py` → `csrc/roi_align.cu`)."""

from benchmark.work import PEAK_F32_FLOPS, PEAK_HBM_BYTES_PER_S

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "K2 tube ROI-align"
MOVES = "clips_per_s"
KERNELS = ("tube_roi_align_kernel",)


def read(m):
    ops = m.timeline.kernels(*KERNELS) if m.timeline else []
    if not ops:
        return None
    w, clips = m.config["work"], m.timeline.records["clips"]
    least = max(w["roi_align_bytes"] * clips / PEAK_HBM_BYTES_PER_S,
                w["roi_align_ops"] * clips / PEAK_F32_FLOPS)
    return 100.0 * least / (sum(e["dur"] for e in ops) * 1e-6)
