"""The attention pools' share of their roofline: the least time of the
traced requests' pools (the larger of the configuration's `attn_pool_ops`
over 989 TFLOP/s of bfloat16 and its `attn_pool_bytes` over 3.35 TB/s, a
clip each, times the clips) over the device time launched inside the
program's `model.attn_pool` spans (each MViTv2 block's depthwise 3x3x3
pools of q, k and v and their LayerNorms, `models/mvit.py`). It reads the
same work whatever kernels run the pools. None where the program opens no
such span."""

from benchmark.work import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "MViT attention pools"
MOVES = "clips_per_s"


def read(m):
    ops = m.trace.launched_in("model.attn_pool") if m.trace else []
    if not ops:
        return None
    w, clips = m.config["work"], m.trace.records["clips"]
    least = max(w["attn_pool_ops"] * clips / PEAK_BF16_FLOPS,
                w["attn_pool_bytes"] * clips / PEAK_HBM_BYTES_PER_S)
    return 100.0 * least / (sum(e["dur"] for e in ops) * 1e-6)
