"""The ViT MLPs' share of their roofline: the least time of the traced
requests' MLPs (the larger of the configuration's `mlp_ops` over 989
TFLOP/s of bfloat16 and its `mlp_bytes` over 3.35 TB/s, a clip each,
times the clips) over the device time launched inside the program's
`model.mlp` spans (each ViT block's fc1, GELU and fc2, `models/vit.py`).
None where the program opens no such span."""

from benchmark.work import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "ViT MLP"
MOVES = "clips_per_s"


def read(m):
    ops = m.trace.launched_in("model.mlp") if m.trace else []
    if not ops:
        return None
    w, clips = m.config["work"], m.trace.records["clips"]
    least = max(w["mlp_ops"] * clips / PEAK_BF16_FLOPS,
                w["mlp_bytes"] * clips / PEAK_HBM_BYTES_PER_S)
    return 100.0 * least / (sum(e["dur"] for e in ops) * 1e-6)
