"""The attention's share of its roofline: the least time of the traced
requests' attention calls (the larger of the configuration's
`attention_ops` over 989 TFLOP/s of bfloat16 and its `attention_bytes`
over 3.35 TB/s, a clip each, times the clips) over the device time
launched inside the program's `model.attention` spans (each ViT block's
`F.scaled_dot_product_attention` call, `models/vit.py`). It reads the
same work whatever backend runs the attention. None where the program
opens no such span."""

from benchmark.work import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "ViT attention"
MOVES = "clips_per_s"


def read(m):
    ops = m.trace.launched_in("model.attention") if m.trace else []
    if not ops:
        return None
    w, clips = m.config["work"], m.trace.records["clips"]
    least = max(w["attention_ops"] * clips / PEAK_BF16_FLOPS,
                w["attention_bytes"] * clips / PEAK_HBM_BYTES_PER_S)
    return 100.0 * least / (sum(e["dur"] for e in ops) * 1e-6)
