"""The whole request's or train step's share of the chip's peak
(`mfu.<cells>`): the configuration's FLOPs a clip of the cell's entry
(`flops_serve`, or `flops_train` for forward and backward with no
recomputation; counted over the reference, every proposal slot) times the
clips of the timed window, over its seconds, over 989 TFLOP/s (bf16). The
window is the untraced one, so the profiler's cost is not in it."""

from benchmark.work import PEAK_BF16_FLOPS

UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "model step"


def read(m):
    r = m.records
    if not r.get("window_s") or not r["clips"]:
        return None
    flops = m.config["work"]["flops_" + m.workload["traffic"]["entry"]] * r["clips"]
    return 100.0 * flops / r["window_s"] / PEAK_BF16_FLOPS
