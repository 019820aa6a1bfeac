"""The least time of every 3-D max pool of the traced requests, over the
device time of all max-pool kernels. The least time is the configuration's
pool bytes a clip (inputs read once, outputs written once, at the shapes
the reference runs them) over the H100's 3.35 TB/s; it reads the same work
whatever implements the pools. Summed kernels: names holding one of
KERNELS, on the card the port's K5 `max_pool3x3_kernel` (3x3x3 stride 1,
in the backbone and the heads' tails) and its strided
`max_pool3d_same_kernel` (MaxPool_2a, 3a, 4a)."""

from benchmark.work import PEAK_HBM_BYTES_PER_S

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "backbone 3-D max pools"
MOVES = "clips_per_s"
KERNELS = ("max_pool", "pool3d")


def read(m):
    ops = m.timeline.kernels(*KERNELS) if m.timeline else []
    if not ops:
        return None
    least = m.config["work"]["pool3d_bytes"] * m.timeline.records["clips"] / PEAK_HBM_BYTES_PER_S
    return 100.0 * least / (sum(e["dur"] for e in ops) * 1e-6)
