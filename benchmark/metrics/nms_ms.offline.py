"""Device milliseconds a request of the work launched inside the program's
`detect.nms` span (`inference._detections`): the class scores, the padding
mask and the NMS surface (K1). None where the program opens no such span."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "NMS surface"
MOVES = "clips_per_s"


def read(m):
    ops = m.trace.launched_in("detect.nms") if m.trace else []
    return sum(e["dur"] for e in ops) * 1e-3 / m.trace.records["units"] if ops else None
