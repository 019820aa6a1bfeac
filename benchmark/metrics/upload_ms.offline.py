"""Device milliseconds of host-to-device copies a request, on the device's
timeline: the upload of the uint8 clips, which `inference.detect_clip`'s
input and `preprocess.device_preprocess` then normalize."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "request entry"
MOVES = "clips_per_s"


def read(m):
    t = m.timeline
    copies = t.memcpy("HtoD") if t else []
    return sum(e["dur"] for e in copies) * 1e-3 / t.records["units"] if copies else None
