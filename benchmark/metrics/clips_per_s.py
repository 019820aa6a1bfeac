"""Clips whose detections reached the host in the window, over the window's
seconds: from the first request's start to the last one's landing. Each
request runs from host uint8 clips through `detect_clip` to its outputs
copied to the host."""

UNIT = "clips/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(m):
    r = m.records
    return r["clips"] / r["window_s"] if r.get("window_s") else None
