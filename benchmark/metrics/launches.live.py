"""Kernels launched a request (the kernels on the device's timeline over
its requests): the host's dispatch work of a B=1 request."""

UNIT = "kernels"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "host dispatch"
MOVES = "p95_request_ms"


def read(m):
    ops = m.timeline.kernels() if m.timeline else []
    return len(ops) / m.timeline.records["units"] if ops else None
