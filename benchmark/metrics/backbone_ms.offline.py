"""Device milliseconds a request of the work launched inside the backbone
(`models/nets.py::FeatureNet`, `models/i3d.py`), the `features` span."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "backbone"
MOVES = "clips_per_s"


def read(m):
    ops = m.trace.launched_in("features") if m.trace else []
    return sum(e["dur"] for e in ops) * 1e-3 / m.trace.records["units"] if ops else None
