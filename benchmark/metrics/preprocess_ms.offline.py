"""Device milliseconds a request of the work launched inside the program's
`model.preprocess` span (`STEPDetector.stem`): the uint8 clip's
normalization (`preprocess.device_preprocess`) and its cast to the compute
dtype. None where the program opens no such span."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "request entry"
MOVES = "clips_per_s"


def read(m):
    ops = m.trace.launched_in("model.preprocess") if m.trace else []
    return sum(e["dur"] for e in ops) * 1e-3 / m.trace.records["units"] if ops else None
