"""Device milliseconds a request of the work launched inside the program's
`model.refine` span (`STEPDetector.refine`): the scene context and the
three refinement steps (ROI-align, `nets.TwoBranchHead`, `tubes/` box
decoding and extension). None where the program opens no such span."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "refinement steps"
MOVES = "clips_per_s"


def read(m):
    ops = m.trace.launched_in("model.refine") if m.trace else []
    return sum(e["dur"] for e in ops) * 1e-3 / m.trace.records["units"] if ops else None
