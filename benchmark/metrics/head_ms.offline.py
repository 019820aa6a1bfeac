"""Device milliseconds a request of the work launched inside the program's
`model.head` spans: each refinement step's `nets.TwoBranchHead` call, its
I3D tail and two-branch head, over all steps. None where the program opens
no such span."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "refinement heads"
MOVES = "clips_per_s"


def read(m):
    ops = m.trace.launched_in("model.head") if m.trace else []
    return sum(e["dur"] for e in ops) * 1e-3 / m.trace.records["units"] if ops else None
