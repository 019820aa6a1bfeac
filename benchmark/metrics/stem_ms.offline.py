"""Device milliseconds a request of the work launched inside the program's
`model.stem` span (`models/i3d.py::I3DStem.forward`): the I3D stem's first
unit, Conv3d_1a_7x7, inside `model.backbone`. None where the program opens
no such span (a program that predates it, or a backbone without an I3D
stem)."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "backbone stem"
MOVES = "clips_per_s"


def read(m):
    ops = m.trace.launched_in("model.stem") if m.trace else []
    return sum(e["dur"] for e in ops) * 1e-3 / m.trace.records["units"] if ops else None
