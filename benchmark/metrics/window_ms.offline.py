"""Device milliseconds a request of the work launched inside the program's
`model.window` spans (`models/swin.py::SwinBlock3D.forward`): each Video
Swin block's two window moves, LN1's output padded, rolled and cut into
windows, and the windows put back, rolled back and cropped, inside
`model.backbone`. None where the program opens no such span (a program
that predates it, or a backbone without windows)."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "Swin window moves"
MOVES = "clips_per_s"


def read(m):
    ops = m.trace.launched_in("model.window") if m.trace else []
    return sum(e["dur"] for e in ops) * 1e-3 / m.trace.records["units"] if ops else None
