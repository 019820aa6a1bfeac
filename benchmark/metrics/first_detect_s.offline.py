"""Host seconds of the program's first `detect.clip` in set-up, less the
`setup.kernels` spans inside it (the kernel library's load, and nvcc's
build where it ran), from set-up's recorded spans (`benchmark/recorded.py`):
the first call's one-time work, the first cuDNN, cuBLAS and attention
calls among it. None where set-up was not recorded or the program records
no such span."""

from benchmark import recorded

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "set-up"
MOVES = "setup_s"


def read(m):
    return recorded.first_detect_s(getattr(m, "setup_spans", None))
