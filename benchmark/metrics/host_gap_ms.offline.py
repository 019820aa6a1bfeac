"""Device idle milliseconds a request in the recorded window
(`benchmark/recorded.py`: the profiler of the device alone, the program's
spans recorded on the host's clock, so the host runs as in the timed
window) while the host was inside the program's `detect.clip`: the
program's host code pacing the card. None where the run has no recorded
window or the program records no such span."""

from benchmark import recorded

UNIT = "ms"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "host dispatch"
MOVES = "clips_per_s"


def read(m):
    return recorded.host_gap_ms(getattr(m, "recorded", None))
