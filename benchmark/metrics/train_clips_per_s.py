"""Clips of all training steps completed in the window over the window's
seconds; the window ends once the card has finished the last step it
counts."""

UNIT = "clips/s"
BETTER = "higher"
SOURCE = "host_clock"


def read(m):
    r = m.records
    return r["clips"] / r["window_s"] if r.get("window_s") else None
