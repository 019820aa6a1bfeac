"""Process start to the first timed request or step: interpreter and
library start, weights made on the device, inputs made on the host, the
program built, its kernels loaded or built, the cell's shapes warmed up
(and a training cell's first steps)."""

UNIT = "s"
BETTER = "lower"
SOURCE = "host_clock"


def read(m):
    return m.setup_s
