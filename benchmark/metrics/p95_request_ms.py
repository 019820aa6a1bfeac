"""The 95th percentile over all requests completed in the window, each
timed from the host holding its clips to the host holding its detections
(numpy's linear percentile)."""

import numpy as np

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"


def read(m):
    lat = m.records.get("latencies_s")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
