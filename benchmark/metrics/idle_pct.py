"""Share of the device's timeline with no kernel or copy on the device,
under the profiler of the device alone (`idle_pct.<cells>`: one file for
every cell; `BENCHMARK.json` says which end-to-end metric each moves)."""

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device"


def read(m):
    t = m.timeline
    if not t or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
