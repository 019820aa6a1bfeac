"""Host milliseconds a step of the timed window spent in the loader's
`next` (`data/loader.py`, `data/pipeline.py`), by the host's clock."""

UNIT = "ms"
BETTER = "lower"
SOURCE = "host_clock"
LAYER = "data loader"
MOVES = "train_clips_per_s"


def read(m):
    r = m.records
    return r["loader_wait_s"] * 1e3 / r["units"] if r.get("units") else None
