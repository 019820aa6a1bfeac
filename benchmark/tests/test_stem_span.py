"""`stem_ms.offline` on a synthetic trace: the device time launched inside
the program's `model.stem` span (nested in `model.backbone`), a request's
share, and nothing where the program opens no such span."""

from benchmark import tracing
from benchmark.cell import Measure, load_metric

# Two requests' worth in µs (`units` 2): the stem's launch inside the
# backbone's span, another backbone launch outside the stem's.
SPANS = [("window", 0, 2000), ("model.backbone", 100, 400), ("model.stem", 110, 40)]
LAUNCHES = [(120, "stem_conv_kernel", 50), (300, "conv_kernel", 80)]


def trace(spans):
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts, "dur": d}
              for n, ts, d in spans]
    for corr, (ts, name, dur) in enumerate(LAUNCHES, 1):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                       "dur": 2, "args": {"correlation": corr}})
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": ts + 5, "dur": dur,
                       "args": {"correlation": corr}})
    return tracing.Trace(events, {"units": 2, "clips": 64})


def read(t):
    return load_metric("stem_ms.offline").read(Measure({}, {}, 1.0, {}, t, t))


def test_the_stem_metric_reads_the_device_time_launched_in_the_stem_span():
    assert read(trace(SPANS)) == 50e-3 / 2
    assert load_metric("backbone_ms.offline").read(
        Measure({}, {}, 1.0, {}, trace(SPANS), trace(SPANS))) == (50 + 80) * 1e-3 / 2


def test_a_program_without_the_stem_span_reads_nothing():
    assert read(trace(SPANS[:2])) is None
    assert load_metric("stem_ms.offline").read(Measure({}, {}, 1.0, {}, None, None)) is None
