"""The per-layer metrics read from the program's own spans
(`step_tpu_torch/utils/spans.py`) on a synthetic trace: device time
launched inside `model.preprocess`, `model.backbone`, `model.refine`,
`model.head` and `detect.nms`, a request's share each, and nothing where
the program opens no such span (a program that predates them)."""

import pytest

from benchmark import tracing
from benchmark.cell import Measure, load_metric

NAMES = {"preprocess_ms.offline": "model.preprocess", "backbone_ms.offline": "model.backbone",
         "refine_ms.offline": "model.refine", "head_ms.offline": "model.head",
         "nms_ms.offline": "detect.nms"}

# One request's layout in µs, read as two requests (`units` 2): the
# benchmark's `detect` span around the program's spans, launches (and their
# kernels) in each.
SPANS = [("window", 0, 2000), ("detect", 0, 1000), ("model.preprocess", 10, 40),
         ("model.backbone", 60, 200), ("model.refine", 300, 500),
         ("model.head", 320, 100), ("model.boxes", 430, 20), ("model.head", 560, 100),
         ("model.boxes", 670, 20), ("detect.nms", 820, 60)]
LAUNCHES = [(20, "elementwise_kernel", 30), (100, "conv_kernel", 300),
            (310, "tube_roi_align_kernel", 40), (330, "max_pool3d", 120),
            (440, "decode_kernel", 10), (570, "max_pool3d", 110), (680, "decode_kernel", 10),
            (830, "softmax_kernel", 5), (840, "nms_groups_kernel", 20)]


def event(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def trace(spans=SPANS):
    events = [event("user_annotation", name, ts, dur) for name, ts, dur in spans]
    start = 0
    for corr, (ts, name, dur) in enumerate(LAUNCHES, 1):
        events.append(event("cuda_runtime", "cudaLaunchKernel", ts, 2, corr))
        start = max(start, ts + 5)
        events.append(event("kernel", name, start, dur, corr))
        start += dur
    return tracing.Trace(events, {"units": 2, "clips": 64})


def read(name, t):
    return load_metric(name).read(Measure({}, {}, 1.0, {}, t, t))


def test_each_metric_reads_the_device_time_launched_in_its_span_a_request():
    t = trace()
    assert read("preprocess_ms.offline", t) == pytest.approx(30e-3 / 2)
    assert read("backbone_ms.offline", t) == pytest.approx(300e-3 / 2)
    assert read("refine_ms.offline", t) == pytest.approx((40 + 120 + 10 + 110 + 10) * 1e-3 / 2)
    assert read("head_ms.offline", t) == pytest.approx((120 + 110) * 1e-3 / 2)
    assert read("nms_ms.offline", t) == pytest.approx((5 + 20) * 1e-3 / 2)


def test_the_program_spans_split_the_detect_span_and_name_its_idle_gaps():
    t = trace()
    dur = lambda name: sum(e["dur"] for e in t.launched_in(name))  # noqa: E731
    stages = ("model.preprocess", "model.backbone", "model.refine", "detect.nms")
    assert sum(dur(s) for s in stages) == dur("detect")
    assert set(dict(t.idle_gaps())) & {"model.refine", "model.head", "model.boxes"}


@pytest.mark.parametrize("name", sorted(NAMES))
def test_a_trace_without_the_programs_span_reads_nothing(name):
    older = [s for s in SPANS if s[0] != NAMES[name]]
    assert read(name, trace(older)) is None
    benchmarks_own = [s for s in SPANS if "." not in s[0]]
    assert read(name, trace(benchmarks_own)) is None
    assert load_metric(name).read(Measure({}, {}, 1.0, {}, None, None)) is None
