"""The recorded window's reductions (`benchmark/recorded.py`) and their
readers, `host_gap_ms.offline` and `first_detect_s.offline`, on synthetic
recorded spans and device events: each value, the idle split by span
summing to the window's idle, and nothing where the program records no
such span (a program that predates `spans.recording()`). Then a traced run
of a tiny cell on the CPU with set-up and the recorded window spliced in
(`recorded_run.spliced`, at the repository's root): the recorded window's
requests reach the device path, and none is offered to the check's
sample."""

import time

import pytest
import torch

from benchmark import recorded
from benchmark.cell import Measure, load_metric
from conftest import tiny_cell

BASE = 10 ** 18
MAIN, OTHER = 7, 8


def ns(us):
    return BASE + int(us * 1000)


def kernel(ts, dur):
    return {"ph": "X", "cat": "kernel", "name": "k", "ts": ts, "dur": dur}


# µs after BASE: the markers at 0 and 999 bound the window (and, as in
# `idle_pct`, are not the program's work); three kernels.
EVENTS = [kernel(0, 1), kernel(10, 100), kernel(200, 300), kernel(600, 200), kernel(999, 1)]
IDLE = 10 + 90 + 100 + 200
SPANS = [("request", 5, 995), ("upload", 5, 50), ("detect", 60, 900),
         ("detect.clip", 60, 880), ("model.backbone", 100, 450), ("model.refine", 480, 700),
         ("readback", 905, 990)]


def window(spans=SPANS, other=(("loader.wait", 0, 1000),)):
    kept = [(n, ns(a), ns(b), MAIN) for n, a, b in spans]
    kept += [(n, ns(a), ns(b), OTHER) for n, a, b in other]
    return recorded.Recorded(EVENTS, BASE, kept, {"units": 2, "clips": 64}, MAIN)


SETUP = [("setup.kernels.build", ns(1.5e6), ns(2.5e6), MAIN),
         ("setup.kernels", ns(1e6), ns(3e6), MAIN), ("detect.clip", ns(0), ns(5e6), MAIN),
         ("detect.clip", ns(6e6), ns(6.1e6), MAIN)]


def measure(r=None, setup=None):
    m = Measure({}, {}, 1.0, {})
    m.recorded, m.setup_spans = r, setup
    return m


def test_the_idle_split_by_innermost_span_sums_to_the_windows_idle():
    r = window()
    assert r.idle_s == pytest.approx(IDLE * 1e-6)
    gaps = dict(recorded.idle_gaps(r))
    want = {"outside spans": 10, "upload": 5, "model.backbone": 90, "model.refine": 100,
            "detect.clip": 80, "detect": 20, "request": 10, "readback": 85}
    assert gaps == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert sum(gaps.values()) == pytest.approx(r.idle_s, rel=1e-9)
    assert list(gaps) == sorted(gaps, key=lambda k: -gaps[k])


def test_host_gap_is_the_idle_inside_detect_clip_a_request():
    assert recorded.host_gap_ms(window()) == pytest.approx((90 + 100 + 80) * 1e-3 / 2)
    assert load_metric("host_gap_ms.offline").read(measure(window())) == pytest.approx(0.135)


def test_first_detect_is_the_first_calls_seconds_less_the_kernel_librarys():
    assert recorded.first_detect_s(SETUP) == pytest.approx(5.0 - 2.0)
    assert load_metric("first_detect_s.offline").read(measure(setup=SETUP)) == pytest.approx(3.0)
    assert recorded.setup_spans_s(SETUP) == pytest.approx(
        {"detect.clip": 5.1, "setup.kernels": 2.0, "setup.kernels.build": 1.0})


def test_a_program_without_the_spans_reads_nothing():
    benchmarks_own = [s for s in SPANS if "." not in s[0]]
    assert recorded.host_gap_ms(window(benchmarks_own)) is None
    assert recorded.idle_gaps(window(benchmarks_own)) is None
    assert recorded.first_detect_s([s for s in SETUP if s[0] != "detect.clip"]) is None
    for empty in (None, []):
        assert recorded.first_detect_s(empty) is None
        assert recorded.setup_spans_s(empty) is None
    assert recorded.host_gap_ms(None) is None and recorded.idle_gaps(None) is None
    older = Measure({}, {}, 1.0, {})        # the Measure of a harness with no recorded window
    for name in ("host_gap_ms.offline", "first_detect_s.offline"):
        assert load_metric(name).read(older) is None
        assert load_metric(name).read(measure()) is None


def test_a_spliced_traced_run_records_set_up_and_a_fourth_window_outside_the_sample(
        monkeypatch):
    from benchmark import cell, traffic
    from recorded_run import spliced

    offered = []

    class Counted(traffic.Reservoir):
        def offer(self, item):
            offered.append(item[0])
            super().offer(item)

    monkeypatch.setattr(traffic, "Reservoir", Counted)
    workload, config = tiny_cell("ucf_3step.offline_b32")
    found = {}
    with spliced(found):
        out = cell.run_cell(workload, config, [], 3, 0.2, True, torch.device("cpu"),
                            time.perf_counter())
    assert cell.windows.__name__ == "windows" and traffic.Reservoir is Counted
    units = workload["traffic"]["timeline_units"]
    r = found["recorded"]
    assert r.records["units"] == units and out["correct"]
    assert len(offered) == out["attempted"] - units
    names = [s[0] for s in r.spans]
    assert names.count("detect.clip") == names.count("request") == units
    assert {"upload", "detect", "readback", "model.backbone", "detect.nms"} <= set(names)
    assert [s[0] for s in found["setup"]].count("detect.clip") == workload["traffic"]["warmup"]
    assert recorded.first_detect_s(found["setup"]) > 0
    assert set(out["notes"]["seconds_a_unit"]) == {"timed", "timeline", "traced"}
