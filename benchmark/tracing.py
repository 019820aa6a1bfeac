"""Spans around the benchmark's own steps, the profiler over a traced
window, and the reduction of its trace to the numbers the per-layer
metrics read.

Spans are `torch.profiler.record_function` ranges. The benchmark opens its
own (`request`, `upload`, `detect`, `readback`, `loader_next`, `step`) while
a `Spans` is open; the program opens its own inside them under any profiler
(`model.backbone`, `model.refine`, `model.head`, `detect.nms`, ...). A
device operation belongs to the spans its launch lies in (the runtime call
of the same correlation id).

The whole profiler records every operator the host dispatches and slows a
host-bound loop by half or more; the device's timeline is therefore taken
apart, under the profiler of the device alone, between two marker
operations that bound its window.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch
from torch.profiler import ProfilerActivity, profile, record_function

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
WINDOW = "window"


_ON = [False]


class Spans:
    """The benchmark's own spans on while open (`with Spans():`)."""

    def __enter__(self):
        _ON[0] = True
        return self

    def __exit__(self, *exc):
        _ON[0] = False


def span(name: str):
    """The span `name` while a `Spans` is open, else nothing."""
    return record_function(name) if _ON[0] else contextlib.nullcontext()


def profiled(run, device, spans: bool = True) -> list:
    """Run `run()` under the profiler inside a `window` span that ends once
    the device has finished → the chrome trace's events. Without `spans`,
    on a card, only the device is profiled, and a marker operation on the
    idle device opens and closes the window. The trace file is written to
    the temporary directory and removed."""
    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CUDA] if cuda else []
    if spans or not cuda:
        activities.append(ProfilerActivity.CPU)
    marker = torch.zeros(1, device=device) if cuda and not spans else None
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            if marker is not None:
                torch.cuda.synchronize(device)
                marker.add_(1)
            run()
            if cuda:
                torch.cuda.synchronize(device)
            if marker is not None:
                marker.add_(1)
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Trace:
    """The events of one traced window and the window's `records`. The
    window is its `window` span, or where the host was not profiled, the
    span of the device's operations from the first marker to the last.
    Times are seconds."""

    def __init__(self, events: list, records: dict | None = None, markers: bool = False):
        self.records = records or {}
        xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
        spans = [e for e in xs if e.get("cat") == "user_annotation"]
        window = [e for e in spans if e["name"] == WINDOW]
        device = sorted((e for e in xs if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
        bounds = device
        if markers and len(device) >= 2:
            bounds, device = device, device[1:-1]
        if window:
            w = max(window, key=lambda e: e["dur"])
            self.start, self.end = w["ts"], w["ts"] + w["dur"]
        elif bounds:
            self.start = bounds[0]["ts"]
            self.end = max(e["ts"] + e["dur"] for e in bounds)
        else:
            raise ValueError("the trace holds no window span and no device operation")
        self.spans = [e for e in spans if e["name"] != WINDOW]
        self.device = [e for e in device if e["ts"] + e["dur"] > self.start and e["ts"] < self.end]
        self.launch = {e["args"]["correlation"]: e["ts"] for e in xs
                       if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}

    @property
    def window_s(self) -> float:
        return (self.end - self.start) * 1e-6

    def busy(self):
        return _merge([(max(e["ts"], self.start), min(e["ts"] + e["dur"], self.end))
                       for e in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) * 1e-6

    def kernels(self, *fragments) -> list:
        """Kernel events whose name holds one of `fragments` (all kernels
        where none is given)."""
        return [e for e in self.device if e.get("cat") == "kernel"
                and (not fragments or any(f in e["name"] for f in fragments))]

    def memcpy(self, kind: str) -> list:
        return [e for e in self.device if e.get("cat") == "gpu_memcpy" and kind in e["name"]]

    def launched_in(self, name: str) -> list:
        """Device events launched while a span `name` was open."""
        ranges = [(s["ts"], s["ts"] + s["dur"]) for s in self.spans if s["name"] == name]
        out = []
        for e in self.device:
            t = self.launch.get(e.get("args", {}).get("correlation"))
            if t is not None and any(a <= t <= b for a, b in ranges):
                out.append(e)
        return out

    def span_seconds(self, name: str) -> float:
        return sum(s["dur"] for s in self.spans if s["name"] == name) * 1e-6

    def innermost(self, t: float) -> str:
        inside = [s for s in self.spans if s["ts"] <= t <= s["ts"] + s["dur"]]
        return min(inside, key=lambda s: s["dur"])["name"] if inside else "outside spans"

    def device_ops(self, top: int = 10):
        total = {}
        for e in self.device:
            key = e["name"][:160]
            total[key] = total.get(key, 0.0) + e["dur"] * 1e-6
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:top]

    def idle_gaps(self, top: int = 10):
        """Idle time on the device, summed by the innermost span the host
        was in at the middle of each gap."""
        busy = self.busy()
        edges = [self.start] + [x for ab in busy for x in ab] + [self.end]
        total = {}
        for a, b in zip(edges[::2], edges[1::2]):
            if b > a:
                name = self.innermost((a + b) / 2)
                total[name] = total.get(name, 0.0) + (b - a) * 1e-6
        return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:top]

