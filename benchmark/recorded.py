"""The recorded window, and what it and set-up's recorded spans reduce to.

The recorded window is `timeline_units` requests under the profiler of the
device alone, as the timeline window runs them, while the program's
`spans.recording()` keeps every span it opens on the host's clock (no host
event is profiled, so the host runs as in the timed window). A recorded
span is `(name, start_ns, end_ns, thread)` on the clock of the profiler's
chrome trace: a device event's `ts` is µs after the trace's
`baseTimeNanoseconds`. The benchmark's own spans (`request`, `upload`,
`detect`, `readback`) are recorded with the program's in that window, so
each idle stretch of the device goes to the innermost span, the program's
or the benchmark's, that the host was in. Set-up is recorded the same way,
from its start to the end of warm-up.

`recorded_run.py`, at the repository's root, adds both to a traced run.
Each reduction returns None where the program recorded no such span, as a
program that predates `recording()` records none.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from benchmark import tracing

OUTSIDE = "outside spans"


def profiled(run, device) -> tuple[list, int]:
    """Run `run()` as `tracing.profiled(run, device, spans=False)` runs it
    (on a card: the device alone, between two marker operations on the idle
    device) → (the chrome trace's events, its `baseTimeNanoseconds`)."""
    cuda = torch.device(device).type == "cuda"
    marker = torch.zeros(1, device=device) if cuda else None
    with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW):
            if cuda:
                torch.cuda.synchronize(device)
                marker.add_(1)
            run()
            if cuda:
                torch.cuda.synchronize(device)
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
    return data["traceEvents"], int(data.get("baseTimeNanoseconds", 0))


class Recorded:
    """A recorded window: the device's timeline (`timeline`, a
    `tracing.Trace` bounded by its markers), the window's `records`, and the
    spans of `thread` (`spans`: `(name, start, end)` in µs on the trace's
    clock)."""

    def __init__(self, events: list, base_ns: int, spans, records: dict, thread: int,
                 markers: bool = True):
        self.timeline = tracing.Trace(events, records, markers=markers)
        self.records = records
        self.spans = [(name, (a - base_ns) / 1e3, (b - base_ns) / 1e3)
                      for name, a, b, t in spans if t == thread]

    def idle(self) -> list:
        """The window's idle stretches, `(start, end)` in µs."""
        t, out = self.timeline.start, []
        for a, b in self.timeline.busy():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.timeline.end > t:
            out.append((t, self.timeline.end))
        return out

    @property
    def idle_s(self) -> float:
        return sum(b - a for a, b in self.idle()) * 1e-6


def recorded_window(run, units: int, device, recording) -> Recorded:
    """`units` requests or steps of the cell's `run(records, stop)` under
    `profiled`, with the program's `recording()` open → `Recorded`."""
    from benchmark.cell import new_records

    records = new_records()
    with recording() as spans:
        events, base = profiled(lambda: run(records, lambda rec, _: rec["units"] >= units),
                                device)
    return Recorded(events, base, list(spans), records, threading.get_native_id(),
                    markers=torch.device(device).type == "cuda")


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def innermost(spans, gaps) -> dict:
    """{name: time} of `gaps` (disjoint `(start, end)` pairs) put down to the
    innermost of `spans` (`(name, start, end)` of one thread, so nested)
    open over each part of them, `OUTSIDE` where none is: the parts sum to
    the gaps."""
    bounds = sorted({t for _, a, b in spans for t in (a, b)} | {t for g in gaps for t in g})
    opened = sorted(spans, key=lambda s: (s[1], -s[2]))
    gaps = sorted(gaps)
    out, stack, i, k = {}, [], 0, 0
    for a, b in zip(bounds, bounds[1:]):
        while i < len(opened) and opened[i][1] <= a:
            stack.append(opened[i])
            i += 1
        while stack and stack[-1][2] <= a:
            stack.pop()
        while k < len(gaps) and gaps[k][1] <= a:
            k += 1
        if k < len(gaps) and gaps[k][0] <= a:
            inside = [s for s in stack if s[2] > a]
            name = inside[-1][0] if inside else OUTSIDE
            out[name] = out.get(name, 0.0) + (b - a)
    return out


def host_gap_ms(r: Recorded | None) -> float | None:
    """Device idle ms a request while the host was inside the program's
    `detect.clip`."""
    clips = tracing._merge((a, b) for name, a, b in (r.spans if r else ()) if name == "detect.clip")
    if not clips:
        return None
    return _overlap(r.idle(), clips) * 1e-3 / r.records["units"]


def idle_gaps(r: Recorded | None) -> list | None:
    """[[span, idle seconds]] of the window, every span's, largest first:
    the breakdown's `idle_gaps`, from a host that no profiler slowed."""
    if r is None or not any("." in name for name, _, _ in r.spans):
        return None
    split = innermost(r.spans, r.idle())
    return sorted(([k, v * 1e-6] for k, v in split.items()), key=lambda kv: -kv[1])


def first_detect_s(setup) -> float | None:
    """Host seconds of set-up's first `detect.clip`, less the
    `setup.kernels` spans inside it: the first call's one-time work (the
    first cuDNN, cuBLAS and attention calls' plans, allocations) without
    the kernel library's load or build."""
    clips = sorted((s for s in setup or () if s[0] == "detect.clip"), key=lambda s: s[1])
    if not clips:
        return None
    _, a, b, thread = clips[0]
    kernels = sum(e - s for name, s, e, t in setup
                  if name == "setup.kernels" and t == thread and a <= s and e <= b)
    return (b - a - kernels) * 1e-9


def setup_spans_s(setup) -> dict | None:
    """{span: host seconds} over set-up, largest first."""
    if not setup:
        return None
    out = {}
    for name, a, b, _ in setup:
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
