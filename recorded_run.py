"""One traced run of a benchmark cell with its set-up and a fourth window
recorded.

    python3 recorded_run.py --workload <cell> --seed <n> --seconds <s>
        [--metrics <name> ...]

The run is `run.py --trace 1`'s, window for window, and then:

  set-up      the program's `spans.recording()` open from set-up's start to
              the end of warm-up;
  recorded    after the timed, timeline and traced windows, `timeline_units`
              requests under the profiler of the device alone with the
              recording open and the benchmark's own spans recorded with the
              program's (`recorded.recorded_window`); its requests are not
              offered to the check's sample, so the check judges the same
              requests as `run.py`'s.

`benchmark/cell.py` runs neither piece itself: this wraps its `windows`
and the sample's `traffic.Reservoir` for the one run. It lives beside the
benchmark, not in it, because it reaches the program's spans
(`step_tpu_torch.utils.spans`) directly, and inside `benchmark/` only
`program.py` imports the program. The last line of standard output is
`run.py`'s result with each metric `--metrics` names read from the
recorded window and set-up (`Measure.recorded`, `Measure.setup_spans`), and
its `notes`: `run.py`'s, with `seconds_a_unit.recorded`, `recorded_idle_s`,
`idle_gaps_untraced` and `setup_spans_s`. A program with no
`spans.recording()` runs the three windows alone and adds nothing.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.join(ROOT, "benchmark")


def program_spans():
    """The program's spans module where it records (`recording`), else None."""
    from step_tpu_torch.utils import spans

    return spans if hasattr(spans, "recording") else None


@contextlib.contextmanager
def spliced(found: dict):
    """`cell.run_cell` with set-up recorded into `found["setup"]` and, in a
    traced run, the recorded window after the other three into
    `found["recorded"]`."""
    from benchmark import cell, recorded, tracing, traffic

    spans = program_spans()
    if spans is None:
        yield
        return
    windows, reservoir, span = cell.windows, traffic.Reservoir, tracing.span
    paused = [False]

    class Sample(reservoir):
        def offer(self, item):
            if not paused[0]:
                super().offer(item)

    def with_recorded(run, seconds, trace, t, device, notes):
        setup.close()
        out = windows(run, seconds, trace, t, device, notes)
        if trace:
            paused[0], tracing.span = True, spans.span
            try:
                found["recorded"] = recorded.recorded_window(run, t["timeline_units"], device,
                                                             spans.recording)
            finally:
                paused[0], tracing.span = False, span
        return out

    with contextlib.ExitStack() as setup:
        found["setup"] = setup.enter_context(spans.recording())
        cell.windows, traffic.Reservoir = with_recorded, Sample
        try:
            yield
        finally:
            cell.windows, traffic.Reservoir = windows, reservoir


def main(argv=None) -> int:
    from benchmark import run

    t_start = run.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--metrics", nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card", file=sys.stderr)
        return 2
    from benchmark import cell, recorded

    workload = run.load_json(BENCH, "workloads", f"{args.workload}.json")
    config = run.load_json(BENCH, "configs", f"{workload['config']}.json")
    per_layer = run.per_layer_metrics(args.workload, workload["end_to_end"])
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    found = {}
    with spliced(found):
        out = cell.run_cell(workload, config, per_layer, args.seed, args.seconds, True, device,
                            t_start)
    if run.forbidden_modules():
        print(f"loaded in the benchmark's process: {run.forbidden_modules()}", file=sys.stderr)
        return 3
    measure = cell.Measure(workload, config, None, None)
    measure.recorded, measure.setup_spans = found.get("recorded"), found.get("setup")
    for name in args.metrics:
        module = cell.load_metric(name)
        value = module.read(measure)
        if value is not None:
            out["metrics"][name] = {"value": value, "unit": module.UNIT}
    notes, r = out["notes"], measure.recorded
    if r is not None:
        notes["seconds_a_unit"]["recorded"] = r.records["window_s"] / r.records["units"]
        notes["recorded_idle_s"] = r.idle_s
        notes["idle_gaps_untraced"] = recorded.idle_gaps(r)
    if measure.setup_spans is not None:
        notes["setup_spans_s"] = recorded.setup_spans_s(measure.setup_spans)
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": workload["chips"], "memory_peak_bytes": out["peak"],
                   "power_limit": run.power_limit(), "busy_s": out["busy_s"],
                   "window_s": out["window_s"]}
    print(json.dumps({"correct": out["correct"], "attempted": out["attempted"],
                      "failed": out["failed"], "metrics": out["metrics"], "device": device_info,
                      "breakdown": out["breakdown"], "checks": out["checks"], "notes": notes}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
