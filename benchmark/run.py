"""Run one cell of the benchmark once, on the machine it is started on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is `benchmark/workloads/<cell>.json`; its configuration
`benchmark/configs/<config>.json`; each metric `benchmark/metrics/<name>.py`.
With `--trace 0` the result carries the cell's end-to-end metrics, with
`--trace 1` the per-layer metrics that `BENCHMARK.json` lists for it, the
device's busy and window seconds and the breakdown. The last line of
standard output is the result as one JSON object; the last lines of
standard error are the numbers the check compared, each beside its limit.

Exits non-zero, with no result, without a CUDA device (or with fewer than
the cell asks for), or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "step_tpu")
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT        # the package, not its modules, on the path


def process_start() -> float:
    """The process's start on the `perf_counter` clock, from its start time
    in /proc where the system has one."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return T_START - max(0.0, min(age, 60.0))
    except (OSError, ValueError, IndexError):
        return T_START


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def per_layer_metrics(cell: str, end_to_end) -> list:
    """The per-layer metrics BENCHMARK.json lists for `cell`: those naming
    it under `workloads`, and those without the key whose end-to-end
    metric the cell reports."""
    bench = load_json(ROOT, "BENCHMARK.json")
    return [m["name"] for m in bench["per_layer"]
            if cell in m.get("workloads", ()) or
            ("workloads" not in m and m["moves"] in end_to_end)]


def power_limit() -> str:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                              "-i", "0"], capture_output=True, text=True, timeout=30)
        return smi.stdout.strip() if smi.returncode == 0 else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card", file=sys.stderr)
        return 2
    workload = load_json(HERE, "workloads", f"{args.workload}.json")
    if torch.cuda.device_count() < workload["chips"]:
        print(f"{args.workload} needs {workload['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    config = load_json(HERE, "configs", f"{workload['config']}.json")
    per_layer = per_layer_metrics(args.workload, workload["end_to_end"])

    from benchmark.cell import run_cell

    torch.set_num_threads(1)        # one process, one intra-op thread: a steadier host
    device = torch.device("cuda", 0)
    out = run_cell(workload, config, per_layer, args.seed, args.seconds,
                   bool(args.trace), device, t_start)
    found = forbidden_modules()
    if found:
        print(f"loaded in the benchmark's process: {', '.join(found)}", file=sys.stderr)
        return 3
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                   "count": workload["chips"], "memory_peak_bytes": out["peak"],
                   "power_limit": power_limit()}
    if args.trace:
        device_info["busy_s"], device_info["window_s"] = out["busy_s"], out["window_s"]
    result = {"correct": out["correct"], "attempted": out["attempted"],
              "failed": out["failed"], "metrics": out["metrics"], "device": device_info}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["checks"] = out["checks"]
    print(f"notes {json.dumps(out['notes'])}", file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
