"""One run of one cell: set-up, the measured (or traced) window, the check.

The cell's workload file names its configuration, its traffic and its
metrics; the configuration's file holds the program's configuration and
the work of a clip. Two loops drive the program, chosen by the traffic's
`entry`:

  serve  one closed-loop client: a request uploads a batch of host uint8
         clips, runs `detect_clip` on the main path and copies the answer
         to the host; the next starts when it has landed;
  train  `fit()`'s step body: the loader's next batch, `batch_to_device`,
         `train_step`.

Set-up makes the weights on the device from the seed, the inputs on the
host, builds the program, and warms up the cell's own shapes; a training
cell's set-up drives its first `check_steps` steps through the window's
own call and keeps what they left for the check. Every run then times a
window of `seconds`, with Python's collector quiet and no profiler; its
records feed the end-to-end metrics and the per-layer ones taken by the
host's clock. A traced run follows it with `timeline_units` requests or
steps under the profiler of the device alone (busy and idle time, device
time by kernel: it adds little to the host's work) and `trace_units` under
the whole profiler with the spans (device time by layer, idle time by what
the host was doing). After the windows the peak memory is read, the
program's state freed, and the reference judges what they produced.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import itertools
import os
import time

import numpy as np
import torch

from benchmark import check, tracing, traffic, work
from benchmark.reference import detector as ref
from benchmark.reference import training as ref_train

HERE = os.path.dirname(os.path.abspath(__file__))


def metric_path(name: str) -> str:
    """`metrics/<name>.py`, or where there is none, the file of the name's
    part before its first dot (`idle_pct.py` reads `idle_pct.live` and
    `idle_pct.train` alike)."""
    path = os.path.join(HERE, "metrics", f"{name}.py")
    return path if os.path.exists(path) else os.path.join(HERE, "metrics",
                                                          name.split(".")[0] + ".py")


def load_metric(name: str):
    """The module that reads metric `name` (`metric_path`)."""
    path = metric_path(name)
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"),
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Measure:
    """What a metric's reader reads: the cell's workload and configuration,
    the set-up's seconds, the timed window's records (`records`), and in a
    traced run the device's timeline under the light profiler (`timeline`)
    and the whole profiler's trace with the spans (`trace`), else None;
    each trace carries its own window's records (`.records`)."""

    def __init__(self, workload, config, setup_s, records, timeline=None, trace=None):
        self.workload, self.config, self.setup_s = workload, config, setup_s
        self.records, self.timeline, self.trace = records, timeline, trace


def host_usage() -> dict:
    """Wall and CPU seconds of this thread and of the process: in a
    host-bound window their ratio says how much of it the host's CPU
    worked."""
    return {"wall_s": time.perf_counter(), "thread_cpu_s": time.thread_time(),
            "process_cpu_s": time.process_time()}


@contextlib.contextmanager
def quiet_window(notes: dict):
    """The window with Python's collector frozen and off: set-up's objects
    are not scanned again and no collection pauses a request or a step.
    What the host did meanwhile goes to `notes["host"]`."""
    gc.collect()
    gc.freeze()
    gc.disable()
    before = host_usage()
    try:
        yield
    finally:
        after = host_usage()
        gc.enable()
        gc.unfreeze()
        notes["host"] = {k: after[k] - before[k] for k in after}


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def new_records() -> dict:
    """What a window counts: requests or steps (`units`), their clips, the
    requests' latencies, the host's seconds in the loader's `next`, and
    the window's seconds once it has closed."""
    return {"units": 0, "clips": 0, "latencies_s": [], "loader_wait_s": 0.0}


def windows(run, seconds, trace, traffic, device, notes):
    """The timed window, `run(records, stop)` until `seconds` have passed
    (the collector quiet); with `trace` then `timeline_units` under the
    profiler of the device alone, and `trace_units` under the whole
    profiler with the spans → (records, timeline, trace), each trace a
    `tracing.Trace` with its window's records."""
    records = new_records()
    with quiet_window(notes):
        run(records, lambda rec, t0: t0 is not None and time.perf_counter() - t0 >= seconds)
    if not trace:
        return records, None, None
    done = lambda n: lambda rec, _: rec["units"] >= n  # noqa: E731
    timed = new_records()
    timeline = tracing.Trace(tracing.profiled(
        lambda: run(timed, done(traffic["timeline_units"])), device, spans=False), timed,
        markers=torch.device(device).type == "cuda")
    traced = new_records()
    with tracing.Spans():
        events = tracing.profiled(lambda: run(traced, done(traffic["trace_units"])), device)
    per_unit = lambda r: r["window_s"] / r["units"]  # noqa: E731
    notes["seconds_a_unit"] = {"timed": per_unit(records), "timeline": per_unit(timed),
                               "traced": per_unit(traced)}
    return records, timeline, tracing.Trace(events, traced)


def _release(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def serve(workload, config, cfg, seeds, seconds, trace, device, t_start, make_server):
    t = workload["traffic"]
    B = t["batch"]
    phases = {"start": time.perf_counter() - t_start}
    weights = work.make_weights(cfg, seeds["weights"], device)
    _sync(device)
    phases["weights"] = time.perf_counter() - t_start
    server = make_server(config["config"], weights, device)
    phases["program"] = time.perf_counter() - t_start
    pool = traffic.clip_pool(t["pool_batches"] * B, cfg, seeds["data"])
    phases["inputs"] = time.perf_counter() - t_start
    order = traffic.request_order(t["pool_batches"], seeds["order"])
    props, pmask = server.proposals(B)
    sample = traffic.Reservoir(t["check_requests"], seeds["sample"])
    sent = itertools.count()
    counts = {"attempted": 0, "failed": 0}

    def request():
        which = int(order[next(sent) % len(order)])
        with tracing.span("request"):
            t0 = time.perf_counter()
            with tracing.span("upload"):
                rgb = torch.from_numpy(pool[which * B:(which + 1) * B]).to(device)
            with tracing.span("detect"):
                out = server.detect(rgb, props, pmask)
            with tracing.span("readback"):
                host = {k: v.cpu() for k, v in out.items()}
            t1 = time.perf_counter()
        return which, host, t0, t1

    for _ in range(t["warmup"]):
        request()
    _sync(device)
    setup_s = phases["warmup"] = time.perf_counter() - t_start

    def run(rec, stop):
        first = None
        while not stop(rec, first):
            which, host, t0, t1 = request()
            first = t0 if first is None else first
            rec["latencies_s"].append(t1 - t0)
            rec["clips"] += B
            rec["units"] += 1
            counts["attempted"] += 1
            if not all(bool(torch.isfinite(host[k]).all()) for k in ("tubes", "tube_scores")):
                counts["failed"] += 1
            sample.offer((which, host))
            rec["window_s"] = t1 - first

    notes = {}
    records, timeline, traced = windows(run, seconds, trace, t, device, notes)
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    del server
    _release(device)

    checked = [(torch.from_numpy(pool[w * B:(w + 1) * B]), props.cpu(), pmask.cpu(), host)
               for w, host in sample.items]
    readings, found = check.serve_readings(weights, cfg, checked, device)
    notes.update(found, setup_phases_s=phases)
    return dict(setup=setup_s, records=records, timeline=timeline, trace=traced, peak=peak,
                readings=readings, notes=notes, **counts)


def _reference_batch(dataset, meta, cfg, device):
    """A training batch worked out again from the dataset's items:
    uint8 clips, the initial cuboids, the GT padded to `max_gt_tubes`."""
    idx = [m["index"] for m in meta]
    B, G = len(idx), cfg.max_gt_tubes
    tubes, mask = ref.initial_cuboids(cfg, device)

    def pad(x):
        out = np.zeros((B, G) + x.shape[2:], x.dtype)
        n = min(G, x.shape[1])
        out[:, :n] = x[:, :n]
        return torch.from_numpy(out).to(device)

    labels = pad(dataset.labels[idx]).to(torch.int64)
    if cfg.multilabel:
        labels = torch.nn.functional.one_hot(labels, cfg.num_classes).float() * pad(
            dataset.mask[idx])[..., None]
    return {"rgb": torch.from_numpy(dataset.clips[idx]).to(device),
            "proposals": tubes[None].expand(B, *tubes.shape), "prop_mask": mask[None].expand(B, -1),
            "gt_tubes": pad(dataset.tubes[idx]), "gt_mask": pad(dataset.mask[idx]),
            "gt_labels": labels}


def train(workload, config, cfg, seeds, seconds, trace, device, t_start, make_trainer):
    t = workload["traffic"]
    B = t["batch"]
    phases = {"start": time.perf_counter() - t_start}
    weights = work.make_weights(cfg, seeds["weights"], device)
    _sync(device)
    phases["weights"] = time.perf_counter() - t_start
    generator = torch.Generator(device=device).manual_seed(seeds["masks"])
    trainer = make_trainer(config["config"], weights, device, generator)
    phases["program"] = time.perf_counter() - t_start
    dataset = traffic.TrainClips(t, cfg, seeds["data"])
    phases["inputs"] = time.perf_counter() - t_start
    loader = trainer.loader(dataset, B, seeds["loader"], t["loader_threads"])
    feed = (batch for epoch in itertools.count() for batch in loader.epoch(epoch))
    losses = []

    def step(rec):
        with tracing.span("loader_next"):
            t0 = time.perf_counter()
            batch = next(feed)
            rec["loader_wait_s"] += time.perf_counter() - t0
        with tracing.span("upload"):
            dev = trainer.to_device(batch)
        with tracing.span("step"):
            metrics = trainer.step(dev)
        losses.append(metrics["loss"].detach())
        rec["units"] += 1
        rec["clips"] += B
        return batch["meta"], metrics

    served, metas = {"losses": [], "positives": []}, []
    for i in range(t["check_steps"] + t["warmup"]):
        meta, metrics = step(new_records())
        if i < t["check_steps"]:
            metas.append(meta)
            served["losses"].append(float(losses[-1]))
            served["positives"].append(float(metrics["num_positive_per_step"][0]))
        if i == 0:
            served["grads"] = {n: (m / (1 - ref_train.B1)).cpu()
                               for n, m in trainer.first_moments().items()}
        if i == t["check_steps"] - 1:
            served["weights"] = {n: v.detach().to("cpu", copy=True)
                                 for n, v in trainer.weights().items()}
    _sync(device)
    setup_s = phases["first_steps"] = time.perf_counter() - t_start
    losses.clear()

    def run(rec, stop):
        t0 = time.perf_counter()
        while not stop(rec, t0):
            step(rec)
        _sync(device)
        rec["window_s"] = time.perf_counter() - t0

    notes = {}
    try:
        records, timeline, traced = windows(run, seconds, trace, t, device, notes)
    finally:
        feed.close()
    failed = int((~torch.isfinite(torch.stack(losses))).sum()) if losses else 0
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
    del trainer, loader, feed
    _release(device)

    batches = [_reference_batch(dataset, m, cfg, device) for m in metas]
    generator.manual_seed(seeds["masks"])
    readings, found = check.train_readings(weights, cfg, batches, generator, served, device)
    notes.update(found, setup_phases_s=phases)
    return dict(setup=setup_s, records=records, timeline=timeline, trace=traced, peak=peak,
                readings=readings, notes=notes, attempted=len(losses), failed=failed)


ENTRIES = {"serve": serve, "train": train}


def run_cell(workload, config, per_layer, seed, seconds, trace, device, t_start,
             program=None):
    """One run → the result's fields: correct, attempted, failed, metrics,
    peak memory, breakdown (traced runs) and the checks. `per_layer` names
    the per-layer metrics this cell reports; `program` replaces the
    program's server or trainer factory (the controls and faults)."""
    from benchmark import program as prog

    cfg = ref.config(config["config"])
    entry = workload["traffic"]["entry"]
    make = program or {"serve": prog.Server, "train": prog.Trainer}[entry]
    out = ENTRIES[entry](workload, config, cfg, work.sub_seeds(seed), seconds, trace, device,
                         t_start, make)
    measure = Measure(workload, config, out["setup"], out["records"], out["timeline"],
                      out["trace"])
    names = per_layer if trace else workload["end_to_end"]
    metrics = {}
    for metric in names:
        module = load_metric(metric)
        value = module.read(measure)
        if value is not None:
            metrics[metric] = {"value": value, "unit": module.UNIT}
    correct, checks = check.verdict(out["readings"], workload["limits"])
    result = {"correct": bool(correct and out["failed"] == 0), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "peak": out["peak"]}
    if out["timeline"] is not None:
        line, tr = out["timeline"], out["trace"]
        result["busy_s"], result["window_s"] = line.busy_s, line.window_s
        result["breakdown"] = {"device_ops": line.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["notes"] = out["notes"]
    result["checks"] = checks
    return result
