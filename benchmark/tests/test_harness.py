"""The harness's pieces on tiny inputs: the inputs from a seed, the window's
arithmetic, the tail over every request, the reduction of a trace, the
guard against JAX, and the refusals of the command."""

import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

from conftest import ROOT, tiny_cell
from benchmark import traffic, tracing, work
from benchmark.cell import Measure, load_metric
from benchmark.reference import detector as ref


def test_the_clip_pool_and_order_come_from_the_seed():
    cfg = types.SimpleNamespace(image_size=8, total_frames=3)
    a, b, c = (traffic.clip_pool(4, cfg, s) for s in (5, 5, 6))
    assert a.shape == (4, 3, 8, 8, 3) and a.dtype == np.uint8
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    order = traffic.request_order(4, 2 ** 31 + 11)
    assert sorted(order) == [0, 1, 2, 3]
    cycled = [order[i % 4] for i in range(12)]
    assert all(x != y for x, y in zip(cycled, cycled[1:]))


def test_sub_seeds_take_large_seeds_and_differ():
    s = work.sub_seeds(2 ** 31 + 123456789)
    assert s == work.sub_seeds(2 ** 31 + 123456789) and len(set(s.values())) == len(s)
    assert s != work.sub_seeds(2 ** 31 + 123456790)


def test_the_training_clips_hold_their_boxes_in_the_image():
    cfg = types.SimpleNamespace(image_size=32, total_frames=6, num_classes=5)
    clips = traffic.TrainClips({"pool_clips": 6, "gt_slots": 2, "gt_tubes": [1, 2]}, cfg, 3)
    item = clips[2]
    assert item["rgb"].dtype == np.float32 and item["rgb"].max() <= 1.0
    assert np.array_equal((item["rgb"] * 255 + 0.5).astype(np.uint8), clips.clips[2])
    assert 1 <= item["gt_mask"].sum() <= 2 and item["index"] == 2
    tubes = clips.tubes[clips.mask > 0]
    assert tubes.min() >= 0 and tubes.max() <= 32
    assert (tubes[..., 2] > tubes[..., 0]).all() and (tubes[..., 3] > tubes[..., 1]).all()


def test_the_reservoir_is_a_seeded_uniform_sample():
    def draw(seed):
        r = traffic.Reservoir(3, seed)
        for i in range(100):
            r.offer(i)
        return r.items
    assert draw(1) == draw(1) and len(draw(1)) == 3
    counts = np.zeros(100)
    for seed in range(300):
        counts[draw(seed)] += 1
    assert counts.min() > 0 and counts[:10].sum() < 0.2 * counts.sum()


def measure(records, timeline=None, trace=None, workload=None, config=None, setup_s=1.0):
    return Measure(workload or {}, config or {}, setup_s, records, timeline, trace)


def test_rates_divide_all_the_work_by_the_whole_window():
    m = measure({"clips": 96, "window_s": 0.5, "units": 12, "loader_wait_s": 0.024},
                workload={"traffic": {"entry": "train"}},
                config={"work": {"flops_train": 989e9 / 192}})
    assert load_metric("clips_per_s").read(m) == 192.0
    assert load_metric("train_clips_per_s").read(m) == 192.0
    assert load_metric("setup_s").read(m) == 1.0
    assert load_metric("loader_wait_ms.train").read(m) == pytest.approx(2.0)
    assert load_metric("mfu.train").read(m) == pytest.approx(100 * 989e9 / 989e12)
    assert load_metric("clips_per_s").read(measure({"clips": 0})) is None


def test_a_metric_without_a_file_of_its_own_is_read_by_its_names_first_part():
    assert load_metric("idle_pct.train").__file__.endswith("idle_pct.py")
    assert load_metric("mfu.offline").__file__.endswith("mfu.py")
    assert load_metric("p95_request_ms").__file__.endswith("p95_request_ms.py")


def test_the_tail_is_taken_over_every_request():
    lat = [0.010] * 94 + [0.050] * 6
    p95 = load_metric("p95_request_ms").read(measure({"latencies_s": lat}))
    assert 10.0 < p95 <= 50.0
    assert load_metric("p95_request_ms").read(measure({"latencies_s": [0.01] * 100})) == \
        pytest.approx(10.0)


def event(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


TRACE = [
    event("user_annotation", "window", 0, 1000),
    event("user_annotation", "upload", 0, 100),
    event("user_annotation", "model.backbone", 100, 300),
    event("user_annotation", "model.refine", 400, 500),
    event("cuda_runtime", "cudaMemcpyAsync", 10, 5, 1),
    event("cuda_runtime", "cudaLaunchKernel", 150, 5, 2),
    event("cuda_runtime", "cudaLaunchKernel", 450, 5, 3),
    event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 20, 80, 1),
    event("kernel", "max_pool3d_with_indices_single_out_frame", 160, 240, 2),
    event("kernel", "tube_roi_align_kernel", 600, 100, 3),
]


def test_the_trace_gives_busy_and_idle_shares_and_attributes_work_to_spans():
    t = tracing.Trace(TRACE, {"units": 2, "clips": 2})
    assert t.window_s == pytest.approx(1e-3) and t.busy_s == pytest.approx(420e-6)
    m = measure({"units": 4, "clips": 2, "window_s": 1e-3}, t, t,
                workload={"traffic": {"entry": "serve"}},
                config={"work": {"pool3d_bytes": 3.35e6, "roi_align_bytes": 0.67e6,
                                 "roi_align_ops": 0, "flops_serve": 989e6,
                                 "flops_train": 0}})
    assert load_metric("idle_pct.offline").read(m) == pytest.approx(58.0)
    assert load_metric("upload_ms.offline").read(m) == pytest.approx(0.04)
    assert load_metric("backbone_ms.offline").read(m) == pytest.approx(0.12)
    assert load_metric("refine_ms.offline").read(m) == pytest.approx(0.05)
    assert load_metric("pool_roofline_pct.offline").read(m) == pytest.approx(100 * 2e-6 / 240e-6)
    assert load_metric("k2_roofline_pct.offline").read(m) == pytest.approx(100 * 0.4e-6 / 100e-6)
    assert load_metric("mfu.offline").read(m) == pytest.approx(100 * 2e-6 / 1e-3)
    assert load_metric("launches.live").read(m) == 1.0
    gaps = dict(t.idle_gaps())
    assert gaps == pytest.approx({"upload": 20e-6, "model.backbone": 60e-6,
                                  "model.refine": 500e-6})
    assert t.device_ops()[0][0].startswith("max_pool3d")


def test_the_device_timeline_is_bounded_by_its_markers():
    line = [event("kernel", "marker", 100, 2), event("kernel", "a", 150, 50),
            event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 300, 100),
            event("kernel", "marker", 500, 2)]
    t = tracing.Trace(line, {"units": 1, "clips": 1}, markers=True)
    assert t.window_s == pytest.approx(402e-6) and t.busy_s == pytest.approx(150e-6)
    assert [e["name"] for e in t.kernels()] == ["a"]
    m = measure({}, t)
    assert load_metric("idle_pct.live").read(m) == pytest.approx(100 * (1 - 150 / 402))
    assert load_metric("launches.live").read(m) == 1.0
    assert load_metric("upload_ms.offline").read(m) == pytest.approx(0.1)


def test_a_metric_with_nothing_to_read_returns_nothing():
    t = tracing.Trace([event("user_annotation", "window", 0, 10)], {"units": 1, "clips": 1})
    m = measure({"units": 1, "clips": 1}, t, t, config={"work": {}})
    for name in ("pool_roofline_pct.offline", "k2_roofline_pct.offline", "mfu.offline",
                 "idle_pct.offline", "upload_ms.offline", "launches.live"):
        assert load_metric(name).read(m) is None


def test_the_guard_compares_top_level_names_whole(monkeypatch):
    from benchmark import run

    monkeypatch.setitem(sys.modules, "step_tpu_torch_like", types.ModuleType("x"))
    assert "step_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "step_tpu.ops", types.ModuleType("y"))
    assert run.forbidden_modules() == ["step_tpu"]


def test_the_command_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "ucf_3step.live_b1", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_traced_run_on_the_cpu_reads_its_window():
    from benchmark.cell import run_cell

    workload, config = tiny_cell("ucf_3step.offline_b32")
    out = run_cell(workload, config, ["idle_pct.offline"], 3, 0.2, True,
                   torch.device("cpu"), time.perf_counter())
    assert out["window_s"] > 0 and out["busy_s"] == 0 and out["metrics"] == {}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    t = workload["traffic"]
    assert out["attempted"] > t["timeline_units"] + t["trace_units"]
    assert set(out["notes"]["seconds_a_unit"]) == {"timed", "timeline", "traced"}


def test_weights_have_the_detectors_names_and_scales():
    cfg = ref.config(tiny_cell("ucf_3step.offline_b32")[1]["config"])
    w = work.make_weights(cfg, 9, "cpu")
    assert set(w) == set(ref.parameter_shapes(cfg))
    conv = w["features.stem_rgb.Conv3d_1a_7x7.conv.weight"]
    assert float(conv.std()) == pytest.approx((2 / conv[0].numel()) ** 0.5, rel=0.1)
    assert torch.equal(conv, work.make_weights(cfg, 9, "cpu")["features.stem_rgb.Conv3d_1a_7x7"
                                                               ".conv.weight"])
    assert float(w["steps.0.tail.Mixed_5c.b0.bn.running_var"].min()) >= 0.8


def test_the_timed_window_keeps_the_collector_quiet_and_counts_the_host():
    import gc

    from benchmark.cell import quiet_window

    notes = {}
    with quiet_window(notes):
        assert not gc.isenabled()
    assert gc.isenabled() and not gc.get_freeze_count()
    assert notes["host"]["wall_s"] >= 0 and notes["host"]["thread_cpu_s"] >= 0
