"""The benchmark as data: BENCHMARK.json, the workload, configuration and
metric files it names, and a harness with no branch for any of them."""

import ast
import dataclasses
import importlib.util
import os
import re

import pytest

from conftest import ROOT, load

HERE = os.path.join(ROOT, "benchmark")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def metric_module(name):
    from benchmark.cell import metric_path

    spec = importlib.util.spec_from_file_location("m", metric_path(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"][1] == "benchmark/run.py"
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["configs"]) <= 24 and 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_sources(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[group]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((group in ("end_to_end", "per_layer"), entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
                assert entry["source"] in SOURCES
    assert len(names) == len(set(names))
    for w in bench["workloads"]:
        assert NAME.match(w["traffic"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in load("BENCHMARK.json")["workloads"]])
def test_workload_file_found_by_name(bench, cell):
    entry = next(w for w in bench["workloads"] if w["name"] == cell)
    w = load("benchmark", "workloads", f"{cell}.json")
    assert w["name"] == cell and w["config"] == entry["config"] and w["why"] == entry["why"]
    assert w["chips"] == entry["chips"]
    assert os.path.exists(os.path.join(HERE, "configs", f"{w['config']}.json"))
    reported = {m["name"] for m in bench["end_to_end"]
                if cell in m.get("workloads", [cell])}
    assert set(w["end_to_end"]) == reported and "setup_s" in reported
    assert len(reported) >= 2
    serve = {"logp_gap", "tube_gap", "nms_mismatch"}
    train = {"loss_gap", "positives_gap", "grad_gap_median", "change_gap"}
    assert set(w["limits"]) == (serve if w["traffic"]["entry"] == "serve" else train)
    assert any(cell in m.get("workloads", [cell]) for m in bench["per_layer"])


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metric_files_declare_what_benchmark_json_says(bench, group):
    for m in bench[group]:
        module = metric_module(m["name"])
        assert (module.UNIT, module.BETTER, module.SOURCE) == (m["unit"], m["better"],
                                                               m["source"])
        assert callable(module.read)
        if group == "per_layer":
            assert module.LAYER == m["layer"]
            assert getattr(module, "MOVES", m["moves"]) == m["moves"]


def test_per_layer_metrics_sit_in_cells_that_report_what_they_move(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["workloads"] and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200


@pytest.mark.parametrize("name", [c["name"] for c in load("BENCHMARK.json")["configs"]])
def test_configuration_is_the_preset_and_its_work_is_counted_over_the_reference(bench, name):
    from step_tpu_torch import PRESETS

    from benchmark import work
    from benchmark.reference import detector as ref

    c = load("benchmark", "configs", f"{name}.json")
    entry = next(x for x in bench["configs"] if x["name"] == name)
    assert entry["file"] == f"benchmark/configs/{name}.json" and entry["source"] == c["source"]
    assert entry["reduced"] == sorted(set(c["changed"]) | set(c["published"]))
    assert all(c["config"][k] != v for k, v in c["published"].items())
    preset = dataclasses.asdict(PRESETS[c["preset"]])
    preset.update(c["changed"])
    assert c["config"] == {k: list(v) if isinstance(v, tuple) else v for k, v in preset.items()}
    assert c["work"] == work.work_per_clip(ref.config(c["config"]))


def literals_of(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def test_the_harness_holds_no_branch_for_a_cell_a_configuration_or_a_metric(bench):
    words = {w["name"] for w in bench["workloads"]} | {w["traffic"] for w in bench["workloads"]}
    words |= {c["name"] for c in bench["configs"]}
    words |= {m["name"] for m in bench["end_to_end"] + bench["per_layer"]}
    for fname in os.listdir(HERE):
        if fname.endswith(".py"):
            literals = literals_of(os.path.join(HERE, fname))
            assert not literals & words, (fname, literals & words)


def test_the_detector_names_no_backbone(bench):
    """The shared detector finds its backbone by `cfg.backbone` alone."""
    names = {f[:-3] for f in os.listdir(os.path.join(HERE, "reference", "backbones"))
             if f.endswith(".py")}
    names |= {load(*c["file"].split("/"))["config"]["backbone"] for c in bench["configs"]}
    assert names and not literals_of(os.path.join(HERE, "reference", "detector.py")) & names
