"""The plain reference: what it imports, and that it agrees with the port's
plain path on the CPU at a tiny size, served (main path, BN folded) and
trained (three steps)."""

import ast
import os
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT, tiny_cell

HERE = os.path.join(ROOT, "benchmark")
JAX = {"jax", "jaxlib", "flax", "step_tpu"}


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(*parts):
    top = os.path.join(HERE, *parts)
    return [os.path.join(d, f) for d, _, fs in os.walk(top) for f in fs if f.endswith(".py")]


def test_nothing_in_the_benchmark_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported(path) & JAX, path


def test_only_the_program_adapter_imports_the_program():
    for path in sources():
        if os.path.basename(path) != "program.py":
            assert "step_tpu_torch" not in imported(path) or "tests" in path, path
    for path in sources("reference"):
        assert imported(path) <= {"__future__", "importlib", "math", "types", "numpy", "torch",
                                  "benchmark"}


def test_the_reference_loads_nothing_of_the_program_or_jax():
    """Every configuration's backbone loaded too (`detector.config`)."""
    code = ("import json, sys; import benchmark.reference.detector as d, "
            "benchmark.reference.training, benchmark.work, benchmark.check, benchmark.traffic; "
            "[d.config(json.load(open(c['file']))['config']) "
            "for c in json.load(open('BENCHMARK.json'))['configs']]; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & (JAX | {"step_tpu_torch"})


@pytest.mark.parametrize("cell,other", [("ucf_3step.offline_b32", None),
                                        ("ava_3step.offline_b32", None),
                                        ("ucf_3step.train_b8", None),
                                        ("ucf_3step.train_b8", "ava_3step")])
def test_the_reference_agrees_with_the_port_in_float32(cell, other):
    """`other` trains another configuration (multilabel AVA) on the cell's
    traffic, as a cell added by data alone would."""
    from benchmark.cell import run_cell

    workload, config = tiny_cell(cell)
    if other:
        config = tiny_cell(f"{other}.offline_b32")[1]
    out = run_cell(workload, config, [], 2 ** 31 + 7, 0.3, False, torch.device("cpu"),
                   time.perf_counter())
    readings = {k: c["value"] for k, c in out["checks"].items()}
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    for name, value in readings.items():
        assert value <= (0 if name == "nms_mismatch" else 1e-4), (name, value)
