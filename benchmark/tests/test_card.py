"""One short run of every cell on the card through the benchmark's command (skipped
without a card): the result's fields, `correct`, and its checks last."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT, load


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in load("BENCHMARK.json")["workloads"]])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_short_run_of_the_cell_is_correct(card, cell, trace):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
                          str(2 ** 31 + 17 + trace), "--seconds", "2", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200,
                         env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(result)[-1] == "checks" and result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["count"] == 1
    assert result["metrics"]
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
