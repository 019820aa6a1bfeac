"""The check's control and planted faults, driven through a whole run at a
tiny size on the CPU (the look for a card skipped): each must come out not
correct under the cell's own limits, where the program comes out correct.
The readings at the cells' own sizes, on the card, are `PERF.md`'s.

Training's control runs the full backbone (at 32 px): float8's error in the
gradients grows with depth, and two Inception blocks leave it under the
limit set at the published depth."""

import time

import pytest
import torch

from conftest import tiny_cell
from benchmark import controls
from benchmark.cell import run_cell

SERVE = ("control", "unchanged", "half", "altered")
TRAIN = ("control", "unchanged", "half")
CASES = ([(c, v) for c in ("ucf_3step.offline_b32", "ava_3step.offline_b32")
          for v in ("program",) + SERVE]
         + [("ucf_3step.live_b1", v) for v in ("program", "control", "unchanged", "altered")]
         + [("ucf_3step.train_b8", v) for v in ("program",) + TRAIN])


@pytest.mark.parametrize("cell,variant", CASES)
def test_only_the_program_comes_out_correct(cell, variant):
    full = cell.endswith("train_b8") and variant in ("program", "control")
    workload, config = tiny_cell(cell, depth="full" if full else "tiny")
    fields = dict(config["config"], compute_dtype="bfloat16")
    make = controls.factory(workload["traffic"]["entry"], variant, fields)
    out = run_cell(workload, config, [], 2 ** 31 + 101, 0.2, False,
                   torch.device("cpu"), time.perf_counter(), program=make)
    readings = {k: c["value"] for k, c in out["checks"].items()}
    assert out["correct"] == (variant == "program"), readings
