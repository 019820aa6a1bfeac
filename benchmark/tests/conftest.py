"""Shared pieces of the benchmark's tests: the repository on the import
path, few torch threads, and tiny versions of the cells for the CPU."""

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
torch.set_num_threads(2)

TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32)
FULL = dict(image_size=32)
TINY_TRAFFIC = {"serve": dict(batch=2, pool_batches=2, warmup=1, check_requests=2,
                              timeline_units=2, trace_units=2),
                "train": dict(batch=2, pool_clips=8, warmup=0, timeline_units=1,
                              trace_units=1)}


def load(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


@pytest.fixture(scope="session")
def bench():
    return load("BENCHMARK.json")


def tiny_cell(cell: str, compute_dtype: str = "float32", depth: str = "tiny"):
    """(workload, configuration) of `cell` cut to a small detector (the
    tiny backbone at 32 px, or the full one at 32 px) and a few clips, its
    limits kept."""
    from benchmark import work
    from benchmark.reference import detector as ref

    workload = load("benchmark", "workloads", f"{cell}.json")
    workload["traffic"].update(TINY_TRAFFIC[workload["traffic"]["entry"]])
    config = load("benchmark", "configs", f"{workload['config']}.json")
    config["config"].update(TINY if depth == "tiny" else FULL, compute_dtype=compute_dtype)
    config["work"] = work.work_per_clip(ref.config(config["config"]))
    return workload, config
