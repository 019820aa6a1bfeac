"""The reference's seam between a backbone and the shared detector: a
backbone is the file `cfg.backbone` names, a name with no file is refused,
and a stand-in backbone kept with the tests (`backbones/`) runs through the
detector, the weights' draw, the count of a clip's work and a whole run of
the harness with nothing of the harness edited. The configurations'
weights stay as they were drawn before the seam."""

import hashlib
import os
import pathlib
import re
import time
import types

import pytest
import torch

from conftest import ROOT, load, tiny_cell
from benchmark import controls, work
from benchmark.cell import run_cell
from benchmark.reference import detector as ref

STAND_IN = pathlib.Path(ROOT, "benchmark", "tests", "backbones")
# sha256 over each weight's name and float32 bytes, in order, drawn at seed 0
# on the CPU by the harness as it stood before backbones were files
DIGESTS = {"ucf_3step": "b8f8f7ed3abb6c0b72db8f3d45fa0ae96315cd2106979c53f2e4e23d124aaeee",
           "ava_3step": "f7de6cb4e51ac700e73291574ae1eeea1f12f404357498aae254db9882c142e0"}


def stand_in_cell(monkeypatch):
    """(workload, configuration) of a tiny serving cell whose backbone is
    the stand-in, at stride 16, its work counted over the reference."""
    workload, config = tiny_cell("ucf_3step.offline_b32")
    monkeypatch.setattr(ref, "BACKBONES", STAND_IN)
    config["config"].update(backbone="pooled_projection", feature_stride=16)
    config["work"] = work.work_per_clip(ref.config(config["config"]))
    return workload, config


def test_a_backbone_with_no_file_is_refused_naming_the_path():
    fields = dict(tiny_cell("ucf_3step.offline_b32")[1]["config"], backbone="no_such_net")
    path = os.path.join(ROOT, "benchmark", "reference", "backbones", "no_such_net.py")
    with pytest.raises(ValueError, match=re.escape(path)):
        ref.config(fields)


def test_a_stand_in_backbone_runs_through_the_detector_and_a_whole_run(monkeypatch):
    workload, config = stand_in_cell(monkeypatch)
    cfg = ref.config(config["config"])
    assert cfg.net.__file__ == str(STAND_IN / "pooled_projection.py")
    weights = work.make_weights(cfg, 5, "cpu")
    props, mask = ref.initial_cuboids(cfg, "cpu")
    rgb = torch.randint(0, 256, (2, cfg.total_frames, 32, 32, 3), dtype=torch.uint8)
    out = ref.detect(weights, cfg, rgb, props[None].expand(2, -1, -1, -1),
                     mask[None].expand(2, -1))
    assert out["tube_scores"].shape == (2, cfg.max_proposals, cfg.num_classes)
    assert torch.isfinite(out["tubes"]).all()

    make = controls.factory("serve", "witness", config["config"])
    result = run_cell(workload, config, [], 2 ** 31 + 29, 0.2, False, torch.device("cpu"),
                      time.perf_counter(), program=make)
    assert result["correct"] and result["attempted"] >= 1 and result["failed"] == 0
    assert all(c["value"] <= 1e-5 for c in result["checks"].values()), result["checks"]


def test_the_work_of_a_clip_counts_a_kernel_kind_only_the_stand_in_records(monkeypatch):
    i3d = tiny_cell("ucf_3step.offline_b32")[1]["work"]
    w = stand_in_cell(monkeypatch)[1]["work"]
    clip, pooled = 18 * 32 * 32 * 3, 9 * 2 * 2 * 3
    assert w["avg_pool3d_bytes"] == (clip + pooled) * 4 and "avg_pool3d_bytes" not in i3d
    assert set(i3d) < set(w) and w["pool3d_bytes"] > 0 and w["roi_align_ops"] > 0


def test_weights_of_a_backbones_kinds_are_drawn_and_an_unknown_kind_refused(monkeypatch):
    cfg = ref.config(stand_in_cell(monkeypatch)[1]["config"])
    w = work.make_weights(cfg, 11, "cpu")
    scale, shift = w["features.norm.weight"], w["features.norm.bias"]
    assert 0.9 <= float(scale.min()) <= float(scale.max()) <= 1.1
    assert float(shift.abs().max()) <= 0.1
    assert float(w["features.proj.weight"].std()) == pytest.approx(3 ** -0.5, rel=0.1)
    assert not w["features.proj.bias"].any()
    cfg.net = types.SimpleNamespace(parameter_shapes=lambda c: {"features.rope": ((4,), "rope")},
                                    out_channels=cfg.net.out_channels)
    with pytest.raises(ValueError, match="rope"):
        work.make_weights(cfg, 11, "cpu")
    cfg.net.parameter_shapes = lambda c: {"stem.proj.weight": ((4, 3), "linear")}
    with pytest.raises(ValueError, match="stem.proj.weight"):
        ref.parameter_shapes(cfg)


@pytest.mark.parametrize("name", sorted(DIGESTS))
def test_the_configurations_weights_are_drawn_as_before(name):
    c = load("benchmark", "configs", f"{name}.json")
    h = hashlib.sha256()
    for n, t in work.make_weights(ref.config(c["config"]), 0, "cpu").items():
        h.update(n.encode())
        h.update(t.numpy().tobytes())
    assert h.hexdigest() == DIGESTS[name]
