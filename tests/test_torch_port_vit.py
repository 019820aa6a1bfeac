"""VideoMAE ViT-B/16 as STEP's backbone (`models/vit.py`), on the CPU.

The port is held against the benchmark's plain reference
(`benchmark/reference/detector.py` over `backbones/videomae_vit_b16.py`,
which imports neither the port nor JAX) on the benchmark's own seeded
weights (`benchmark/work.make_weights`), at `backbone_depth="tiny"` (every
kind of layer, width 64, 2 blocks of 4 heads) and 32 px:

  * in float32: the feature map, the per-step logits and tubes, and a
    `detect_clip`'s tubes, scores and NMS survivors;
  * served as the benchmark serves it (`optimize_for_inference`, the tree
    in bfloat16) against the reference rounded to bfloat16, and
    `optimize_for_inference` hands the ViT's weights through untouched;
  * the harness's whole check of a serving run, and one `train_step`'s
    loss and positives against the reference's, on the same dropout masks,
    on the tiny configuration in float32.

At full depth, on the meta device: the state_dict's names and shapes are
the reference's `parameter_shapes`, and the published widths hold. The
refusals (an unknown backbone, chunk stems, two streams, another stride
at full depth, a clip the position table was not made for), T' of each
backbone (`feature_frames`), and the position table against VideoMAE's
numpy formula.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import json
import os
import time

import numpy as np
import pytest
import torch

from benchmark import work
from benchmark.cell import run_cell
from benchmark.program import step_config
from benchmark.reference import detector as ref
from benchmark.reference import training as ref_train
from step_tpu_torch import PRESETS
from step_tpu_torch.inference import detect_clip
from step_tpu_torch.models import vit
from step_tpu_torch.models.detector import STEPDetector, feature_frames
from step_tpu_torch.models.optimize import optimize_for_inference
from step_tpu_torch.train.trainer import create_train_state, train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "ava_videomae_b16.offline_b32"
TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32, compute_dtype="float32")
B = 2


def _load(*parts):
    with open(os.path.join(ROOT, "benchmark", *parts)) as f:
        return json.load(f)


CONFIG = _load("configs", "ava_videomae_b16.json")


def _fields(**over):
    return {**CONFIG["config"], **TINY, **over}


@pytest.fixture(scope="module")
def setup():
    """(reference config, weights, the port's float32 detector, clips,
    proposals, mask)."""
    fields = _fields()
    rc = ref.config(fields)
    weights = work.make_weights(rc, 7, "cpu")
    model = STEPDetector(step_config(fields)).eval()
    model.load_state_dict(weights)
    g = torch.Generator().manual_seed(11)
    rgb = torch.randint(0, 256, (B, rc.total_frames, 32, 32, 3), dtype=torch.uint8, generator=g)
    props, mask = STEPDetector.initial_proposals(model.cfg, B, device="cpu")
    return rc, weights, model, rgb, props, mask


def test_the_feature_map_matches_the_reference_in_float32(setup):
    rc, weights, model, rgb, _, _ = setup
    with torch.no_grad():
        got = model.stem(rgb)
        want = rc.net.forward(weights, rc, ref.preprocess(rgb, ref.FLOAT32), ref.Run())
    assert got.shape == want.shape == (B, 9, 4, 4, 64)
    # float32 sums in other orders (the tubelet GEMM against the strided
    # conv, the fused softmax-attention against two matmuls): map values
    # of a few units agree to a few 1e-6
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_logits_and_tubes_of_every_step_match_the_reference(setup):
    rc, weights, model, rgb, props, _ = setup
    with torch.no_grad():
        got = model(rgb, props)
        want = ref.forward(weights, rc, rgb, props)
    # logits of order one after the heads' I3D tails: the map's 1e-6 grows
    # to ~1e-5; tubes in pixels of a 32 px frame
    torch.testing.assert_close(got["cls_logits"], want["cls_logits"], rtol=0, atol=1e-4)
    torch.testing.assert_close(got["tubes"], want["tubes"], rtol=0, atol=1e-3)
    torch.testing.assert_close(got["frame_mask"], want["frame_mask"], rtol=0, atol=0)


def test_a_detection_and_its_nms_survivors_match_the_reference(setup):
    rc, weights, model, rgb, props, mask = setup
    got = detect_clip(model, rgb, props, mask)
    want = ref.detect(weights, rc, rgb, props, mask)
    torch.testing.assert_close(got["tubes"], want["tubes"], rtol=0, atol=1e-3)
    # sigmoid scores: the logits' 1e-5 shrinks
    torch.testing.assert_close(got["tube_scores"], want["tube_scores"], rtol=0, atol=1e-5)
    # the same survivors; the reference's NMS on the port's own tubes and
    # scores gives the port's surface bit for bit
    assert torch.equal(got["frame_mask"], want["frame_mask"])
    assert got["frame_mask"].sum() > 0
    surface = ref.nms_surface(got["tubes"], got["tube_scores"], mask, rc)
    for key in ("frame_boxes", "frame_scores", "frame_mask"):
        assert torch.equal(got[key], surface[key]), key


def test_the_served_form_in_bfloat16_matches_the_reference_rounded_to_bfloat16(setup):
    rc, weights, _, rgb, props, mask = setup
    cfg = step_config(_fields(compute_dtype="bfloat16"))
    cfg_run, state = optimize_for_inference(cfg, weights)
    for name, w in weights.items():
        if name.startswith("features."):
            assert torch.equal(state[name], w), name
    model = STEPDetector(cfg_run)
    model.load_state_dict(state)
    model = model.to(torch.bfloat16).eval()
    got = detect_clip(model, rgb, props, mask)
    rc16 = ref.config(_fields(compute_dtype="bfloat16"))
    want = ref.detect(weights, rc16, rgb, props, mask, ref.Precision("bfloat16"))
    real = mask[..., None].expand_as(want["tube_scores"]) > 0
    logp = (torch.log(got["tube_scores"].float()) - torch.log(want["tube_scores"]))[real]
    # both sides round to bfloat16 at the same places and part by the
    # summation orders and the attention's rounding inside its call: the
    # readings here are 0.0027 and 0.0007 of the side, the limits ~15x that
    assert float(logp.abs().max()) < 0.05
    assert float((got["tubes"].float() - want["tubes"]).abs().max()) / 32 < 0.01
    surface = ref.nms_surface(got["tubes"].float(), got["tube_scores"].float(), mask, rc16)
    assert torch.equal(got["frame_mask"], surface["frame_mask"])


def test_the_harness_judges_a_serving_run_correct():
    """The benchmark's whole serving run on the tiny configuration in
    float32: the program's answers against the reference's (`check.py`)."""
    workload = _load("workloads", f"{CELL}.json")
    workload["traffic"].update(batch=2, pool_batches=2, warmup=1, check_requests=2,
                               timeline_units=2, trace_units=2)
    config = dict(CONFIG, config=_fields())
    config["work"] = work.work_per_clip(ref.config(config["config"]))
    out = run_cell(workload, config, [], 2 ** 31 + 19, 0.2, False, torch.device("cpu"),
                   time.perf_counter())
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    for name, c in out["checks"].items():
        assert c["value"] <= (0 if name == "nms_mismatch" else 1e-4), (name, c["value"])


def test_a_train_step_loss_matches_the_reference(setup):
    """One `train_step` (train-mode BatchNorm in the heads, the config's
    dropout 0.3, masks drawn in the program's order at T' = 9) against the
    reference's forward and loss (`benchmark/reference/training.py`) on the
    same masks."""
    rc, weights, _, rgb, props, mask = setup
    cfg = step_config(_fields())
    model = STEPDetector(cfg)
    model.load_state_dict(weights)
    state = create_train_state(cfg, 0, model=model, device="cpu")
    state.generator = torch.Generator().manual_seed(5)
    G, T = cfg.max_gt_tubes, cfg.total_frames
    g = torch.Generator().manual_seed(6)
    corner = torch.rand((B, G, 1, 2), generator=g) * 16
    gt_tubes = torch.cat([corner, corner + 8 + torch.rand((B, G, 1, 2), generator=g) * 8],
                         dim=-1).expand(B, G, T, 4).contiguous()
    gt_mask = (torch.arange(G) < 2).float().expand(B, G).contiguous()
    gt_labels = (torch.rand((B, G, cfg.num_classes), generator=g) < 0.1).float()
    gt_labels = gt_labels * gt_mask[..., None]
    batch = dict(rgb=rgb, proposals=props, prop_mask=mask, gt_tubes=gt_tubes,
                 gt_mask=gt_mask, gt_labels=gt_labels)
    _, metrics = train_step(state, batch, cfg)

    masks = ref.dropout_masks(rc, B, torch.Generator().manual_seed(5), "cpu",
                              feature_frames(cfg))
    P = {n: t.clone() for n, t in weights.items()}
    out = ref.forward(P, rc, rgb, props, ref.Run(train=True), masks)
    loss, positives = ref_train.loss(out, batch, rc)
    assert float(positives[0]) > 0
    assert [float(x) for x in metrics["num_positive_per_step"]] == [float(x) for x in positives]
    # float32 through the ViT, train-mode BatchNorm and the loss's sums
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-5)


def test_at_full_depth_the_names_shapes_and_widths_are_published():
    fields = CONFIG["config"]
    with torch.device("meta"):
        model = STEPDetector(step_config(fields))
    want = {n: tuple(s) for n, (s, _) in ref.parameter_shapes(ref.config(fields)).items()}
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == want
    net = model.features
    assert isinstance(net, vit.VideoMAEViT) and net.out_channels == 768
    assert len(net.blocks) == 12 and {b.attn.heads for b in net.blocks} == {12}
    assert {b.mlp.fc1.out_features for b in net.blocks} == {3072}
    assert net.patch_embed.proj.kernel_size == net.patch_embed.proj.stride == (2, 16, 16)
    assert tuple(net.pos_embed.shape) == (9 * 14 * 14, 768)
    assert [b.attn.qkv.bias for b in net.blocks] == [None] * 12
    assert model.steps[0].tail.Mixed_5b.b0.conv.weight.shape[1] == 768


@pytest.mark.parametrize("over,match", [
    (dict(backbone="no_such_net"), "unknown backbone 'no_such_net'"),
    (dict(backbone=vit.NAME, chunk_stem=True), "chunk_stem is refused"),
    (dict(backbone=vit.NAME, two_stream=True), "two_stream is refused"),
    (dict(backbone=vit.NAME, feature_stride=8), "feature_stride=8"),
])
def test_what_the_detector_refuses(over, match):
    with torch.device("meta"), pytest.raises(ValueError, match=match):
        STEPDetector(PRESETS["ava_3step"].replace(**over))


def test_a_clip_the_position_table_was_not_made_for_is_refused(setup):
    _, _, model, rgb, _, _ = setup
    with pytest.raises(ValueError, match="position table was made for 144"):
        model.stem(rgb[:, :12])


@pytest.mark.parametrize("backbone,frames", [(vit.NAME, 9), ("i3d", 5)])
def test_feature_frames_follow_the_backbone(backbone, frames):
    assert feature_frames(PRESETS["ava_3step"].replace(backbone=backbone)) == frames


def test_the_position_table_is_videomaes():
    n, d = 1764, 768
    pos, j = np.arange(n)[:, None], np.arange(d)[None]
    table = pos / np.power(10000, 2 * (j // 2) / d)
    table[:, 0::2], table[:, 1::2] = np.sin(table[:, 0::2]), np.cos(table[:, 1::2])
    np.testing.assert_array_equal(vit.sinusoid_table(n, d).numpy(),
                                  torch.FloatTensor(table).numpy())
