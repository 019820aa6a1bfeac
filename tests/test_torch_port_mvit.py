"""MViTv2-B as STEP's backbone (`models/mvit.py`), on the CPU.

The port is held against the benchmark's plain reference
(`benchmark/reference/detector.py` over `backbones/mvitv2_b.py`, which
imports neither the port nor JAX) on the benchmark's own seeded weights
(`benchmark/work.make_weights`), at `backbone_depth="tiny"` (widths
16/32/64 at d 16 in stages of 1, 2 and 2 blocks: both transitions, K/V
strides 4, 2 and 1, queries larger and smaller than their keys) and 32 px:

  * in float32: the feature map, the per-step logits and tubes, and a
    `detect_clip`'s tubes, scores and NMS survivors;
  * served as the benchmark serves it (`optimize_for_inference`, the tree
    in bfloat16) against the reference rounded to bfloat16, and
    `optimize_for_inference` hands the MViT's weights through untouched;
  * the harness's whole check of a serving run on the tiny configuration
    in float32.

On their own: Rel(q) against a loop over every (query, key) pair whose
table rows come from the two grids' strides, at query/key size ratios of
2, 4 and 1/2; at the same ratios in float64, the packed query's and keys'
logits against the logits plus Rel(q), with zeros in the channels past the
terms; each tiny block's packed attention against the masked attention on
Rel(q) in float32, and a detection's count of packed calls; the skip pool against `F.max_pool3d` with padding 1, which
the port's TF-SAME pool (`ops/pool.py::max_pool3d_same`) does not
compute. At full depth, on the meta device: the state_dict's names and
shapes are the reference's `parameter_shapes`, the published widths, heads
and table lengths hold, the packed widths are 128 and 160 at the
transitions, and the map is `[B, 9, 14, 14, 384]`. The
refusals (chunk stems, two streams, another stride at full depth, a clip
the tables were not made for) and T' (`feature_frames`).
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import json
import math
import os
import time

import pytest
import torch
import torch.nn.functional as F

from benchmark import work
from benchmark.cell import run_cell
from benchmark.program import step_config
from benchmark.reference import detector as ref
from step_tpu_torch import PRESETS
from step_tpu_torch.inference import detect_clip
from step_tpu_torch.models import mvit
from step_tpu_torch.models.detector import STEPDetector, feature_frames
from step_tpu_torch.models.optimize import optimize_for_inference
from step_tpu_torch.ops.kernel_op import LAUNCHES
from step_tpu_torch.ops.pool import max_pool3d_same

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "ava_mvitv2_b.offline_b32"
TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32, compute_dtype="float32")
B = 2


def _load(*parts):
    with open(os.path.join(ROOT, "benchmark", *parts)) as f:
        return json.load(f)


CONFIG = _load("configs", "ava_mvitv2_b.json")


def _fields(**over):
    return {**CONFIG["config"], **TINY, **over}


@pytest.fixture(scope="module")
def setup():
    """(reference config, weights, the port's float32 detector, clips,
    proposals, mask)."""
    fields = _fields()
    rc = ref.config(fields)
    weights = work.make_weights(rc, 17, "cpu")
    model = STEPDetector(step_config(fields)).eval()
    model.load_state_dict(weights)
    g = torch.Generator().manual_seed(21)
    rgb = torch.randint(0, 256, (B, rc.total_frames, 32, 32, 3), dtype=torch.uint8, generator=g)
    props, mask = STEPDetector.initial_proposals(model.cfg, B, device="cpu")
    return rc, weights, model, rgb, props, mask


def test_the_feature_map_matches_the_reference_in_float32(setup):
    rc, weights, model, rgb, _, _ = setup
    with torch.no_grad():
        got = model.stem(rgb)
        want = rc.net.forward(weights, rc, ref.preprocess(rgb, ref.FLOAT32), ref.Run())
    assert got.shape == want.shape == (B, 9, 4, 4, 64)
    # float32 sums in other orders (the fused attention against two matmuls
    # and a softmax, Rel(q) summed inside the packed logits): map values of
    # a few units agree to a few 1e-6
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_logits_and_tubes_of_every_step_match_the_reference(setup):
    rc, weights, model, rgb, props, _ = setup
    with torch.no_grad():
        got = model(rgb, props)
        want = ref.forward(weights, rc, rgb, props)
    # logits of order one after the heads' I3D tails at C = 64: the map's
    # 1e-6 grows to ~1e-5; tubes in pixels of a 32 px frame
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
    # summation orders, the √d-scaled terms rounded to bfloat16 in the
    # packed query and the call's rounding inside it: the readings are
    # 0.0064 and 0.0013 of the side (0.0064 and 0.0017 with the bias summed
    # in bfloat16), the limits ~8x and ~7.5x that; the reference in float8
    # reads 0.083 and 0.032
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
    out = run_cell(workload, config, [], 2 ** 31 + 23, 0.2, False, torch.device("cpu"),
                   time.perf_counter())
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    for name, c in out["checks"].items():
        assert c["value"] <= (0 if name == "nms_mismatch" else 1e-4), (name, c["value"])


def _rel_by_pairs(q, q_grid, k_grid, q_stride, k_stride, tables):
    """Rel(q) `[Nq, Nkv]` of one head's q `[Nq, d]`, pair by pair: a query
    cell i sits at i·q_stride of the input, a key cell at i'·k_stride; the
    row of a side's table is their offset in the finer of the two strides,
    shifted so that the farthest key to the right reads row 0."""
    rows = []
    for qt in range(q_grid[0]):
        for qi in range(q_grid[1]):
            for qj in range(q_grid[2]):
                n = (qt * q_grid[1] + qi) * q_grid[2] + qj
                row = []
                for kt in range(k_grid[0]):
                    for ki in range(k_grid[1]):
                        for kj in range(k_grid[2]):
                            value = 0.0
                            for axis, (a, b, table) in enumerate(
                                    zip((qt, qi, qj), (kt, ki, kj), tables)):
                                fine = min(q_stride[axis], k_stride[axis])
                                offset = a * q_stride[axis] - b * k_stride[axis]
                                shift = (k_grid[axis] - 1) * k_stride[axis]
                                index = (offset + shift) // fine
                                value += float(q[n] @ table[index])
                            row.append(value)
                rows.append(row)
    return torch.tensor(rows, dtype=torch.float64)


@pytest.mark.parametrize("q_side,k_side", [(8, 4), (8, 2), (4, 8)])
def test_the_relative_position_bias_matches_a_loop_over_pairs(q_side, k_side):
    """Queries 2 and 4 times as fine as the keys, and half as fine (a
    transition's pooled query against its finer keys)."""
    g = torch.Generator().manual_seed(31)
    d, q_grid, k_grid = 8, (3, q_side, q_side), (3, k_side, k_side)
    side = 2 * max(q_side, k_side) - 1
    tables = [torch.randn((rows, d), generator=g, dtype=torch.float64)
              for rows in (2 * 3 - 1, side, side)]
    q = torch.randn((1, 1, 3 * q_side * q_side, d), generator=g, dtype=torch.float64)
    index = [mvit.rel_index(a, b) for a, b in zip(q_grid, k_grid)]
    got = mvit.rel_pos_bias(q, q_grid, k_grid, tables, index)[0, 0]
    # the grids' strides over a common input: the coarser side's is the
    # ratio of the two sides
    q_stride = [max(b // a, 1) for a, b in zip(q_grid, k_grid)]
    k_stride = [max(a // b, 1) for a, b in zip(q_grid, k_grid)]
    want = _rel_by_pairs(q[0, 0], q_grid, k_grid, q_stride, k_stride, tables)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def _grids(q_side, k_side, d, dtype, seed):
    """q, k `[1, 2, N, d]` on (3, q_side, q_side) and (3, k_side, k_side),
    the three tables and their row maps."""
    g = torch.Generator().manual_seed(seed)
    q_grid, k_grid = (3, q_side, q_side), (3, k_side, k_side)
    side = 2 * max(q_side, k_side) - 1
    tables = [torch.randn((rows, d), generator=g, dtype=dtype) for rows in (5, side, side)]
    q = torch.randn((1, 2, 3 * q_side * q_side, d), generator=g, dtype=dtype)
    k = torch.randn((1, 2, 3 * k_side * k_side, d), generator=g, dtype=dtype)
    index = [mvit.rel_index(a, b) for a, b in zip(q_grid, k_grid)]
    return q, k, q_grid, k_grid, tables, index


@pytest.mark.parametrize("q_side,k_side", [(8, 4), (8, 2), (4, 8)])
def test_the_packed_logits_are_the_logits_plus_the_bias(q_side, k_side):
    """q′·k′ᵀ/√d = q·kᵀ/√d + Rel(q) in float64: the query's √d-scaled terms
    meet the keys' one-hots of their three coordinates."""
    d = 8
    q, k, q_grid, k_grid, tables, index = _grids(q_side, k_side, d, torch.float64, 33)
    extra = mvit.packed_width(d, k_grid) - d
    rows = mvit.term_rows(index, [len(t) for t in tables], k_grid, extra)
    qp, kp = mvit.pack(q, k, q_grid, tables, rows, mvit.key_onehots(k_grid, extra).double())
    assert qp.shape[-1] == kp.shape[-1] == d + extra and extra % 32 == 0
    assert torch.equal(qp[..., :d], q) and torch.equal(kp[..., :d], k)
    got = qp @ kp.transpose(-1, -2) / d ** 0.5
    want = q @ k.transpose(-1, -2) / d ** 0.5 + mvit.rel_pos_bias(q, q_grid, k_grid, tables,
                                                                  index)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_the_packed_channels_past_the_terms_are_zero():
    """q′ holds kt + kh terms, zeros to a multiple of 8, kw terms, zeros;
    k′ a one-hot in each group and zeros elsewhere."""
    d, k_grid = 8, (3, 2, 2)
    q, k, q_grid, _, tables, index = _grids(4, 2, d, torch.float64, 35)
    extra = mvit.packed_width(d, k_grid) - d
    assert extra == 32
    rows = mvit.term_rows(index, [len(t) for t in tables], k_grid, extra)
    qp, kp = mvit.pack(q, k, q_grid, tables, rows, mvit.key_onehots(k_grid, extra).double())
    used = [*range(d, d + 5), *range(d + 8, d + 10)]
    unused = [c for c in range(d, d + extra) if c not in used]
    assert qp[..., used].abs().min() > 0 and not qp[..., unused].any()
    assert not kp[..., unused].any() and torch.equal(kp[..., used].sum(-1),
                                                      torch.full(kp.shape[:-1], 3.0,
                                                                 dtype=torch.float64))


def test_the_keys_one_hots_mark_their_coordinates():
    onehots = mvit.key_onehots((2, 3, 4), 32)
    assert onehots.shape == (24, 32) and torch.equal(onehots.sum(1), torch.full((24,), 3.0))
    # key (1, 2, 3) is the last: t' = 1, i' = 2 after the 2 t columns, j' = 3
    # after the t and h columns rounded up to 8
    assert onehots[-1].nonzero().flatten().tolist() == [1, 2 + 2, 8 + 3]
    assert not onehots[:, 12:].any()


@pytest.mark.parametrize("block", range(5))
def test_a_blocks_packed_attention_is_the_biased_attention(setup, block):
    """Every block of the tiny MViT (queries finer than, as fine as and
    coarser than their keys) in float32: the packed call against the bias
    form's masked attention, on the block's own tables made non-zero."""
    attn = setup[2].features.blocks[block].attn
    d = attn.pool_q.weight.shape[0]
    g = torch.Generator().manual_seed(51 + block)
    q, k, v = (torch.randn((B, attn.heads, math.prod(size), d), generator=g)
               for size in (attn.q_size, attn.kv_size, attn.kv_size))
    tables = [0.3 * torch.randn(t.shape, generator=g)
              for t in (attn.rel_pos_t, attn.rel_pos_h, attn.rel_pos_w)]
    got = mvit.packed_attention(q, k, v, attn.q_size, tables, (attn.rows_th, attn.rows_w),
                                attn.onehots)
    index = [mvit.rel_index(a, b) for a, b in zip(attn.q_size, attn.kv_size)]
    bias = mvit.rel_pos_bias(q, attn.q_size, attn.kv_size, tables, index)
    want = F.scaled_dot_product_attention(q, k, v, attn_mask=bias) + q
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_a_detection_takes_the_packed_attention_once_a_block(setup):
    _, _, model, rgb, props, mask = setup
    before = LAUNCHES["packed_attention"]
    detect_clip(model, rgb, props, mask)
    assert LAUNCHES["packed_attention"] - before == len(model.features.blocks) == 5


def test_the_skip_pool_pads_symmetrically_unlike_the_tf_same_pool():
    g = torch.Generator().manual_seed(41)
    B, size, C = 2, (3, 8, 8), 5
    x = torch.randn((B, 3 * 8 * 8, C), generator=g)
    got = mvit.skip_pool(x, size, (1, 2, 2))
    grid = x.reshape(B, *size, C).permute(0, 4, 1, 2, 3)
    want = F.max_pool3d(grid, (1, 3, 3), (1, 2, 2), (0, 1, 1))
    assert got.shape == (B, 3 * 4 * 4, C)
    assert torch.equal(got, want.permute(0, 2, 3, 4, 1).reshape(B, -1, C))
    # TF-SAME pads (0, 1) at stride 2 on an even side: its windows start a
    # pixel later, so the two pools differ
    same = max_pool3d_same(grid, (1, 3, 3), (1, 2, 2))
    assert same.shape == want.shape and not torch.equal(same, want)


def test_at_full_depth_the_names_shapes_and_widths_are_published():
    fields = CONFIG["config"]
    with torch.device("meta"):
        model = STEPDetector(step_config(fields))
    want = {n: tuple(s) for n, (s, _) in ref.parameter_shapes(ref.config(fields)).items()}
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == want
    net = model.features
    assert isinstance(net, mvit.MViTv2) and net.out_channels == 384 and len(net.blocks) == 21
    assert net.patch_embed.proj.kernel_size == (3, 7, 7)
    assert net.patch_embed.proj.stride == (2, 4, 4) and net.patch_embed.proj.padding == (1, 3, 3)
    attn = [b.attn for b in net.blocks]
    assert [a.heads for a in attn] == [1] * 2 + [2] * 3 + [4] * 16
    assert [b.norm2.normalized_shape[0] for b in net.blocks] == [96] * 2 + [192] * 3 + [384] * 16
    assert {a.pool_q.weight.shape[0] for a in attn} == {96}
    assert [a.rel_pos_h.shape[0] for a in attn] == [111] * 2 + [55] * 3 + [27] * 16
    assert {a.rel_pos_t.shape[0] for a in attn} == {17}
    assert [i for i, b in enumerate(net.blocks) if b.proj is not None] == [2, 5]
    assert [a.kv_size for a in attn] == ([(9, 7, 7)] * 2 + [(9, 14, 14)] + [(9, 7, 7)] * 2
                                         + [(9, 14, 14)] + [(9, 7, 7)] * 15)
    assert [a.q_size[1] for a in attn] == [56] * 2 + [28] * 3 + [14] * 16
    # the packed query's and keys' channels: 96 and the terms 9 + 7 (→ 16)
    # + 7 → 128, or 9 + 14 (→ 24) + 14 → 160 at the transitions
    widths = [a.width for a in attn]
    assert widths == [128] * 2 + [160] + [128] * 2 + [160] + [128] * 15
    assert all(w % 8 == 0 and w <= 256 for w in widths)
    assert [tuple(a.onehots.shape) for a in attn] == [
        (math.prod(a.kv_size), a.width - 96) for a in attn]
    assert {b.mlp.fc1.out_features // b.mlp.fc1.in_features for b in net.blocks} == {4}
    assert net(torch.empty((B, 18, 224, 224, 3), device="meta")).shape == (B, 9, 14, 14, 384)
    assert model.steps[0].tail.Mixed_5b.b0.conv.weight.shape[1] == 384


@pytest.mark.parametrize("over,match", [
    (dict(chunk_stem=True), "chunk_stem is refused"),
    (dict(two_stream=True), "two_stream is refused"),
    (dict(feature_stride=8), "feature_stride=8"),
])
def test_what_the_detector_refuses(over, match):
    with torch.device("meta"), pytest.raises(ValueError, match=match):
        STEPDetector(PRESETS["ava_3step"].replace(backbone=mvit.NAME, **over))


def test_a_clip_the_tables_were_not_made_for_is_refused(setup):
    _, _, model, rgb, _, _ = setup
    with pytest.raises(ValueError, match="made for 9x16x16"):
        model.stem(rgb[:, :12])


def test_feature_frames_of_mvit():
    assert feature_frames(PRESETS["ava_3step"].replace(backbone=mvit.NAME)) == 9
    assert [mvit.feature_frames(t) for t in (6, 16, 17, 18, 32)] == [3, 8, 9, 9, 16]
