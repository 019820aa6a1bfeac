"""Video Swin-B as STEP's backbone (`models/swin.py`), on the CPU.

The port is held against the benchmark's plain reference
(`benchmark/reference/detector.py` over `backbones/swin3d_b.py`, which
imports neither the port nor JAX and is written as the published code
computes: pad, roll, `window_partition`, `compute_mask`, the biased
logits, `window_reverse`) on the benchmark's own seeded weights
(`benchmark/work.make_weights`), at `backbone_depth="tiny"` (widths
16/32/64 at d 16, two blocks a stage, the published (8, 7, 7) window and
2,535-row table) on 18 frames at 32 px: T' 9 is padded to 16 in every
stage, stage 1's 16x16 grid to 21x21 and stage 2's 8x8 to 14x14, stage 3's
4x4 grid adapts the window to (8, 4, 4) and the shift to (4, 0, 0), so its
bias reads the table at `index[:128, :128]`, and the odd blocks of every
stage are shifted with a mask:

  * in float32: the feature map (also on 17 frames at 30 px, where the
    patch embedding and a patch merging pad), the per-step logits and
    tubes, and a `detect_clip`'s tubes, scores and NMS survivors;
  * served as the benchmark serves it (`optimize_for_inference`, the tree
    in bfloat16) against the reference rounded to bfloat16, and
    `optimize_for_inference` hands the Swin's weights through untouched;
  * the harness's whole check of a serving run on the tiny configuration
    in float32.

On their own: an independent oracle, a W-MSA and an SW-MSA block against
a dense form over every pair of tokens of the padded grid (a pair attends
iff its coordinates shifted cyclically, (p − s) mod P, fall in one
window; its bias is the table at the difference of those coordinates; −100
where their regions differ); the index maps against the reference's pad,
roll and partition of token numbers, the masks against its
`compute_mask`, the table rows against its `relative_position_index`;
patch merging's 2x2 order against a direct gather; the attention mask that
reaches `F.scaled_dot_product_attention` holds no factor of the batch. At
full depth, on the meta device: the state_dict's names and shapes are the
reference's `parameter_shapes`, the published widths, heads, windows and
tables hold, and the map is `[B, 9, 14, 14, 512]`. The refusals (chunk
stems, two streams, another stride at full depth, a clip the windows were
not made for) and T' (`feature_frames`).
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import copy
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
from step_tpu_torch.models import swin
from step_tpu_torch.models.detector import STEPDetector, feature_frames
from step_tpu_torch.models.optimize import optimize_for_inference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "ava_swin3d_b.offline_b32"
TINY = dict(backbone_depth="tiny", feature_stride=8, image_size=32, compute_dtype="float32")
B = 2


def _load(*parts):
    with open(os.path.join(ROOT, "benchmark", *parts)) as f:
        return json.load(f)


CONFIG = _load("configs", "ava_swin3d_b.json")
REF_NET = ref.load_backbone(swin.NAME)


def _fields(**over):
    return {**CONFIG["config"], **TINY, **over}


@pytest.fixture(scope="module")
def setup():
    """(reference config, weights, the port's float32 detector, clips,
    proposals, mask)."""
    fields = _fields()
    rc = ref.config(fields)
    weights = work.make_weights(rc, 19, "cpu")
    model = STEPDetector(step_config(fields)).eval()
    model.load_state_dict(weights)
    g = torch.Generator().manual_seed(23)
    rgb = torch.randint(0, 256, (B, rc.total_frames, 32, 32, 3), dtype=torch.uint8, generator=g)
    props, mask = STEPDetector.initial_proposals(model.cfg, B, device="cpu")
    return rc, weights, model, rgb, props, mask


def test_the_tiny_clip_pads_adapts_and_shifts_as_the_tests_need(setup):
    layers = setup[2].features.layers
    assert [l.size for l in layers] == [(9, 16, 16), (9, 8, 8), (9, 4, 4)]
    assert [l.window for l in layers] == [(8, 7, 7), (8, 7, 7), (8, 4, 4)]
    assert [l.shift for l in layers] == [(4, 3, 3), (4, 3, 3), (4, 0, 0)]
    assert [tuple(l.index.shape) for l in layers] == [(392, 392), (392, 392), (128, 128)]
    assert [tuple(l.labels_1.shape) for l in layers] == [(18, 392), (8, 392), (2, 128)]
    assert all(len(l.blocks) == 2 and l.labels_1.any() and not l.labels_0.any()
               for l in layers)


def test_the_feature_map_matches_the_reference_in_float32(setup):
    rc, weights, model, rgb, _, _ = setup
    with torch.no_grad():
        got = model.stem(rgb)
        want = rc.net.forward(weights, rc, ref.preprocess(rgb, ref.FLOAT32), ref.Run())
    assert got.shape == want.shape == (B, 9, 4, 4, 64)
    # float32 sums in other orders (the fused attention against two matmuls
    # and a softmax, the tubelet GEMM against the strided conv): map values
    # of a few units agree to a few 1e-6
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)


def test_an_odd_clip_pads_the_patches_and_the_merges_as_the_reference(setup):
    """17 frames at 30 px: the patch embedding pads a frame and two
    pixels, the 15x15 grid merges with a row and a column of zeros."""
    rc, weights, _, _, _, _ = setup
    net = swin.SwinTransformer3D("tiny", 8, 17, 30).eval()
    net.load_state_dict({k[len("features."):]: v for k, v in weights.items()
                         if k.startswith("features.")})
    assert [l.size for l in net.layers] == [(9, 15, 15), (9, 8, 8), (9, 4, 4)]
    x = torch.randn((B, 17, 30, 30, 3), generator=torch.Generator().manual_seed(29))
    with torch.no_grad():
        got, want = net(x), rc.net.forward(weights, rc, x, ref.Run())
    assert got.shape == want.shape == (B, 9, 4, 4, 64)
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
    # summation orders and the call's rounding inside the attention: the
    # readings are 0.0065 and 0.0011 of the side, the limits ~8x and ~9x
    # that; the reference in float8 reads 0.133 and 0.026
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
    out = run_cell(workload, config, [], 2 ** 31 + 29, 0.2, False, torch.device("cpu"),
                   time.perf_counter())
    assert out["correct"] and out["attempted"] >= 1 and out["failed"] == 0
    for name, c in out["checks"].items():
        assert c["value"] <= (0 if name == "nms_mismatch" else 1e-4), (name, c["value"])


def _dense_block(block, x, size, window, shift):
    """One block of x `[B, L, C]` on the grid `size`, in float64, as a
    dense attention over every pair of tokens of the padded grid: a pair
    attends iff its coordinates shifted cyclically, (p − s) mod P, fall in
    one window; its bias is the table at the difference of those shifted
    coordinates, and −100 is added where the pair's regions of the shifted
    grid (the slices (−w), (−w, −s), (−s, None) of each axis) differ."""
    Bx, L, C = x.shape
    attn = block.attn
    h = attn.heads
    d = C // h
    P = [-(-n // w) * w for n, w in zip(size, window)]
    pos = torch.stack(torch.meshgrid(*(torch.arange(p) for p in P), indexing="ij"), -1)
    pos = pos.reshape(-1, 3)
    real = (pos < torch.tensor(size)).all(-1)
    ln = lambda m, t: F.layer_norm(t, (C,), m.weight, m.bias, m.eps)  # noqa: E731
    xn = x.new_zeros((Bx, len(pos), C))
    xn[:, real] = ln(block.norm1, x)
    q, k, v = F.linear(xn, attn.qkv.weight, attn.qkv.bias).view(
        Bx, -1, 3, h, d).permute(2, 0, 3, 1, 4)
    r = (pos - torch.tensor(shift)) % torch.tensor(P)
    W = torch.tensor(window)
    together = (r[:, None] // W == r[None] // W).all(-1)
    delta = r[:, None] - r[None] + (W - 1)
    sides = 2 * W - 1
    rows = (delta[..., 0] * sides[1] + delta[..., 1]) * sides[2] + delta[..., 2]
    table = attn.relative_position_bias_table
    bias = table[rows.clamp(0, len(table) - 1)].permute(2, 0, 1)
    logits = q @ k.transpose(-1, -2) * d ** -0.5 + bias
    if any(shift):
        region = torch.zeros(len(pos), dtype=torch.long)
        for a in range(3):
            part = (((r[:, a] >= P[a] - window[a]).long() + (r[:, a] >= P[a] - shift[a]).long())
                    if shift[a] else 0)
            region = region * 3 + part
        logits = logits + (region[:, None] != region[None]) * -100.0
    logits = logits.masked_fill(~together, float("-inf"))
    out = (logits.softmax(-1) @ v).transpose(1, 2).reshape(Bx, -1, C)[:, real]
    x = x + F.linear(out, attn.proj.weight, attn.proj.bias)
    hidden = F.gelu(F.linear(ln(block.norm2, x), block.mlp.fc1.weight, block.mlp.fc1.bias))
    return x + F.linear(hidden, block.mlp.fc2.weight, block.mlp.fc2.bias)


@pytest.mark.parametrize("j", [0, 1])
def test_a_block_matches_a_dense_attention_over_every_pair_of_tokens(setup, j):
    """Stage 2's W-MSA (j = 0) and SW-MSA (j = 1) block of the tiny model on
    its 9x8x8 grid (padded to 16x14x14, 3,136 tokens), in float64, with a
    qkv bias drawn so that the padded tokens' keys and values are not 0."""
    layer = copy.deepcopy(setup[2].features.layers[1]).double()
    g = torch.Generator().manual_seed(37 + j)
    block = layer.blocks[j]
    with torch.no_grad():
        block.attn.qkv.bias.copy_(0.5 * torch.randn(block.attn.qkv.bias.shape, generator=g))
        block.attn.proj.bias.copy_(0.1 * torch.randn(block.attn.proj.bias.shape, generator=g))
    x = torch.randn((B, math.prod(layer.size), 32), generator=g, dtype=torch.float64)
    with torch.no_grad():
        got = block(x, getattr(layer, f"gather_{j}"), getattr(layer, f"scatter_{j}"),
                    layer.index, getattr(layer, f"labels_{j}"))
        want = _dense_block(block, x, layer.size, layer.window, layer.shift if j else (0, 0, 0))
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("size,shifted", [((9, 16, 16), False), ((9, 16, 16), True),
                                          ((9, 8, 8), True), ((9, 4, 4), True),
                                          ((3, 7, 14), True)])
def test_the_index_maps_are_the_references_pad_roll_and_partition(size, shifted):
    """Token numbers (and L, the zero row, where padded) put through the
    reference's pad, roll and `window_partition` are the gather; the
    reference's `window_reverse`, roll back and crop of slot numbers are
    the scatter; its `compute_mask` is the mask of the labels."""
    window, shift = swin.window_size(size)
    shift = shift if shifted else (0, 0, 0)
    gather, scatter = swin.window_slots(size, window, shift)
    L = math.prod(size)
    grid = torch.arange(L, dtype=torch.float64).view(1, *size, 1)
    pads = [(w - n % w) % w for n, w in zip(size, window)]
    padded = F.pad(grid, (0, 0, 0, pads[2], 0, pads[1], 0, pads[0]), value=L)
    rolled = torch.roll(padded, tuple(-s for s in shift), (1, 2, 3))
    assert torch.equal(gather, REF_NET.window_partition(rolled, window).flatten().long())
    Dp, Hp, Wp = padded.shape[1:4]
    slots = torch.arange(gather.numel(), dtype=torch.float64).view(-1, *window, 1)
    back = torch.roll(REF_NET.window_reverse(slots, window, 1, Dp, Hp, Wp), shift, (1, 2, 3))
    assert torch.equal(scatter, back[:, :size[0], :size[1], :size[2]].flatten().long())
    assert torch.equal(gather[scatter], torch.arange(L))
    if any(shift):
        labels = swin.region_labels(size, window, shift)
        assert torch.equal(swin.window_mask(labels),
                           REF_NET.compute_mask(Dp, Hp, Wp, window, shift, "cpu"))


def test_the_table_rows_are_the_references_relative_position_index():
    index = swin.relative_index()
    assert index.shape == (392, 392) and int(index.max()) == swin.table_rows() - 1 == 2534
    assert torch.equal(index, REF_NET.relative_position_index("cpu"))
    # the diagonal reads the centre row, (7 · 13 + 6) · 13 + 6
    assert set(index.diagonal().tolist()) == {1267}


def test_patch_merging_takes_the_2x2_neighbours_in_the_published_order():
    g = torch.Generator().manual_seed(41)
    merge = swin.PatchMerging(3)
    with torch.no_grad():
        for p in merge.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    x = torch.randn((2, 2, 5, 4, 3), generator=g)
    got = merge(x)
    assert got.shape == (2, 2, 3, 2, 6)
    padded = F.pad(x, (0, 0, 0, 0, 0, 1))
    want = torch.empty((2, 2, 3, 2, 12))
    for i in range(3):
        for j in range(2):
            want[:, :, i, j] = torch.cat([padded[:, :, 2 * i + a, 2 * j + b]
                                          for a, b in ((0, 0), (1, 0), (0, 1), (1, 1))], -1)
    want = F.linear(F.layer_norm(want, (12,), merge.norm.weight, merge.norm.bias, 1e-5),
                    merge.reduction.weight)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_the_attention_mask_holds_no_factor_of_the_batch(setup, monkeypatch):
    """Each block's `attn_mask` at B = 1 and B = 4: the same storage, one
    `[nW·h, 1, N, N]` that broadcasts over the clips, and one call a
    block."""
    model = setup[2]
    seen = []
    sdpa = F.scaled_dot_product_attention

    def recording(q, k, v, attn_mask=None, **kw):
        seen.append((tuple(q.shape), tuple(attn_mask.shape),
                     attn_mask.untyped_storage().nbytes()))
        return sdpa(q, k, v, attn_mask=attn_mask, **kw)

    monkeypatch.setattr(F, "scaled_dot_product_attention", recording)
    calls = {}
    with torch.no_grad():
        for b in (1, 4):
            seen.clear()
            model.features(torch.randn((b, 18, 32, 32, 3)))
            calls[b] = list(seen)
    assert len(calls[1]) == len(calls[4]) == 6
    for (q1, m1, n1), (q4, m4, n4) in zip(calls[1], calls[4]):
        assert q1[1] == 1 and q4[1] == 4 and m1 == m4 and m1[1] == 1 and m1[0] == q1[0]
        assert n1 == n4 == math.prod(m1) * 4


def test_at_full_depth_the_names_shapes_and_widths_are_published():
    fields = CONFIG["config"]
    with torch.device("meta"):
        model = STEPDetector(step_config(fields))
    want = {n: tuple(s) for n, (s, _) in ref.parameter_shapes(ref.config(fields)).items()}
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == want
    net = model.features
    assert isinstance(net, swin.SwinTransformer3D) and net.out_channels == 512
    assert net.patch_embed.proj.kernel_size == net.patch_embed.proj.stride == (2, 4, 4)
    assert [len(l.blocks) for l in net.layers] == [2, 2, 18]
    assert [l.blocks[0].norm1.normalized_shape[0] for l in net.layers] == [128, 256, 512]
    assert [l.blocks[0].attn.heads for l in net.layers] == [4, 8, 16]
    assert {tuple(b.attn.relative_position_bias_table.shape) for l in net.layers
            for b in l.blocks} == {(2535, 4), (2535, 8), (2535, 16)}
    assert [l.size for l in net.layers] == [(9, 56, 56), (9, 28, 28), (9, 14, 14)]
    assert {(l.window, l.shift) for l in net.layers} == {((8, 7, 7), (4, 3, 3))}
    assert [tuple(l.labels_0.shape) for l in net.layers] == [(128, 392), (32, 392), (8, 392)]
    assert [l.downsample is not None for l in net.layers] == [True, True, False]
    assert {b.mlp.fc1.out_features // b.mlp.fc1.in_features
            for l in net.layers for b in l.blocks} == {4}
    assert {m.eps for m in net.modules() if isinstance(m, torch.nn.LayerNorm)} == {1e-5}
    assert net(torch.empty((B, 18, 224, 224, 3), device="meta")).shape == (B, 9, 14, 14, 512)
    assert model.steps[0].tail.Mixed_5b.b0.conv.weight.shape[1] == 512


@pytest.mark.parametrize("over,match", [
    (dict(chunk_stem=True), "chunk_stem is refused"),
    (dict(two_stream=True), "two_stream is refused"),
    (dict(feature_stride=8), "feature_stride=8"),
])
def test_what_the_detector_refuses(over, match):
    with torch.device("meta"), pytest.raises(ValueError, match=match):
        STEPDetector(PRESETS["ava_3step"].replace(backbone=swin.NAME, **over))


def test_a_clip_the_windows_were_not_made_for_is_refused(setup):
    _, _, model, rgb, _, _ = setup
    with pytest.raises(ValueError, match="made for 9x16x16"):
        model.stem(rgb[:, :12])


def test_feature_frames_of_swin():
    assert feature_frames(PRESETS["ava_3step"].replace(backbone=swin.NAME)) == 9
    assert [swin.feature_frames(t) for t in (1, 6, 16, 17, 18, 19, 32)] == [1, 3, 8, 9, 9, 10, 16]
