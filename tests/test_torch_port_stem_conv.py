"""The stem unit's convolution, Conv3d_1a_7x7 (`ops/stem_conv.py`, kernel
`csrc/stem_conv.cu`), on the CPU:

  * the plain version equals `models/i3d.py::conv3d_same` plus the
    epilogue in float32 bit for bit (the same PyTorch operations), and the
    JAX package's space-to-depth convolution (`step_tpu/ops/stem_conv.py::
    space_to_depth_conv3d`) within 2e-5, the two summing 1,029 products
    in other orders; over C 2 and 3, odd and even T/H/W, each epilogue;
  * the kernel's indexing, modelled tile by tile in numpy (the patch a
    producer stages, the 32-bit pair each consumer lane loads at its
    compile-time offset, the masked segment pads, the packed weight as the
    wgmma B operand), gives the plain version's convolution;
  * the packed weight unpacks to the weight, and each of its columns holds
    the tap the kernel's A operand pairs it with;
  * the wrapper refuses a wrong dtype, shape or memory order, passes
    `torch.library.opcheck`, counts the FLOPs aten's convolution counts,
    and stays one node under `torch.export`;
  * the detector's routing leaves CPU outputs bit for bit as they were: a
    stem unit on a CPU tensor, in each variant, is `conv3d_same` and its
    epilogue, and no kernel launch is counted.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from step_tpu.ops.stem_conv import space_to_depth_conv3d
from step_tpu_torch import kernels
from step_tpu_torch.models import i3d
from step_tpu_torch.ops import stem_conv as sc
from step_tpu_torch.ops.kernel_op import LAUNCHES

SHAPES = [(5, 15, 17), (6, 16, 16)]
EPILOGUES = {"bias_relu": (False, True, True), "scale_bias_relu": (True, True, True),
             "none": (False, False, False)}


def _inputs(seed, N, C, T, H, W, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, T, H, W, C).astype(np.float32)
    w = (rng.randn(64, C, 7, 7, 7) * 0.05).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    bias = rng.randn(64).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).to(dtype)
    return x, w, scale, bias, xt


def _epilogue(y, scale, bias, relu):
    shape = (1, -1, 1, 1, 1)
    if scale is not None:
        y = y * scale.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return torch.relu(y) if relu else y


@pytest.mark.parametrize("C", [2, 3])
@pytest.mark.parametrize("thw", SHAPES)
@pytest.mark.parametrize("epilogue", sorted(EPILOGUES))
def test_plain_equals_conv3d_same_and_the_jax_space_to_depth_conv(C, thw, epilogue):
    x, w, scale, bias, xt = _inputs(0, 2, C, *thw)
    use_scale, use_bias, relu = EPILOGUES[epilogue]
    s = torch.from_numpy(scale) if use_scale else None
    b = torch.from_numpy(bias) if use_bias else None
    got = sc.stem_conv_plain(xt, torch.from_numpy(w), s, b, relu)
    conv = i3d.conv3d_same(xt, torch.from_numpy(w), None, (2, 2, 2))
    assert got.shape == (2, 64, *(-(-n // 2) for n in thw)) and got.dtype == torch.float32
    assert torch.equal(got, _epilogue(conv, s, b, relu))
    jax_conv = np.array(space_to_depth_conv3d(jnp.asarray(x),
                                                jnp.asarray(w.transpose(2, 3, 4, 1, 0)),
                                                (2, 2, 2)))
    want = _epilogue(torch.from_numpy(jax_conv).permute(0, 4, 1, 2, 3), s, b, relu)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("C", [2, 3])
def test_plain_rounds_once_to_bf16(C):
    _, w, scale, bias, xt = _inputs(1, 1, C, 6, 16, 16, torch.bfloat16)
    s, b = torch.from_numpy(scale), torch.from_numpy(bias)
    got = sc.stem_conv_plain(xt, torch.from_numpy(w), s, b)
    w16 = torch.from_numpy(w).to(torch.bfloat16).float()
    want = _epilogue(i3d.conv3d_same(xt.float(), w16, None, (2, 2, 2)), s, b, True)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))


def stem_kernel_model(x: np.ndarray, packed: np.ndarray, C: int) -> np.ndarray:
    """`csrc/stem_conv.cu`'s arithmetic, tile by tile: x `[N, T, H, W, C]`,
    the packed weight `[64, Rpad]` → the convolution `[N, To, Ho, Wo, 64]`
    in float32 (no epilogue). Each tile of 8 x 16 outputs of one (n, t')
    stages a `[7, 21, 38 C]` patch from input origin (2 t' - pad_t, 2 h0 -
    pad_h, 2 w0 - pad_w), zero outside x; output row r, column j of the
    tile reads, for half u of k16 step u // 2 (group gg of segment s = 7 dt
    + dh), the values at patch offset (21 dt + dh + 2 r) * 38 C + 2 j C +
    8 gg + e, e < 8, masked where 8 gg + e >= 7 C; the packed column 8 u +
    e is its B row."""
    N, T, H, W, _ = x.shape
    seg, rpad = kernels.stem_packed_shape(C)
    groups, halves = seg // 8, 49 * (seg // 8)
    steps = (halves + 1) // 2
    pwc = 38 * C
    To, Ho, Wo = (-(-n // 2) for n in (T, H, W))
    pads = [max((-(-n // 2) - 1) * 2 + 7 - n, 0) // 2 for n in (T, H, W)]
    # the element offsets of one position's A row, relative to its base
    offs = np.zeros(steps * 16, np.int64)
    valid = np.zeros(steps * 16, bool)
    for u in range(halves):
        s, gg = divmod(u, groups)
        dt, dh = divmod(s, 7)
        for e in range(8):
            offs[8 * u + e] = (dt * 21 + dh) * pwc + 8 * gg + e
            valid[8 * u + e] = 8 * gg + e < 7 * C
    B = packed[:, :steps * 16].T                                   # [16 steps, 64]
    rows, cols = np.meshgrid(np.arange(8), np.arange(16), indexing="ij")
    base = (2 * rows * pwc + 2 * cols * C).reshape(-1, 1)         # [128, 1]
    out = np.zeros((N, To, Ho, Wo, 64), np.float32)
    xf = x.reshape(N, T, H, W * C)
    for n in range(N):
        for to in range(To):
            for h0 in range(0, Ho, 8):
                for w0 in range(0, Wo, 16):
                    patch = np.zeros((7, 21, pwc), np.float32)
                    t0, hh0, c0 = 2 * to - pads[0], 2 * h0 - pads[1], (2 * w0 - pads[2]) * C
                    for f in range(7):
                        for rr in range(21):
                            t, h = t0 + f, hh0 + rr
                            if 0 <= t < T and 0 <= h < H:
                                lo, hi = max(c0, 0), min(c0 + pwc, W * C)
                                if lo < hi:
                                    patch[f, rr, lo - c0:hi - c0] = xf[n, t, h, lo:hi]
                    A = np.where(valid, patch.reshape(-1)[base + offs], 0.0)
                    y = (A @ B).reshape(8, 16, 64)
                    hs, ws = min(8, Ho - h0), min(16, Wo - w0)
                    out[n, to, h0:h0 + hs, w0:w0 + ws] = y[:hs, :ws]
    return out


@pytest.mark.parametrize("C,shape", [(3, (1, 5, 15, 17)), (3, (2, 6, 16, 34)),
                                     (2, (1, 7, 33, 19)), (3, (1, 1, 3, 5))])
def test_the_kernels_indexing_model_gives_the_convolution(C, shape):
    x, w, _, _, xt = _inputs(2, *shape[:1], C, *shape[1:])
    packed = sc.pack_stem_weight(torch.from_numpy(w)).float().numpy()
    got = stem_kernel_model(x, packed, C)
    # the packed weight is bf16: the plain version on the same rounded weight
    want = sc.stem_conv_plain(xt, torch.from_numpy(w).to(torch.bfloat16).float(), relu=False)
    np.testing.assert_allclose(got, want.permute(0, 2, 3, 4, 1).numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("C", [2, 3])
def test_the_packed_weight_unpacks_and_pads_with_zeros(C):
    w = torch.randn(64, C, 7, 7, 7)
    packed = sc.pack_stem_weight(w)
    seg, rpad = kernels.stem_packed_shape(C)
    assert packed.shape == (64, rpad) and packed.dtype == torch.bfloat16
    assert packed.is_contiguous() and rpad % kernels.CONV_TILE_K == 0
    assert torch.equal(sc.unpack_stem_weight(packed, C), w.to(torch.bfloat16))
    o, c, dt, dh, dw = 5, C - 1, 3, 6, 4
    assert packed[o, (7 * dt + dh) * seg + C * dw + c] == w[o, c, dt, dh, dw].to(torch.bfloat16)
    cols = torch.arange(rpad)
    pad = (cols >= 49 * seg) | (cols % seg >= 7 * C)
    assert not packed[:, pad].any()
    assert (seg, rpad) == {3: (24, 1216), 2: (16, 832)}[C]


def _cl(t):
    return t.contiguous(memory_format=torch.channels_last_3d)


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x = _cl(torch.randn(1, 3, 6, 16, 16, dtype=torch.bfloat16))
    w = torch.randn(64, 3, 7, 7, 7)
    with pytest.raises(ValueError, match="bfloat16"):
        sc.stem_conv(x.float(), w)
    with pytest.raises(ValueError, match="C in"):
        sc.stem_conv(_cl(torch.randn(1, 4, 6, 16, 16, dtype=torch.bfloat16)),
                     torch.randn(64, 4, 7, 7, 7))
    with pytest.raises(ValueError, match="weight"):
        sc.stem_conv(x, torch.randn(64, 3, 3, 7, 7))
    with pytest.raises(ValueError, match="weight"):
        sc.stem_conv(x, torch.randn(32, 3, 7, 7, 7))
    with pytest.raises(ValueError, match="channels_last_3d"):
        sc.stem_conv(x.contiguous(), w)
    with pytest.raises(ValueError, match="bias"):
        sc.stem_conv(x, w, bias=torch.zeros(32))
    with pytest.raises(ValueError, match="kernel needs CUDA"):
        out = torch.empty(1, 3, 8, 8, 64, dtype=torch.bfloat16)
        kernels.stem_conv_forward(x.permute(0, 2, 3, 4, 1), sc.pack_stem_weight(w), None, None,
                                  out, True)


@pytest.mark.parametrize("C", [2, 3])
def test_the_wrapper_on_the_cpu_is_the_plain_version(C):
    _, w, scale, bias, xt = _inputs(3, 2, C, 5, 15, 17, torch.bfloat16)
    xt = _cl(xt)
    w, s, b = (torch.from_numpy(a) for a in (w, scale, bias))
    cache = {}
    before = LAUNCHES["stem_conv"]
    got = sc.stem_conv(xt, w, s, b, weight_cache=cache)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(got, sc.stem_conv_plain(xt, w, s, b))
    assert sc.stem_kernel_weight(w, cache) is cache["value"]
    assert LAUNCHES["stem_conv"] == before


def test_the_op_passes_opcheck_and_counts_the_convolutions_flops():
    _, w, scale, bias, xt = _inputs(4, 1, 3, 6, 9, 11, torch.bfloat16)
    xt = _cl(xt)
    packed = sc.pack_stem_weight(torch.from_numpy(w))
    for s, b, relu in ((None, torch.from_numpy(bias), True),
                       (torch.from_numpy(scale), torch.from_numpy(bias), True),
                       (None, None, False)):
        torch.library.opcheck(torch.ops.step.stem_conv.default, (xt, packed, s, b, relu))
    with FlopCounterMode(display=False) as ours:
        sc.stem_conv_op(xt, packed, None, None, True)
    with FlopCounterMode(display=False) as aten:
        i3d.conv3d_same(xt.float(), torch.from_numpy(w), None, (2, 2, 2))
    assert ours.get_total_flops() == aten.get_total_flops() > 0


def test_the_op_is_one_node_of_an_exported_program():
    class Stem(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.randn(64, 3, 7, 7, 7))

        def forward(self, x):
            return sc.stem_conv(x, self.w, None, None)

    x = _cl(torch.randn(1, 3, 6, 16, 16, dtype=torch.bfloat16))
    with torch.no_grad():
        program = torch.export.export(Stem(), (x,))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("step.stem_conv.default") == 1
    assert not any("convolution" in t for t in targets)


@pytest.mark.parametrize("variant", ["bn_folded", "fused_bn_relu", "unfused"])
@pytest.mark.parametrize("C", [2, 3])
def test_the_routing_leaves_cpu_stem_units_bit_for_bit_as_they_were(variant, C):
    torch.manual_seed(5)
    before = LAUNCHES["stem_conv"]
    unit = i3d.Unit3D(C, 64, (7, 7, 7), (2, 2, 2), bn_folded=variant == "bn_folded",
                      fused_bn_relu=variant == "fused_bn_relu").eval()
    with torch.no_grad():
        for p in unit.parameters():
            p.uniform_(-0.1, 0.1)
        if unit.bn is not None:
            unit.bn.running_var.uniform_(0.5, 1.5)
            unit.bn.running_mean.uniform_(-0.1, 0.1)
        unit = unit.to(torch.bfloat16)
        x = _cl(torch.randn(2, C, 6, 16, 16, dtype=torch.bfloat16))
        got = unit(x)
        y = i3d.conv3d_same(x, unit.conv.weight, unit.conv.bias, (2, 2, 2))
        if variant == "fused_bn_relu":
            want = i3d.fused_scale_bias_relu(y, *unit.bn.scale_bias())
        else:
            want = F.relu(y if unit.bn is None else unit.bn(y))
    assert not sc.stem_kernel_takes(x, unit.conv.weight, unit.stride)
    assert torch.equal(got, want) and LAUNCHES["stem_conv"] == before
