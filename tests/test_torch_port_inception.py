"""The heads' served Inception block as one operator (`ops/inception.py`,
`step::inception_block`, kernels `csrc/gemm.cu` and `csrc/conv3d.cu` over
`csrc/igemm.cuh`) and the heads' `step::conv1x1x1_bias_relu`, on the CPU:

  * the plain version equals `InceptionBlock.forward` of a BN-folded,
    fused block bit for bit, in float32 and bfloat16, at the tail's channel
    splits (Mixed_5b, Mixed_5c, the tiny tail's);
  * the launcher, run here with a torch model of the implicit GEMM's
    indexing in place of the kernel (`igemm_model`: the row gather at the
    input's row stride, the taps' shifts and SAME zero fill, the packed
    weight, the split epilogue into two strided destinations), gives the
    plain version: each conv reads and writes the channel slices it must;
    the model alone, on a strided input and a split output, gives the
    convolution;
  * both operators pass `torch.library.opcheck`, count the FLOPs aten's
    convolutions count, give a `channels_last_3d` output of the right
    shape and dtype on fake tensors, and stay one node under
    `torch.export`; an eager call on the card's route counts one launch;
  * routing: a BN-folded, fused tail whose input the kernels take runs
    each block as the operator and its head's reduction as the GEMM;
    training, autograd, the unfolded kernel configuration,
    `fused_inception3`, float32 and the CPU, and the stem's blocks do not.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from step_tpu_torch import kernels
from step_tpu_torch.models import i3d, nets
from step_tpu_torch.ops import inception, kernel_op, pool
from step_tpu_torch.ops.conv3d import (pack_conv_weight, pack_tube_weight,
                                       unpack_kernel_weight, unpack_tube_weight)
from step_tpu_torch.ops.kernel_op import LAUNCHES

BLOCKS = {"Mixed_5b": (832, i3d.INCEPTION_CHANNELS["Mixed_5b"]),
          "Mixed_5c": (832, i3d.INCEPTION_CHANNELS["Mixed_5c"]),
          "vit_Mixed_5b": (768, i3d.INCEPTION_CHANNELS["Mixed_5b"]),
          "tiny": (128, i3d.TINY_B)}


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last_3d)


def _block(cin, channels, seed=0, **variant):
    torch.manual_seed(seed)
    variant = variant or dict(bn_folded=True, fused_inception=True)
    block = i3d.InceptionBlock(cin, channels, **variant).eval()
    with torch.no_grad():
        for p in block.parameters():
            p.normal_(0, 1.0 / max(p[0].numel(), 1) ** 0.5)
    return block


def _x(cin, N=2, T=3, dtype=torch.float32, seed=1):
    g = torch.Generator().manual_seed(seed)
    return _cl(torch.relu(torch.randn(N, cin, T, 7, 7, generator=g)).to(dtype))


def _weights(block, dtype):
    units = (block.b012, block.b1b, block.b2b, block.b3b)
    return inception.block_kernel_weights(
        [t for u in units for t in (u.conv.weight, u.conv.bias)], dtype)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16)


def igemm_model(x, w, scale, bias, outs, taps, warpgroups=0):
    """`csrc/igemm.cuh` in torch, index for index: row m of the A operand
    gathers reduction element r = tap * Cpad + c from the input's storage at
    (m + shift(tap)) * ldx + c, zero where the tap falls outside the grid or
    past C or TAPS * Cpad; the product with the packed weight's first K rows
    in float32; scale (or 1), bias, ReLU, one rounding; columns below the
    split to outs[0], the rest to outs[1]."""
    N, T, H, W, C = x.shape
    ldx = kernels.row_stride(x, "x")
    K = sum(o.shape[4] for o in outs)
    kw, rpad, cpad = kernels.conv_packed_shape(C, K, taps)
    assert tuple(w.shape) == (kw, rpad)
    M = N * T * H * W
    m = torch.arange(M)[:, None]
    r = torch.arange(rpad)[None, :]
    tap, c = r // cpad, r % cpad
    if taps == 27:
        dt, dh, dw = tap // 9 - 1, (tap // 3) % 3 - 1, tap % 3 - 1
    else:
        dt = dh = dw = torch.zeros_like(tap)
    t, h, ww = (m // (H * W)) % T + dt, (m // W) % H + dh, m % W + dw
    inside = ((tap < taps) & (c < C) & (t >= 0) & (t < T) & (h >= 0) & (h < H)
              & (ww >= 0) & (ww < W))
    src = (m + (dt * H + dh) * W + dw) * ldx + c
    span = (M - 1) * ldx + C
    flat = torch.as_strided(x, (span,), (1,))
    a = torch.where(inside, flat[src.clamp(0, span - 1)].float(), torch.zeros(()))
    y = a @ w[:K].float().t()
    if scale is not None:
        y = y * scale
    y = torch.relu(y + bias).to(x.dtype).reshape(N, T, H, W, K)
    split = outs[0].shape[4]
    outs[0].copy_(y[..., :split])
    if len(outs) == 2:
        outs[1].copy_(y[..., split:])


def tube_model(x, w, bias, out):
    """`csrc/conv3d.cu::tube_conv_kernel` in torch: the rows m = (n T + t)
    49 + 7 h + w in blocks of 256, across tubes; for each block and each
    64-channel chunk, a slab of the global frames its rows touch and one
    either side (zero past the tensor's ends and past C) plus a zero row;
    each step (chunk, tap) reads, for row m, the slab row of its shifted
    position, or the zero row where the tap leaves the 7x7 grid or the
    row's own tube, against the step's B tile un-swizzled from the packed
    weight (16-byte piece j of row r at j ^ (r mod 8)); bias, ReLU, one
    rounding."""
    N, T, H, W, C = x.shape
    K = out.shape[4]
    tiles, steps, bn, chunk = w.shape
    assert (H, W) == (7, 7) and (tiles, steps, bn, chunk) == kernels.tube_packed_shape(C, K)
    rows = torch.arange(bn)
    piece = torch.arange(8)[None, :] ^ (rows[:, None] % 8)
    b = torch.gather(w.reshape(tiles, steps, bn, 8, 8), 3,
                     piece[None, None, :, :, None].expand(tiles, steps, bn, 8, 8))
    b = b.reshape(tiles, steps, bn, chunk).permute(1, 3, 0, 2).reshape(steps, chunk, -1)
    frames = x.reshape(N * T, 49, C)
    flat = out.reshape(N * T * 49, K)
    M = N * T * 49
    for m0 in range(0, M, 256):
        m = torch.arange(m0, m0 + 256)
        g0 = m0 // 49 - 1
        g, hw = m // 49, m % 49
        mt, mh, mw = g % T, hw // 7, hw % 7
        acc = torch.zeros(256, tiles * bn)
        for cc in range(steps // 27):
            slab = torch.zeros(9 * 49 + 1, chunk)
            for f in range(9):
                if 0 <= g0 + f < N * T:
                    part = frames[g0 + f, :, chunk * cc: chunk * (cc + 1)]
                    slab[f * 49: (f + 1) * 49, : part.shape[1]] = part.float()
            for tap in range(27):
                dt, dh, dw = tap // 9 - 1, (tap // 3) % 3 - 1, tap % 3 - 1
                tt, hh, ww = mt + dt, mh + dh, mw + dw
                ok = ((m < M) & (tt >= 0) & (tt < T) & (hh >= 0) & (hh < 7) & (ww >= 0)
                      & (ww < 7))
                p = torch.where(ok, (g - g0 + dt) * 49 + 7 * hh + ww, 9 * 49)
                acc += slab[p.clamp(0, 9 * 49)] @ b[27 * cc + tap].float()
        y = acc[: min(256, M - m0), :K]
        flat[m0: m0 + y.shape[0]] = torch.relu(y + bias).to(out.dtype)


def _pool_model(x, out):
    out.copy_(F.max_pool3d(x.permute(0, 4, 1, 2, 3), 3, 1, 1).permute(0, 2, 3, 4, 1))


@pytest.mark.parametrize("name", ["Mixed_5b", "Mixed_5c", "tiny"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_equals_the_blocks_forward_bit_for_bit(name, dtype):
    cin, channels = BLOCKS[name]
    block = _block(cin, channels).to(dtype)
    x = _x(cin, dtype=dtype)
    with torch.no_grad():
        want = block(x)
        plain = inception.inception_block_plain(
            x, *[t for u in (block.b012, block.b1b, block.b2b, block.b3b)
                 for t in (u.conv.weight, u.conv.bias)], channels)
        op = block.forward_kernel(x)
    assert torch.equal(_bits(plain), _bits(want))
    assert torch.equal(_bits(op), _bits(want))
    assert op.dtype == dtype and op.is_contiguous(memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_the_launcher_writes_each_conv_into_its_slice(monkeypatch, name):
    """The card's route of the operator on the CPU, with `igemm_model` and a
    pool model standing in for the kernels: four GEMMs (1, 27, 27, 1 taps)
    and one pool, one launch counted, and the plain version's result."""
    cin, channels = BLOCKS[name]
    block = _block(cin, channels, seed=2)
    x = _x(cin, N=1, T=2, seed=3)
    with torch.no_grad():
        want = block(x)
    calls = []

    def model(xv, w, scale, bias, outs, taps, warpgroups=0):
        calls.append((taps, tuple(o.shape[4] for o in outs)))
        igemm_model(xv, w, scale, bias, outs, taps)

    def tube(xv, w, bias, out):
        calls.append((27, (out.shape[4],)))
        tube_model(xv, w, bias, out)

    monkeypatch.setattr(kernels, "igemm_forward", model)
    monkeypatch.setattr(kernels, "tube_conv_forward", tube)
    monkeypatch.setattr(kernels, "max_pool3x3_forward", _pool_model)
    monkeypatch.setattr(kernel_op, "_launches_itself", lambda _: True)
    before = (LAUNCHES["inception_block"], LAUNCHES["max_pool3x3_same"])
    with torch.no_grad():
        got = inception.inception_block(x, _weights(block, x.dtype), channels)
    c0, c1, c2, c3, c4, c5 = channels
    assert calls == [(1, (c0, c1 + c3)), (27, (c2,)), (27, (c4,)), (1, (c5,))]
    assert (LAUNCHES["inception_block"], LAUNCHES["max_pool3x3_same"]) == (
        before[0] + 1, before[1] + 1)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_gemm_model_splits_its_columns_into_two_strided_places():
    """b012's epilogue on its own: columns below the split into a slice of a
    wider output, the rest into a dense scratch."""
    torch.manual_seed(4)
    x = _cl(torch.randn(2, 64, 3, 7, 7))
    weight, bias = torch.randn(40, 64, 1, 1, 1) * 0.1, torch.randn(40)
    out = torch.full((2, 3, 7, 7, 56), 7.0)
    scratch = torch.empty((2, 3, 7, 7, 16))
    igemm_model(kernels.ndhwc(x), pack_conv_weight(weight, x.dtype), None, bias,
                (out[..., 8:32], scratch), 1)
    want = F.relu(F.conv3d(x, weight, bias)).permute(0, 2, 3, 4, 1)
    torch.testing.assert_close(out[..., 8:32], want[..., :24], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(scratch, want[..., 24:], rtol=1e-5, atol=1e-5)
    assert (out[..., :8] == 7).all() and (out[..., 32:] == 7).all()


@pytest.mark.parametrize("model", ["igemm", "tube"])
@pytest.mark.parametrize("T", [3, 7])
def test_the_conv_models_read_a_channel_slice_in_place(model, T):
    """b2b on its own: the 3x3x3 conv on the last 72 of 104 channels, read at
    the row stride 104, into a slice of a wider output (K3's gather with an
    affine, the tube conv with a bias); the tube conv over one block of rows
    and over several that cross from tube to tube."""
    torch.manual_seed(5)
    wide = torch.randn(2, T, 7, 7, 104)
    weight = torch.randn(40, 72, 3, 3, 3) * 0.05
    scale = torch.rand(40) + 0.5 if model == "igemm" else torch.ones(40)
    bias = torch.randn(40)
    out = torch.zeros(2, T, 7, 7, 64)
    if model == "igemm":
        igemm_model(wide[..., 32:], pack_conv_weight(weight, wide.dtype), scale, bias,
                    (out[..., 16:56],), 27)
    else:
        tube_model(wide[..., 32:], pack_tube_weight(weight, wide.dtype), bias, out[..., 16:56])
    x = wide[..., 32:].permute(0, 4, 1, 2, 3)
    want = F.relu(F.conv3d(x, weight, None, 1, 1) * scale.view(1, -1, 1, 1, 1)
                  + bias.view(1, -1, 1, 1, 1))
    torch.testing.assert_close(out[..., 16:56], want.permute(0, 2, 3, 4, 1),
                               rtol=1e-5, atol=1e-5)
    assert (out[..., :16] == 0).all() and (out[..., 56:] == 0).all()


def test_row_stride_takes_channel_slices_and_refuses_uneven_rows():
    t = torch.empty(2, 3, 7, 7, 56)
    assert kernels.row_stride(t, "t") == 56 and kernels.row_stride(t[..., 8:32], "t") == 56
    assert kernels.row_stride(t[:1, :1, :1, :1], "t") == 56
    for bad in (t[:, :, :, ::2], t[..., ::2], t[:, :, 1:6]):
        with pytest.raises(ValueError):
            kernels.row_stride(bad, "t")


@pytest.mark.parametrize("K,C", [(320, 160), (128, 32), (384, 192), (128, 48), (24, 8)])
def test_the_tube_weight_packs_each_step_in_the_swizzle_and_unpacks(K, C):
    weight = torch.randn(K, C, 3, 3, 3)
    packed = pack_tube_weight(weight, torch.bfloat16)
    tiles, steps, bn, chunk = kernels.tube_packed_shape(C, K)
    assert tuple(packed.shape) == (tiles, steps, bn, chunk) and bn in kernels.TUBE_TILE_N
    assert torch.equal(unpack_tube_weight(packed, C, K), weight.to(torch.bfloat16))
    k, c, dt, dh, dw = K - 1, C - 1, 2, 0, 1
    t, r = divmod(k, bn)
    cc, e = divmod(c, chunk)
    slot = ((e // 8) ^ (r % 8)) * 8 + e % 8
    assert packed[t, 27 * cc + 9 * dt + 3 * dh + dw, r, slot] == weight[k, c, dt, dh, dw].to(
        torch.bfloat16)


def test_the_1x1x1_weight_packs_and_unpacks():
    weight = torch.randn(448, 832, 1, 1, 1)
    packed = pack_conv_weight(weight, torch.bfloat16)
    kw, rpad, cpad = kernels.conv_packed_shape(832, 448, 1)
    assert (kw, rpad, cpad) == (448, 832, 832) and tuple(packed.shape) == (kw, rpad)
    assert torch.equal(unpack_kernel_weight(packed, 832, 448, 1), weight.to(torch.bfloat16))
    odd = torch.randn(24, 20, 1, 1, 1)
    kw, rpad, cpad = kernels.conv_packed_shape(20, 24, 1)
    packed = pack_conv_weight(odd, torch.float32)
    assert (rpad, cpad) == (64, 24) and (packed[24:] == 0).all() and (packed[:, 20:] == 0).all()
    assert torch.equal(unpack_kernel_weight(packed, 20, 24, 1), odd)


def _inception_args(dtype=torch.float32):
    cin, channels = BLOCKS["tiny"]
    block = _block(cin, channels, seed=6).to(dtype).requires_grad_(False)
    return (_x(cin, dtype=dtype), *_weights(block, dtype), list(channels))


def _conv1x1x1_args(dtype=torch.float32):
    torch.manual_seed(7)
    weight, bias = torch.randn(64, 128, 1, 1, 1) * 0.1, torch.randn(64)
    return (_x(128, dtype=dtype), *inception.block_kernel_weights((weight, bias), dtype))


OPERATORS = {"inception_block": (inception.inception_block_op, _inception_args),
             "conv1x1x1_bias_relu": (inception.conv1x1x1_bias_relu_op, _conv1x1x1_args)}


def _flops(x, weight, out_channels, taps=1):
    N, C, T, H, W = x.shape
    return 2 * N * T * H * W * C * out_channels * taps


@pytest.mark.parametrize("name", list(OPERATORS))
def test_the_ops_pass_opcheck_and_count_the_convolutions_flops(name):
    op, make = OPERATORS[name]
    args = make()
    torch.library.opcheck(getattr(torch.ops.step, name).default, args)
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            op(*args)
    x = args[0]
    if name == "inception_block":
        c0, c1, c2, c3, c4, c5 = args[-1]
        N, C, T, H, W = x.shape
        M = N * T * H * W
        want = 2 * M * (C * (c0 + c1 + c3) + 27 * (c1 * c2 + c3 * c4) + C * c5)
    else:
        want = _flops(x, args[1], args[2].shape[0])
    assert counter.get_total_flops() == want


@pytest.mark.parametrize("name", list(OPERATORS))
def test_the_fake_gives_a_channels_last_output_of_the_right_shape(name):
    op, make = OPERATORS[name]
    args = make(torch.bfloat16)
    with torch.no_grad():
        real = op(*args)
    with FakeTensorMode():
        fake = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device="cuda")
                if isinstance(a, torch.Tensor) else a for a in args]
        out = getattr(torch.ops.step, name)(*fake)
    assert tuple(out.shape) == tuple(real.shape) and out.dtype == torch.bfloat16
    assert out.device.type == "cuda"
    assert out.is_contiguous(memory_format=torch.channels_last_3d)


@pytest.mark.parametrize("depth,blocks", [("full", 2), ("tiny", 1)])
def test_an_exported_head_holds_one_node_per_block_and_one_reduction(monkeypatch,
                                                                     depth, blocks):
    """A head whose tail takes the kernels (the predicate stood in for on the
    CPU) exports with one `step::inception_block` node a block and one
    `step::conv1x1x1_bias_relu`, and the program gives the eager bits."""
    monkeypatch.setattr(i3d, "kernel_takes", lambda x, cin, channels: True)
    cin = 832 if depth == "full" else 128
    torch.manual_seed(8)
    head = nets.TwoBranchHead(cin, 5, 8, depth=depth, bn_folded=True,
                              fused_inception=True).eval().requires_grad_(False)
    pooled = torch.randn(2, 2, 7, 7, cin)
    with torch.no_grad():
        eager = head(pooled)
        program = torch.export.export(head, (pooled,))
    nodes = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert nodes.count("step.inception_block.default") == blocks, nodes
    assert nodes.count("step.conv1x1x1_bias_relu.default") == 1, nodes
    assert not [n for n in nodes if "aten.cat" in n or "aten.relu" in n], nodes
    got = program.module()(pooled)
    assert all(torch.equal(a, b) for a, b in zip(got, eager))


ROUTES = {
    "folded_fused": (dict(bn_folded=True, fused_inception=True), {}, 2),
    "train": (dict(), dict(train=True), 0),
    "autograd": (dict(bn_folded=True, fused_inception=True), dict(grad=True), 0),
    "kernel_configuration": (dict(fused_bn_relu=True), {}, 0),
    "fused_inception3": (dict(bn_folded=True, fused_inception=True, fused_inception3=True),
                         {}, 0),
    "unfused": (dict(bn_folded=True), {}, 0),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_the_tail_routes_by_what_it_can_observe(monkeypatch, route):
    """With the kernels' predicate stood in for (the CPU has none), only the
    BN-folded, fused tail in inference without autograd takes the operator,
    once a block, and its head's reduction the GEMM; every route gives the
    module path's bits."""
    variant, how, n_blocks = ROUTES[route]
    monkeypatch.setattr(i3d, "kernel_takes", lambda x, cin, channels: True)
    calls = []
    real_block, real_reduce = i3d.inception_block, nets.conv1x1x1_bias_relu
    monkeypatch.setattr(i3d, "inception_block",
                        lambda *a: calls.append("block") or real_block(*a))
    monkeypatch.setattr(nets, "conv1x1x1_bias_relu",
                        lambda *a: calls.append("reduce") or real_reduce(*a))
    torch.manual_seed(9)
    head = nets.TwoBranchHead(832, 5, 8, depth="full", **variant)
    head.train(how.get("train", False))
    pooled = torch.randn(2, 2, 7, 7, 832, requires_grad=how.get("grad", False))
    with torch.set_grad_enabled(how.get("grad", False)):
        head(pooled, train=how.get("train", False))
    assert calls == ["block"] * n_blocks + ["reduce"] * (n_blocks > 0)


def test_the_tail_on_the_cpu_and_in_float32_keeps_the_module_path(monkeypatch):
    """The kernels' own predicate refuses a CPU tensor and float32 (and takes
    a bf16 CUDA tensor's shape); the stem's blocks never ask it."""
    cin, channels = BLOCKS["Mixed_5b"]
    assert not inception.kernel_takes(torch.empty(1, cin, 1, 7, 7, dtype=torch.bfloat16),
                                      cin, channels)
    with FakeTensorMode():
        cuda16 = torch.empty(1, cin, 1, 7, 7, dtype=torch.bfloat16, device="cuda")
        cuda32 = torch.empty(1, cin, 1, 7, 7, device="cuda")
        assert inception.kernel_takes(cuda16, cin, channels)
        assert not inception.kernel_takes(cuda32, cin, channels)
        assert not inception.kernel_takes(cuda16, cin, (256, 160, 320, 36, 128, 128))
    calls = []
    monkeypatch.setattr(i3d, "kernel_takes", lambda x, cin, channels: True)
    monkeypatch.setattr(i3d, "inception_block", lambda *a: calls.append(a))
    stem = i3d.I3DStem("tiny", bn_folded=True, fused_inception=True).eval()
    with torch.no_grad():
        stem(torch.randn(1, 3, 4, 32, 32))
    assert calls == []


def test_the_block_weight_cache_follows_load_state_dict():
    """A block keeps its operator's weights between calls and makes them anew
    after load_state_dict."""
    cin, channels = BLOCKS["tiny"]
    block = _block(cin, channels, seed=10)
    x = _x(cin)
    with torch.no_grad():
        block.forward_kernel(x)
        first = block._kernel_weights["value"]
        block.forward_kernel(x)
        assert block._kernel_weights["value"] is first
        state = {k: v.clone() for k, v in block.state_dict().items()}
        state["b1b.conv.weight"] = torch.randn_like(state["b1b.conv.weight"])
        block.load_state_dict(state)
        got = block.forward_kernel(x)
        assert block._kernel_weights["value"] is not first
        assert torch.equal(got, block(x))
