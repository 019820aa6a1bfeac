"""The plain versions of the port's backbone kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU as the JAX
package's own tests run them (`tests/test_pallas_ops.py`).

  * K5, 3x3x3 max pool (`ops/pool.py`): bit for bit, in float32 and
    bfloat16 — a max picks one of its inputs, so there is nothing to round.
  * K4, BN + ReLU (`ops/fused_bn_relu.py`): 1e-5 in float32; both compute
    the same float32 expression, but XLA may contract x * scale + bias into
    an FMA.
  * K3, 3x3x3 conv + BN + ReLU (`ops/conv3d.py`): 2e-5 in float32, the
    JAX test's own tolerance; the two convolutions sum 27 * C products in
    other orders.

The port takes the backbone's NCDHW tensors, the JAX kernels channels-last
ones, so the inputs are permuted between the two.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from step_tpu.ops.conv3d_pallas import conv3x3x3_bn_relu as jax_conv3x3x3_bn_relu
from step_tpu.ops.fused_bn_relu import bn_relu_inference as jax_bn_relu_inference
from step_tpu.ops.fused_bn_relu import fused_scale_bias_relu as jax_fused_scale_bias_relu
from step_tpu.ops.pool_pallas import max_pool3x3_same_pallas
from step_tpu_torch import kernels
from step_tpu_torch.models import i3d
from step_tpu_torch.ops import conv3d, fused_bn_relu, pool
from step_tpu_torch.ops.kernel_op import LAUNCHES
from tests.test_torch_port_pools import Ops
from tests.test_torch_port_gpu import (pool_scan_model, pool_separable_model, raw_bits,
                                       special_values)


def _ncdhw(a: np.ndarray) -> torch.Tensor:
    """Channels-last numpy `[N, T, H, W, C]` → NCDHW torch tensor."""
    return torch.from_numpy(np.array(a)).permute(0, 4, 1, 2, 3)


def _ndhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 4, 1).float().numpy()


# ------------------------------------------------------------------ K5 pool
@pytest.mark.parametrize("shape", [(6, 5, 7, 7, 12), (3, 2, 4, 9, 130), (4, 5, 7, 7, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_plain_equals_pallas_bit_for_bit(shape, dtype):
    x = jnp.asarray(np.random.RandomState(0).randn(*shape), dtype)
    want = np.asarray(max_pool3x3_same_pallas(x, block_n=4, interpret=True), np.float32)
    xt = _ncdhw(np.asarray(x, np.float32)).to(getattr(torch, dtype))
    got = pool.max_pool3x3_same_plain(xt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    np.testing.assert_array_equal(_ndhwc(got), want)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_kernel_order_equals_plain_bit_for_bit(seed, dtype):
    """The CUDA kernel's reduction order (w, then h, then t, three clamped
    taps each, later value if v > m or v is NaN) gives PyTorch's 27-tap
    scan bit for bit on +-0 ties, +-inf and NaN payloads, in channels-last
    and NCDHW order. PyTorch's CPU max_pool3d in bfloat16 returns the
    canonical NaN, so there its NaNs are held by position."""
    rng = np.random.RandomState(seed)
    shape = (2, 5, *rng.randint(1, 7, 3))
    x = special_values(seed, shape, dtype)
    for x in (x, x.contiguous(memory_format=torch.channels_last_3d)):
        got = pool_separable_model(x)
        assert torch.equal(raw_bits(got), raw_bits(pool_scan_model(x)))
        want = pool.max_pool3x3_same_plain(x)
        if dtype == torch.float32:
            assert torch.equal(raw_bits(got), raw_bits(want))
        nan = want.isnan()
        assert torch.equal(got.isnan(), nan)
        assert torch.equal(raw_bits(got[~nan]), raw_bits(want[~nan]))
    assert bool(nan.any()) and bool((raw_bits(x) == raw_bits(-torch.zeros(1, dtype=dtype))).any())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_kernel_order_equals_pallas_bit_for_bit(dtype):
    """Without NaN, the kernel's order also gives the Pallas kernel's
    result, ties of equal values and +-inf included. Signed zeros are left
    out: the Pallas kernel takes jnp.maximum, which may pick either of +0
    and -0."""
    rng = np.random.RandomState(7)
    x = rng.choice([0.0, 1.0, -1.0, np.inf, -np.inf, 2.5], size=(3, 5, 7, 7, 24))
    x = np.where(rng.rand(*x.shape) < 0.5, rng.randn(*x.shape), x).astype(np.float32)
    xj = jnp.asarray(x, dtype)
    want = np.asarray(max_pool3x3_same_pallas(xj, block_n=3, interpret=True), np.float32)
    got = pool_separable_model(_ncdhw(np.asarray(xj, np.float32)).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(_ndhwc(got), want)


def test_pool_dispatch_reads_the_variable_on_every_call():
    """No-grad CPU pools reach their kernel's operator once a call, with no
    environment variable to read: K5's for 3x3x3 stride 1, the strided
    pool's for the other windows; each gives the plain version's values."""
    x = _ncdhw(np.random.RandomState(1).randn(2, 5, 7, 7, 16).astype(np.float32))
    for window, stride, op in [((3, 3, 3), (1, 1, 1), "step::max_pool3x3_same"),
                               ((1, 3, 3), (1, 2, 2), "step::max_pool3d_same"),
                               ((3, 3, 3), (2, 2, 2), "step::max_pool3d_same")]:
        with torch.no_grad(), Ops() as ops:
            got = i3d.max_pool_3d(x, window, stride)
        torch.testing.assert_close(got, pool.max_pool3d_same_plain(x, window, stride),
                                   rtol=0, atol=0)
        assert [n for n in ops.names if n.startswith("step::")] == [op], (window, stride)


def test_pool_plain_propagates_nan():
    x = torch.zeros(1, 2, 3, 4, 4)
    x[0, 1, 1, 2, 2] = float("nan")
    out = pool.max_pool3x3_same_plain(x)
    assert bool(out[0, 1].isnan().any()) and not bool(out[0, 0].isnan().any())
    assert int(out[0, 1].isnan().sum()) == 27


# ----------------------------------------------------------------- K4 BN+ReLU
def test_scale_bias_relu_plain_matches_pallas():
    rng = np.random.RandomState(3)
    x = rng.randn(3, 4, 5, 6, 40).astype(np.float32)
    scale = (rng.rand(40) + 0.5).astype(np.float32)
    bias = rng.randn(40).astype(np.float32)
    want = np.asarray(jax_fused_scale_bias_relu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), block_rows=64,
        interpret=True))
    got = fused_bn_relu.fused_scale_bias_relu_plain(
        _ncdhw(x), torch.from_numpy(scale), torch.from_numpy(bias))
    np.testing.assert_allclose(_ndhwc(got), want, rtol=1e-5, atol=1e-5)
    assert (want == 0).mean() > 0.2                      # the ReLU cut something


def test_bn_relu_inference_plain_matches_pallas():
    rng = np.random.RandomState(4)
    C = 24
    x = rng.randn(2, 3, 5, 5, C).astype(np.float32)
    gamma, var = (rng.rand(2, C) + 0.5).astype(np.float32)
    beta, mean = (rng.randn(2, C) * 0.1).astype(np.float32)
    want = np.asarray(jax_bn_relu_inference(
        *(jnp.asarray(a) for a in (x, gamma, beta, mean, var)), 1e-3, interpret=True))
    got = fused_bn_relu.bn_relu_inference(
        _ncdhw(x), *(torch.from_numpy(a) for a in (gamma, beta, mean, var)), 1e-3)
    np.testing.assert_allclose(_ndhwc(got), want, rtol=1e-5, atol=1e-5)


def test_bn_scale_bias_is_cached_until_the_state_changes():
    """With autograd off, a BatchNorm's affine is computed once and reused;
    an in-place write, load_state_dict and .to() each make it anew. With
    autograd on it is computed on every call and carries gradients."""
    bn = i3d.BatchNorm(8)
    fresh = lambda m: fused_bn_relu.bn_scale_bias(  # noqa: E731
        m.weight, m.bias, m.running_mean, m.running_var, i3d.BN_EPS)
    with torch.no_grad():
        bn.running_var.uniform_(0.5, 1.5)
        first = bn.scale_bias()
        assert bn.scale_bias() is first
        bn.running_mean.add_(0.25)                       # in place
        second = bn.scale_bias()
        assert second is not first and bn.scale_bias() is second
        torch.testing.assert_close(second, fresh(bn), rtol=0, atol=0)
        state = {k: torch.rand_like(v) + 0.5 for k, v in bn.state_dict().items()}
        bn.load_state_dict(state)
        third = bn.scale_bias()
        assert third is not second
        torch.testing.assert_close(third, fresh(bn), rtol=0, atol=0)
        bn.to(torch.float64)
        fourth = bn.scale_bias()
        assert fourth is not third and fourth[0].dtype == torch.float32
        torch.testing.assert_close(fourth, fresh(bn), rtol=0, atol=0)
    scale, bias = bn.scale_bias()
    assert bn.scale_bias()[0] is not scale and scale.requires_grad
    (scale.sum() + bias.sum()).backward()
    assert bn.weight.grad is not None and bn.bias.grad is not None


def test_scale_bias_relu_rounds_once():
    """bfloat16 in and out, float32 in between: the plain version equals
    the float32 result rounded once."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(2, 8, 3, 4, 4).astype(np.float32)).to(torch.bfloat16)
    scale = torch.from_numpy((rng.rand(8) * 3 + 0.1).astype(np.float32))
    bias = torch.from_numpy(rng.randn(8).astype(np.float32))
    got = fused_bn_relu.fused_scale_bias_relu_plain(x, scale, bias)
    want = torch.relu(x.float() * scale.view(1, -1, 1, 1, 1)
                      + bias.view(1, -1, 1, 1, 1)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# ------------------------------------------------------- K3 conv + BN + ReLU
@pytest.mark.parametrize("N,T,H,W,C,K", [(3, 5, 7, 7, 160, 96), (2, 3, 5, 5, 40, 130)])
def test_conv_bn_relu_plain_matches_pallas(N, T, H, W, C, K):
    rng = np.random.RandomState(0)
    x = rng.randn(N, T, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, 3, C, K) * 0.05).astype(np.float32)
    scale = (rng.rand(K) + 0.5).astype(np.float32)
    bias = (rng.randn(K) * 0.1).astype(np.float32)
    want = np.asarray(jax_conv3x3x3_bn_relu(
        *(jnp.asarray(a) for a in (x, w, scale, bias)), block_n=2, block_c=64,
        interpret=True))
    weight = torch.from_numpy(np.ascontiguousarray(w.transpose(4, 3, 0, 1, 2)))
    got = conv3d.conv3x3x3_bn_relu_plain(_ncdhw(x), weight, torch.from_numpy(scale),
                                         torch.from_numpy(bias))
    assert got.shape == (N, K, T, H, W)
    np.testing.assert_allclose(_ndhwc(got), want, rtol=2e-5, atol=2e-5)


def test_conv_bn_relu_plain_is_the_fused_unit():
    """K3's contract is an inference Unit3D with a 3x3x3 stride-1 kernel:
    the unit with `fused_bn_relu` gives what the plain unit gives."""
    torch.manual_seed(0)
    plain = i3d.Unit3D(12, 20, (3, 3, 3)).eval()
    fused = i3d.Unit3D(12, 20, (3, 3, 3), fused_bn_relu=True).eval()
    with torch.no_grad():
        plain.bn.running_mean.uniform_(-0.2, 0.2)
        plain.bn.running_var.uniform_(0.5, 1.5)
        plain.bn.weight.uniform_(0.5, 1.5)
        plain.bn.bias.uniform_(-0.2, 0.2)
    fused.load_state_dict(plain.state_dict())
    assert fused.conv_bn_relu and not plain.fused
    x = torch.randn(2, 12, 3, 5, 6).contiguous(memory_format=torch.channels_last_3d)
    with torch.no_grad():
        torch.testing.assert_close(fused(x), plain(x), rtol=1e-5, atol=1e-5)


def test_fused_units_route_to_their_kernels(monkeypatch):
    calls = []
    monkeypatch.setattr(i3d, "conv3x3x3_bn_relu",
                        lambda *a, **k: calls.append("K3") or conv3d.conv3x3x3_bn_relu(*a, **k))
    monkeypatch.setattr(i3d, "fused_scale_bias_relu",
                        lambda *a: calls.append("K4") or fused_bn_relu.fused_scale_bias_relu(*a))
    x = torch.randn(1, 8, 4, 6, 6)
    units = {
        "K3": i3d.Unit3D(8, 8, (3, 3, 3), fused_bn_relu=True),
        "K4 1x1": i3d.Unit3D(8, 8, (1, 1, 1), fused_bn_relu=True),
        "K4 strided": i3d.Unit3D(8, 8, (3, 3, 3), (2, 2, 2), fused_bn_relu=True),
        "folded": i3d.Unit3D(8, 8, (3, 3, 3), bn_folded=True, fused_bn_relu=True),
    }
    with torch.no_grad():
        for unit in units.values():
            unit.eval()(x)
    assert calls == ["K3", "K4", "K4"]                   # bn_folded wins


@pytest.mark.parametrize("C,K", [(64, 192), (16, 32), (24, 64), (96, 208),
                                 (144, 288), (160, 320), (13, 70), (1, 1), (17, 65)])
def test_conv_weight_packing_is_the_kernels_contraction(C, K):
    """The bf16 kernel's GEMM over the packed weight, written out: an
    im2col of the SAME-padded input (reduction index tap * Cpad + c, zero
    past C and past 27 * Cpad) times the packed `[Kw, Rpad]` matrix gives
    the plain version, in float32."""
    rng = np.random.RandomState(C * 1000 + K)
    N, T, H, W = 2, 3, 4, 5
    x = torch.from_numpy(rng.randn(N, C, T, H, W).astype(np.float32))
    weight = torch.from_numpy((rng.randn(K, C, 3, 3, 3) / np.sqrt(27 * C)).astype(np.float32))
    scale = torch.from_numpy((rng.rand(K) + 0.5).astype(np.float32))
    bias = torch.from_numpy((rng.randn(K) * 0.1).astype(np.float32))
    packed = conv3d.pack_conv_weight(weight, torch.float32)
    kw, rpad, cpad = kernels.conv_packed_shape(C, K)
    assert packed.shape == (kw, rpad) and packed.is_contiguous()
    assert kw % kernels.conv_tile_n(K) == 0 and rpad % kernels.CONV_TILE_K == 0
    xp = torch.nn.functional.pad(x.permute(0, 2, 3, 4, 1), (0, cpad - C, 1, 1, 1, 1, 1, 1))
    cols = torch.stack([xp[:, dt:dt + T, dh:dh + H, dw:dw + W]
                        for dt in range(3) for dh in range(3) for dw in range(3)], dim=4)
    cols = torch.nn.functional.pad(cols.reshape(N * T * H * W, 27 * cpad),
                                   (0, rpad - 27 * cpad))
    y = (cols @ packed.T)[:, :K] * scale + bias
    got = torch.relu(y).reshape(N, T, H, W, K).permute(0, 4, 1, 2, 3)
    want = conv3d.conv3x3x3_bn_relu_plain(x, weight, scale, bias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_conv_tile_widths_fill_the_inception_channels():
    widths = {K: kernels.conv_tile_n(K) for K in (192, 128, 32, 96, 208, 48, 224,
                                                  64, 256, 288, 320, 384)}
    assert all(K % n == 0 for K, n in widths.items())
    assert widths[288] == 144 and widths[320] == 160 and widths[384] == 192
    assert all(widths[K] == K for K in (192, 208, 224, 256))
    assert set(widths.values()) <= set(kernels.CONV_TILE_N)
    assert kernels.conv_tile_n(70) == 96 and kernels.conv_tile_n(1000) == 128


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_weight_is_cached_until_the_weight_changes(dtype):
    """The layout a Unit3D hands its conv kernel is made once, and made
    anew after load_state_dict writes new weights in place."""
    unit = i3d.Unit3D(8, 16, (3, 3, 3), fused_bn_relu=True).eval()
    cache = unit._kernel_weight
    first = conv3d.kernel_weight(unit.conv.weight, dtype, cache)
    assert conv3d.kernel_weight(unit.conv.weight, dtype, cache) is first
    state = {k: v.clone() for k, v in unit.state_dict().items()}
    state["conv.weight"] = torch.randn_like(state["conv.weight"])
    unit.load_state_dict(state)
    second = conv3d.kernel_weight(unit.conv.weight, dtype, cache)
    assert second is not first
    assert torch.equal(second, conv3d.kernel_weight(state["conv.weight"], dtype))
    if dtype == torch.bfloat16:
        assert torch.equal(second, conv3d.pack_conv_weight(state["conv.weight"], dtype))
    else:
        assert second.shape == (27, 8, 16)
    other = torch.nn.Parameter(unit.conv.weight.detach().clone())
    assert conv3d.kernel_weight(other, dtype, cache) is not second


def test_wgmma_header_is_generated_for_the_tile_widths(tmp_path, monkeypatch):
    """csrc/wgmma.cuh is gen_wgmma.py's output, for kernels.CONV_TILE_N."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("gen_wgmma", kernels.CSRC / "gen_wgmma.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    assert tuple(gen.WIDTHS) == kernels.CONV_TILE_N
    monkeypatch.setattr(gen, "__file__", str(tmp_path / "gen_wgmma.py"))
    gen.main()
    assert (tmp_path / "wgmma.cuh").read_text() == (kernels.CSRC / "wgmma.cuh").read_text()


# --------------------------------------------------------------- dispatch
def test_wrappers_take_plain_path_on_cpu_and_raise_elsewhere():
    rng = np.random.RandomState(6)
    x = _ncdhw(rng.randn(2, 3, 4, 5, 8).astype(np.float32))
    w = torch.from_numpy(rng.randn(6, 8, 3, 3, 3).astype(np.float32))
    s, b = torch.ones(8), torch.zeros(8)
    before = dict(LAUNCHES)
    cases = [
        (pool.max_pool3x3_same, (x,), pool.max_pool3x3_same_plain),
        (fused_bn_relu.fused_scale_bias_relu, (x, s, b),
         fused_bn_relu.fused_scale_bias_relu_plain),
        (conv3d.conv3x3x3_bn_relu, (x, w, torch.ones(6), torch.zeros(6)),
         conv3d.conv3x3x3_bn_relu_plain),
    ]
    meta = torch.device("meta")
    for fn, args, plain in cases:
        torch.testing.assert_close(fn(*args), plain(*args), rtol=0, atol=0)
        assert dict(LAUNCHES) == before
        with pytest.raises(ValueError, match="no kernel"):
            fn(*(a.to(meta) for a in args))


def test_kernel_launchers_refuse_cpu_tensors():
    x = torch.zeros(1, 2, 3, 3, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.max_pool3x3_forward(x, torch.empty_like(x))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.scale_bias_relu_forward(x.view(-1, 4), torch.ones(4), torch.ones(4),
                                        torch.empty(18, 4))
    with pytest.raises(ValueError, match="CUDA"):
        kernels.conv3x3x3_bn_relu_forward(x, torch.zeros(27, 4, 5), torch.ones(5),
                                          torch.ones(5), torch.empty(1, 2, 3, 3, 5))


def test_ndhwc_is_free_for_channels_last_and_copies_otherwise():
    x = torch.randn(2, 8, 3, 4, 5)
    cl = x.contiguous(memory_format=torch.channels_last_3d)
    view = kernels.ndhwc(cl)
    assert view.is_contiguous() and view.data_ptr() == cl.data_ptr()
    copy = kernels.ndhwc(x)                              # NCDHW-contiguous input
    assert copy.is_contiguous() and copy.data_ptr() != x.data_ptr()
    assert torch.equal(copy, x.permute(0, 2, 3, 4, 1))
    out = kernels.empty_ncdhw((2, 3, 4, 5, 6), x)
    assert kernels.ndhwc(out).data_ptr() == out.data_ptr()
