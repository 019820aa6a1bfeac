"""The seam between the model and the hand-written kernels
(`step_tpu_torch/ops/kernel_op.py`), over the port's eight `step::`
operators, on the CPU. For each:

  * the operator's callable gives the plain version's bits on the CPU;
  * `torch.library.opcheck` passes (schema, fake, CPU implementation);
  * the eager call and a program traced on the CPU (`torch.export`, one
    node of the operator) give the same bits;
  * one eager call on a fake CUDA tensor takes the launcher, with the
    `kernels.*_forward` it calls stood in for (no card here), and counts
    one launch in `LAUNCHES` under the operator's name.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from step_tpu_torch import inference, kernels
from step_tpu_torch.ops import (attn_pool, conv3d, fused_bn_relu, kernel_op, pool, roi_align,
                                stem_conv)
from step_tpu_torch.ops.kernel_op import LAUNCHES


def _cl(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous(memory_format=torch.channels_last_3d)


def _max_pool3x3_same():
    x = _cl(torch.randn(2, 8, 5, 9, 11))
    return pool.max_pool3x3_same, (x,), pool.max_pool3x3_same_plain(x)


def _max_pool3d_same():
    x = _cl(torch.randn(2, 8, 5, 9, 11))
    return (pool.max_pool3d_same_op, (x, [1, 3, 3], [1, 2, 2]),
            pool.max_pool3d_same_plain(x, (1, 3, 3), (1, 2, 2)))


def _stem_conv():
    x = _cl(torch.randn(1, 3, 6, 12, 14).to(torch.bfloat16))
    w = torch.randn(64, 3, 7, 7, 7) * 0.1
    s, b = torch.rand(64) + 0.5, torch.randn(64)
    return (stem_conv.stem_conv_op, (x, stem_conv.pack_stem_weight(w), s, b, True),
            stem_conv.stem_conv_plain(x, w, s, b, True))


def _conv3x3x3_bn_relu():
    x = _cl(torch.randn(2, 8, 3, 5, 6))
    w = torch.randn(12, 8, 3, 3, 3) * 0.2
    s, b = torch.rand(12) + 0.5, torch.randn(12)
    return (conv3d.conv3x3x3_bn_relu_op, (x, conv3d.kernel_weight(w, x.dtype), s, b),
            conv3d.conv3x3x3_bn_relu_plain(x, w, s, b))


def _scale_bias_relu():
    x = _cl(torch.randn(2, 8, 3, 5, 6))
    s, b = torch.rand(8) + 0.5, torch.randn(8)
    return (fused_bn_relu.scale_bias_relu_op, (x, s, b),
            fused_bn_relu.fused_scale_bias_relu_plain(x, s, b))


def _tube_roi_align():
    features = torch.randn(2, 3, 10, 12, 16)
    tubes = torch.rand(2, 4, 6, 4) * 80
    tubes[..., 2:] += tubes[..., :2] + 8
    args = (features, tubes, 7, 1 / 16, 2)
    return roi_align.tube_roi_align_op, args, roi_align.tube_roi_align_plain(*args)


def _nms_surface():
    tubes = torch.rand(2, 8, 3, 4) * 50
    tubes[..., 2:] += tubes[..., :2] + 5
    scores = torch.rand(2, 8, 5)
    mask = (torch.arange(8) < 6).to(torch.float32).expand(2, 8).contiguous()
    args = (tubes, scores, mask, 4, 0.5, 0.05)
    return inference.nms_surface_op, args, inference._surface_plain(*args)


def _attn_pool():
    qkv = torch.randn(2, 3 * 4 * 5, 3 * 32)
    w, nw, nb = torch.randn(16, 1, 3, 3, 3) * 0.2, torch.rand(16) + 0.5, torch.randn(16)
    return (attn_pool.attn_pool_op, (qkv, w, nw, nb, 1, 2, [3, 4, 5], [1, 2, 2], 1e-6),
            attn_pool.attn_pool_plain(qkv, 1, 2, (3, 4, 5), (1, 2, 2), w, nw, nb, 1e-6))


OPERATORS = {
    "max_pool3x3_same": (_max_pool3x3_same, "max_pool3x3_forward"),
    "max_pool3d_same": (_max_pool3d_same, "max_pool3d_same_forward"),
    "stem_conv": (_stem_conv, "stem_conv_forward"),
    "conv3x3x3_bn_relu": (_conv3x3x3_bn_relu, "conv3x3x3_bn_relu_forward"),
    "scale_bias_relu": (_scale_bias_relu, "scale_bias_relu_forward"),
    "tube_roi_align": (_tube_roi_align, "tube_roi_align_forward"),
    "nms_surface": (_nms_surface, "nms_many_forward"),
    "attn_pool": (_attn_pool, "attn_pool_forward"),
}


class _Call(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def _bits(out) -> list:
    outs = out if isinstance(out, (tuple, list)) else (out,)
    return [t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int16)
            for t in outs]


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(_bits(a), _bits(b), strict=True))


@pytest.mark.parametrize("name", list(OPERATORS))
def test_every_operator_is_made_by_the_one_helper(monkeypatch, name):
    torch.manual_seed(0)
    make, launcher = OPERATORS[name]
    fn, args, plain = make()
    with torch.no_grad():
        eager = fn(*args)
        assert _equal(eager, plain)
        torch.library.opcheck(getattr(torch.ops.step, name).default, args)
        tensors = tuple(a for a in args if isinstance(a, torch.Tensor))
        rest = args[len(tensors):]
        program = torch.export.export(_Call(lambda *t: fn(*t, *rest)), tensors)
        nodes = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert nodes.count(f"step.{name}.default") == 1, nodes
        assert _equal(program.module()(*tensors), eager)

    launched = []
    monkeypatch.setattr(kernels, launcher, lambda *a, **k: launched.append(a[0].device))
    monkeypatch.setattr(kernel_op, "_launches_itself", lambda _: True)
    before = LAUNCHES[name]
    with FakeTensorMode():
        fake = [torch.empty_strided(a.shape, a.stride(), dtype=a.dtype, device="cuda")
                if isinstance(a, torch.Tensor) else a for a in args]
        out = fn(*fake)
    assert LAUNCHES[name] == before + 1 and len(launched) == 1
    assert launched[0].type == "cuda"
    assert all(t.device.type == "cuda" for t in (out if isinstance(out, tuple) else (out,)))
