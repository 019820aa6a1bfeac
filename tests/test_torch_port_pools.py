"""The routing of the backbone's max pools (`models/i3d.py::max_pool_3d`,
then `ops/pool.py::max_pool_same`) and the strided pool's operator
(`ops/pool.py::max_pool3d_same`), on the CPU.

  * A tensor with autograd off takes a hand-written kernel's operator for
    every pool, on either device: `step::max_pool3x3_same` (K5) for 3x3x3
    stride 1, `step::max_pool3d_same` for the strided windows, in float32
    and bfloat16. Fake CUDA tensors show the operators that a call reaches
    without a card.
  * On the CPU those operators' bodies are the plain versions: the same
    bits as `F.pad(-inf)` + `F.max_pool3d`, eager and in a program traced
    on the CPU, which holds one operator node a pool. A window over 3 or a
    stride over 2 is refused on the CPU as on the card.
  * Under autograd a strided pool keeps PyTorch's pool and backward, a
    stride-1 pool `ops/pool_grad.py`'s Function.
  * `step::max_pool3d_same` equals `F.pad(-inf)` + `F.max_pool3d` by raw
    bits on the CPU, passes `torch.library.opcheck` (CPU implementation,
    fake, strides) and stays one node under `torch.export`.
"""

import _torch_threads  # noqa: F401  (first: caps torch's threads)
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from step_tpu_torch.models import i3d
from step_tpu_torch.ops import pool
from step_tpu_torch.ops.kernel_op import LAUNCHES
from tests.test_torch_port_gpu import pad_then_pool, raw_bits, special_values

# The detector's and the classifier's pools: Mixed_* (3x3x3 stride 1),
# MaxPool_2a and 3a, MaxPool_4a, MaxPool_5a.
POOLS = [((3, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (2, 2, 2)),
         ((2, 2, 2), (2, 2, 2))]
STRIDED = POOLS[1:]


class Ops(TorchDispatchMode):
    """The operators called while it is active, by name."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.name())
        return func(*args, **(kwargs or {}))


def _routed_ops(window, stride, dtype=torch.bfloat16):
    """The `step::` and pool operators one no-grad `max_pool_3d` call on a
    fake CUDA tensor reaches, and its output."""
    with FakeTensorMode():
        x = torch.empty(2, 16, 9, 11, 13, dtype=dtype, device="cuda",
                        memory_format=torch.channels_last_3d)
        with torch.no_grad(), Ops() as ops:
            y = i3d.max_pool_3d(x, window, stride)
    return [n for n in ops.names if "pool" in n], y


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,stride", POOLS)
def test_cuda_pools_take_a_kernel_whatever_the_variable(dtype, window, stride):
    """Every pool of a CUDA tensor reaches its kernel's operator, whatever
    its dtype; the output keeps the dtype and `channels_last_3d` order."""
    names, y = _routed_ops(window, stride, dtype)
    want = "step::max_pool3x3_same" if stride == (1, 1, 1) else "step::max_pool3d_same"
    assert names == [want]
    assert tuple(y.shape) == pool.max_pool3d_same_shape((2, 16, 9, 11, 13), stride)
    assert y.device.type == "cuda" and y.is_contiguous(memory_format=torch.channels_last_3d)
    assert y.dtype == dtype


OUTSIDE = [((1, 4, 4), (1, 2, 2)), ((3, 3, 3), (3, 3, 3)), ((1, 1, 5), (1, 1, 1))]


@pytest.mark.parametrize("window,stride", OUTSIDE)
def test_cuda_pools_outside_the_kernels_contract_are_refused(window, stride):
    """No PyTorch pool stands in for the kernel on the card: a window
    over 3 or a stride over 2 is refused, by the wrapper and by the
    launcher alike."""
    from step_tpu_torch import kernels

    with pytest.raises(ValueError, match="windows of 1 to 3"):
        _routed_ops(window, stride)
    with FakeTensorMode():
        x = torch.empty(2, 9, 11, 13, 16, device="cuda")
        with pytest.raises(ValueError, match="windows of 1 to 3"):
            kernels.max_pool3d_same_forward(x, x, window, stride)


@pytest.mark.parametrize("window,stride", OUTSIDE)
def test_cpu_pools_outside_the_kernels_contract_keep_the_plain_version(window, stride):
    """A pool outside the strided kernel's contract is refused on the CPU,
    as on the card: no PyTorch pool stands in for the kernel on either
    device, and no model has such a pool."""
    x = special_values(5, (1, 4, 6, 9, 11), torch.float32)
    with torch.no_grad(), pytest.raises(ValueError, match="windows of 1 to 3"):
        i3d.max_pool_3d(x, window, stride)


class _Pool(torch.nn.Module):
    def __init__(self, window, stride):
        super().__init__()
        self.window, self.stride = window, stride

    def forward(self, x):
        return i3d.max_pool_3d(x, self.window, self.stride)


@pytest.mark.parametrize("mode", ["eager", "traced"])
@pytest.mark.parametrize("window,stride", POOLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_pools_keep_their_bits(mode, window, stride, dtype):
    """On the CPU every pool gives `F.pad(-inf)` + `F.max_pool3d`'s bits,
    on special values too, eager and as a program traced on the CPU
    (`torch.export`); each call reaches its one `step::` operator (K5's
    for 3x3x3 stride 1, the strided pool's otherwise), whose CPU
    implementation is that plain pool."""
    x = special_values(3, (2, 8, 5, 9, 11), dtype).contiguous(
        memory_format=torch.channels_last_3d)
    want_op = "max_pool3x3_same" if stride == (1, 1, 1) else "max_pool3d_same"
    with torch.no_grad():
        if mode == "eager":
            with Ops() as ops:
                got = _Pool(window, stride)(x)
            steps = [n for n in ops.names if n.startswith("step::")]
        else:
            program = torch.export.export(_Pool(window, stride), (x,))
            got = program.module()(x)
            steps = [str(n.target).replace(".default", "").replace("step.", "step::")
                     for n in program.graph.nodes
                     if n.op == "call_function" and str(n.target).startswith("step.")]
    assert torch.equal(raw_bits(got), raw_bits(pad_then_pool(x, window, stride)))
    assert steps == [f"step::{want_op}"]


@pytest.mark.parametrize("window,stride", POOLS)
def test_autograd_keeps_the_training_pools(window, stride):
    x = torch.randn(2, 8, 5, 9, 11, requires_grad=True)
    y = i3d.max_pool_3d(x, window, stride)
    if stride == (1, 1, 1):
        assert type(y.grad_fn).__name__ == "_MaxPoolS1SepGradBackward"
    else:
        assert type(y.grad_fn).__name__ == "MaxPool3DWithIndicesBackward0"
    with pytest.raises(ValueError, match="inference only"):
        pool.max_pool3d_same(x, window, stride)


@pytest.mark.parametrize("shape", [(2, 64, 9, 28, 28), (1, 40, 3, 17, 23), (2, 13, 5, 9, 11),
                                   (1, 8, 1, 1, 1), (1, 16, 6, 2, 3)])
@pytest.mark.parametrize("window,stride", STRIDED + [((3, 2, 1), (1, 2, 2))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_strided_pool_op_equals_pad_then_pool(shape, window, stride, dtype):
    x = special_values(7, shape, dtype).contiguous(memory_format=torch.channels_last_3d)
    before = LAUNCHES["max_pool3d_same"]
    got = pool.max_pool3d_same(x, window, stride)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(raw_bits(got.contiguous()),
                       raw_bits(pad_then_pool(x, window, stride).contiguous()))
    assert LAUNCHES["max_pool3d_same"] == before        # no kernel on the CPU


@pytest.mark.parametrize("window,stride", STRIDED)
def test_strided_pool_op_passes_opcheck(window, stride):
    x = torch.randn(2, 8, 5, 9, 11).contiguous(memory_format=torch.channels_last_3d)
    torch.library.opcheck(torch.ops.step.max_pool3d_same.default,
                          (x, list(window), list(stride)))


def test_strided_pool_op_is_one_node_of_an_exported_program():
    class Stem(torch.nn.Module):
        def forward(self, x):
            return pool.max_pool3d_same(x, (1, 3, 3), (1, 2, 2))

    x = torch.randn(1, 8, 3, 9, 11).contiguous(memory_format=torch.channels_last_3d)
    with torch.no_grad():
        program = torch.export.export(Stem(), (x,))
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("step.max_pool3d_same.default") == 1
    assert not any("max_pool3d" in t and not t.startswith("step.") for t in targets)
    assert torch.equal(program.module()(x), pad_then_pool(x, (1, 3, 3), (1, 2, 2)))


def test_strided_pool_launcher_refuses_what_it_does_not_take():
    from step_tpu_torch import kernels

    x = torch.zeros(1, 2, 3, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.max_pool3d_same_forward(x, x, (1, 3, 3), (1, 2, 2))
    with pytest.raises(ValueError, match="device"):
        pool.max_pool3d_same(x.to("meta"), (1, 3, 3), (1, 2, 2))
