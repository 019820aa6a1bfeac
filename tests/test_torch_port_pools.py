"""The routing of the backbone's max pools (`models/i3d.py::max_pool_3d`)
and the strided pool's operator (`ops/pool.py::max_pool3d_same`), on the
CPU.

  * A CUDA tensor with autograd off takes a hand-written kernel for every
    pool: `step::max_pool3x3_same` (K5) for 3x3x3 stride 1,
    `step::max_pool3d_same` for the strided windows, whatever
    `STEP_TPU_POOL3D` says. Fake CUDA tensors show the operators that a
    call reaches without a card.
  * A CPU tensor keeps the plain versions: the same bits as before, and
    the variable's one role, a `step::max_pool3x3_same` node in a program
    traced on the CPU under "pallas".
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


@pytest.mark.parametrize("variable", ["direct", "pallas"])
@pytest.mark.parametrize("window,stride", POOLS)
def test_cuda_pools_take_a_kernel_whatever_the_variable(monkeypatch, variable, window,
                                                        stride):
    monkeypatch.setenv("STEP_TPU_POOL3D", variable)
    names, y = _routed_ops(window, stride)
    want = "step::max_pool3x3_same" if stride == (1, 1, 1) else "step::max_pool3d_same"
    assert names == [want]
    assert tuple(y.shape) == pool.max_pool3d_same_shape((2, 16, 9, 11, 13), stride)
    assert y.device.type == "cuda" and y.is_contiguous(memory_format=torch.channels_last_3d)


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
    x = special_values(5, (1, 4, 6, 9, 11), torch.float32)
    with torch.no_grad():
        got = i3d.max_pool_3d(x, window, stride)
    assert torch.equal(raw_bits(got), raw_bits(pad_then_pool(x, window, stride)))


@pytest.mark.parametrize("variable", ["direct", "pallas"])
@pytest.mark.parametrize("window,stride", POOLS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_pools_keep_their_bits(monkeypatch, variable, window, stride, dtype):
    """On the CPU every pool gives `F.pad(-inf)` + `F.max_pool3d`'s bits,
    on special values too; only a 3x3x3 stride-1 pool under "pallas"
    reaches a `step::` operator (K5's, whose CPU implementation is that
    plain pool)."""
    monkeypatch.setenv("STEP_TPU_POOL3D", variable)
    x = special_values(3, (2, 8, 5, 9, 11), dtype).contiguous(
        memory_format=torch.channels_last_3d)
    with torch.no_grad(), Ops() as ops:
        got = i3d.max_pool_3d(x, window, stride)
    assert torch.equal(raw_bits(got), raw_bits(pad_then_pool(x, window, stride)))
    steps = [n for n in ops.names if n.startswith("step::")]
    kernel = variable == "pallas" and stride == (1, 1, 1)
    assert steps == (["step::max_pool3x3_same"] if kernel else [])


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
    got = pool.max_pool3d_same(x, window, stride)
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert torch.equal(raw_bits(got.contiguous()),
                       raw_bits(pad_then_pool(x, window, stride).contiguous()))
    assert pool.max_pool3d_same.launches == 0          # no kernel on the CPU


@pytest.mark.parametrize("window,stride", STRIDED)
def test_strided_pool_op_passes_opcheck(window, stride):
    x = torch.randn(2, 8, 5, 9, 11).contiguous(memory_format=torch.channels_last_3d)
    torch.library.opcheck(pool.max_pool3d_same_op, (x, list(window), list(stride)))


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
