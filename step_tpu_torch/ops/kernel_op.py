"""The one seam between the model and the hand-written kernels.

`kernel_op` makes the custom operator `step::<name>` from what an `ops/`
module writes for its kernel, and returns the callable that module calls it
by:

  * `plain`, the operator's CPU implementation: the plain PyTorch version
    (or a short body that unpacks a weight and calls it), whose annotated
    signature is the operator's schema;
  * `launch`, its CUDA implementation: allocates the outputs and calls one
    `kernels.*_forward`;
  * `fake`, the outputs' shapes, dtypes and memory order on fake tensors
    (`torch.export`, `FakeTensorMode`);
  * `flops`, where given, its formula for `torch.utils.flop_counter`.

The callable launches the kernel itself on an eager CUDA call: a tensor of
plain type, outside `torch.export` and `torch.compile`, with no autograd
record to make (no tensor argument requires a gradient while grad mode is
on) and no dispatch mode active. Every other call goes through
`step::<name>`: a traced program keeps one node a call, an input that
requires a gradient gets the operator's refusal at backward time, and a
dispatch mode (the flop counter, a test's operator recorder) sees the call.
The dispatcher costs some 25-40 us of host time a call on an H100 machine,
which a host-bound B=1 request would pay at each of its ~20 kernel calls.

`LAUNCHES` counts the launches of every operator by its name, once a call
of `launch` on either route, `nms_many`'s (`ops/nms.py`, which no program
holds) under "nms_many", and MViTv2's attention calls on the packed query
and keys (`models/mvit.py::packed_attention`, no kernel of its own) under
"packed_attention".
"""

from __future__ import annotations

from collections import Counter

import torch
from torch.utils.flop_counter import register_flop_formula

LAUNCHES: Counter = Counter()


def _launches_itself(args) -> bool:
    x = args[0]
    if not (x.is_cuda and type(x) is torch.Tensor) or torch.compiler.is_compiling():
        return False
    if torch._C._len_torch_dispatch_stack():
        return False
    return not (torch.is_grad_enabled()
                and any(isinstance(a, torch.Tensor) and a.requires_grad for a in args))


def kernel_op(name: str, plain, launch, fake, flops=None):
    """`step::<name>` (CPU: `plain`; CUDA: `launch`, counted in
    `LAUNCHES[name]`; fake: `fake`; flop formula: `flops`), and the callable
    that takes the module's calls: positional arguments in the schema's
    order, the first a tensor on the device that picks the kernel. It
    refuses a device other than the CPU and CUDA."""
    op = torch.library.custom_op(f"step::{name}", plain, mutates_args=(), device_types="cpu")
    op.register_fake(fake)

    def cuda(*args):
        out = launch(*args)
        LAUNCHES[name] += 1
        return out

    op.register_kernel("cuda")(cuda)
    if flops is not None:
        register_flop_formula(getattr(torch.ops.step, name))(flops)

    def call(*args):
        if _launches_itself(args):
            return cuda(*args)
        if args[0].device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: no kernel for device {args[0].device}")
        return op(*args)

    call.__name__ = call.__qualname__ = f"step::{name}"
    call.__module__ = plain.__module__
    call.__doc__ = plain.__doc__
    return call
