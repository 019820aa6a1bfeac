"""The port's hand-written kernels as operators (port of `step_tpu/ops`):
each module holds a kernel's plain PyTorch version, its launcher and its
`step::` operator, made by `kernel_op.kernel_op`."""
