"""Export of the detect program for serving.

Port of `step_tpu/utils/export.py`, with `torch.export` in place of
`jax.export`: `export_detect_fn` traces `detect_clip` for a config and a
batch size into an `ExportedProgram` and serializes it
(`torch.export.save`); a serving process loads it with `load_detect_fn`
and calls it, with no model-building Python and no retrace at serving
time. The weights stay out of the program, as in the JAX package: the
program takes the model's parameters and buffers as its first input
(`torch.func.functional_call`), so one artifact serves any fine-tune of
its config.

The hand kernels of the path stay in the program as custom operators, one
node a call: K1 `step::nms_surface` (`inference.py`) and K2
`step::tube_roi_align` (`ops/roi_align.py`) and every max pool, K5
`step::max_pool3x3_same` and the strided `step::max_pool3d_same`
(`ops/pool.py`), in every program; in the kernel configuration also K3
`step::conv3x3x3_bn_relu` (`ops/conv3d.py`) and K4 `step::scale_bias_relu`
(`ops/fused_bn_relu.py`). Each node launches its kernel when the program
runs on the card (and counts the launch, `ops/kernel_op.py::LAUNCHES`) and
the plain version on the CPU. The program is an `ExportedProgram` that a Python
process loads after importing those operators (`load_detect_fn` does);
the kernels are a ctypes library with no PyTorch headers, so no
ahead-of-time compiled package can link them.
`torch.export` records the device of every tensor the program makes, so a
program runs on the device it was exported on, and the format is that of
the installation that wrote it: export and serve in the same one.

The kernel configuration is the unfolded tree with `cfg.fused_bn_relu`
(BN folding wins over it, so not `bn_folded`), read at trace time: the
program keeps the choice. K3's weight layout (`ops/conv3d.py::kernel_weight`) is
made from the weight input inside the program on every request, so the
weights stay an input; eager serving keeps it cached per unit.

Usage:
    blob = export_detect_fn(cfg, batch_size=8)            # bytes, on the card
    Path("detect.pt2").write_bytes(blob)
    # serving side:
    run = load_detect_fn("detect.pt2")
    out = run(serving_weights(model.state_dict(), cfg, "cuda"), rgb, proposals, prop_mask)
"""

from __future__ import annotations

import io
import os

import torch

from step_tpu_torch.config import StepConfig


def _detect_arg_specs(cfg: StepConfig, batch_size: int):
    """(shape, dtype) of the program's rgb, proposals and prop_mask. The
    primary input has 3 channels for an RGB detector and 2 for a
    flow-stream one; its wire dtype follows `cfg.uint8_transfer`: uint8
    RGB or int8 flow, normalized on the device inside the program, as the
    loaders send them, or float32 when the flag is off."""
    T, S, P = cfg.total_frames, cfg.image_size, cfg.max_proposals
    c_in = 3 if cfg.input_stream == "rgb" else 2
    if cfg.uint8_transfer:
        in_dtype = torch.uint8 if cfg.input_stream == "rgb" else torch.int8
    else:
        in_dtype = torch.float32
    return (((batch_size, T, S, S, c_in), in_dtype),
            ((batch_size, P, T, 4), torch.float32),
            ((batch_size, P), torch.float32))


def serving_weights(state_dict, cfg: StepConfig, device) -> dict:
    """A model's state_dict as the program takes it: on `device`, keys
    sorted, and in `cfg.compute_dtype` when the config is BN-folded (the
    `--optimized` tree, which `cli.test` serves in its compute dtype), as
    the model holds them otherwise."""
    dtype = getattr(torch, cfg.compute_dtype) if cfg.bn_folded else None
    return {k: v.to(device=device, dtype=dtype if v.is_floating_point() else None)
            for k, v in sorted(state_dict.items())}


class DetectProgram(torch.nn.Module):
    """`detect_clip` as a module whose weights are an input:
    `forward(state_dict, rgb, proposals, prop_mask)` → the detections
    dict. The model is held outside the module's own state, so that
    `torch.export` lifts none of its tensors into the program."""

    def __init__(self, model):
        super().__init__()
        self.__dict__["model"] = model          # not a submodule

    def forward(self, state_dict, rgb, proposals, prop_mask):
        from step_tpu_torch.inference import _detections

        outputs = torch.func.functional_call(self.model, state_dict, (rgb, proposals))
        return _detections(outputs, prop_mask, self.model.cfg)


def export_detect_fn(cfg: StepConfig, batch_size: int, state_dict=None,
                     model=None, device="cuda") -> bytes:
    """Trace the detect program of `cfg` at `batch_size` on `device` and
    serialize it (`torch.export.save`) → bytes.

    `state_dict` gives the weights' structure only (names, shapes,
    dtypes): their values are not in the program. Without it the weights
    of `model` (or of a new `STEPDetector(cfg)`) are used, through
    `serving_weights`.
    """
    from step_tpu_torch.models.detector import STEPDetector

    if cfg.two_stream:
        raise ValueError(
            "export_detect_fn supports single-stream detectors only "
            "(input_stream='rgb' or 'flow'); two_stream=True programs take "
            "a second flow input — export each stream separately and fuse "
            "scores at serving time (detect_clip_late_fusion protocol)."
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("export_detect_fn traces on a CUDA card and none is "
                           "available; pass device='cpu' to export for the CPU")
    model = (model or STEPDetector(cfg)).eval()
    if state_dict is None:
        state_dict = serving_weights(model.state_dict(), cfg, device)
    weights = {k: torch.empty_like(v, device=device) for k, v in sorted(state_dict.items())}
    example = [torch.zeros(shape, dtype=dtype, device=device)
               for shape, dtype in _detect_arg_specs(cfg, batch_size)]
    with torch.no_grad():
        program = torch.export.export(DetectProgram(model), (weights, *example),
                                      strict=False)
    # Neither the example inputs (the weights among them) nor the tracing
    # host's source lines go into the artifact.
    program.example_inputs = None
    for node in program.graph.nodes:
        node.meta.pop("stack_trace", None)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def load_program(blob):
    """bytes, a path, or an ExportedProgram → ExportedProgram (the
    operators of the program registered first). A serving process that
    reads both the program's callable and its input specs loads it once
    here and hands the ExportedProgram to both."""
    import step_tpu_torch.inference  # noqa: F401  (step::nms_surface)
    import step_tpu_torch.ops.conv3d  # noqa: F401  (step::conv3x3x3_bn_relu)
    import step_tpu_torch.ops.fused_bn_relu  # noqa: F401  (step::scale_bias_relu)
    import step_tpu_torch.ops.pool  # noqa: F401  (step::max_pool3x3_same, max_pool3d_same)
    import step_tpu_torch.ops.roi_align  # noqa: F401  (step::tube_roi_align)

    if isinstance(blob, torch.export.ExportedProgram):
        return blob
    if isinstance(blob, (bytes, bytearray)):
        return torch.export.load(io.BytesIO(blob))
    return torch.export.load(os.fspath(blob))


def load_detect_fn(blob_or_path):
    """An exported detect program (bytes, a path or an ExportedProgram) →
    a callable `(state_dict, rgb, proposals, prop_mask) → detections dict`.
    The state_dict is the model's as `serving_weights` gives it, keys
    sorted, as the program was traced with them."""
    module = load_program(blob_or_path).module()

    def run(state_dict, rgb, proposals, prop_mask):
        with torch.no_grad():
            return module(state_dict, rgb, proposals, prop_mask)

    return run


def detect_fn_input_specs(blob_or_path):
    """The (rgb, proposals, prop_mask) inputs of an exported detect program
    as (shape, dtype) pairs. The wire dtype is frozen into the artifact at
    export time (`_detect_arg_specs` follows cfg.uint8_transfer), so a
    serving process can check its config's wire format against it before
    the first batch."""
    inputs = [node.meta["val"] for node in load_program(blob_or_path).graph.nodes
              if node.op == "placeholder"][-3:]
    return tuple((tuple(v.shape), v.dtype) for v in inputs)


def program_op_counts(blob_or_path) -> dict:
    """How many nodes of the program call each `step::` operator."""
    counts: dict = {}
    for node in load_program(blob_or_path).graph.nodes:
        name = str(node.target) if node.op == "call_function" else ""
        if name.startswith("step."):
            key = name.split(".")[1]
            counts[key] = counts.get(key, 0) + 1
    return counts
