"""Build and bind the CUDA kernels in `csrc/`.

The sources are compiled by `nvcc` for Hopper (`sm_90a`), one process per
source, all at once, and linked into one shared library with a plain C
interface, loaded with ctypes (no PyTorch headers in the build, so it takes
seconds). The build runs on first use and lands in `_build/` beside this
file, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is.

Nothing here runs at import: the CPU tests import this module on machines
with no `nvcc` and no card.

The launchers below check device, dtype, shape and contiguity, launch on
the current stream of the tensors' device, and raise if the launch is
refused. Outputs are allocated by the callers (`ops/`), with `torch.empty`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from step_tpu_torch.utils.spans import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("nms.cu", "roi_align.cu", "pool3d.cu", "pool3d_same.cu", "bn_relu.cu",
           "conv3d.cu", "gemm.cu", "stem_conv.cu", "attn_pool.cu", "errors.cu")
HEADERS = ("igemm.cuh", "wgmma.cuh", "sm_count.cuh", "max_merge.cuh")
# -fmad=false: the NMS kernel must equal its plain version bit for bit, so
# no multiply-add may be contracted into an FMA (the float32 conv and the
# ROI-align kernels ask for their FMAs explicitly, with fmaf). -Xptxas -v
# prints each kernel's registers and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-Xcompiler", "-fPIC")
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def nvcc_path() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, /usr/local/cuda/bin/nvcc, or
    `nvcc` on PATH."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def library_path() -> Path:
    """Where the library built from the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libstep_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the sources if no library for them exists yet.

    Returns (library path, compiler log; empty when nothing was built).
    Raises with the compiler's output if nvcc fails. Each source compiles
    in its own nvcc process, all started together; concurrent builders
    each work in a private temporary directory and rename the library into
    place.
    """
    target = library_path()
    if target.exists():
        return target, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    log = []
    with span("setup.kernels.build"), tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for name in SOURCES:
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(Path(tmp) / f"{name}.o"),
                   str(CSRC / name)]
            jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT,
                                               text=True)))
        failed = []
        for cmd, proc in jobs:
            out, _ = proc.communicate()
            log.append(out)
            if proc.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        lib = Path(tmp) / target.name
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib),
               *(str(Path(tmp) / f"{name}.o") for name in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(lib, target)
    return target, "".join(log)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed, inside the span
    `setup.kernels` (`build()`'s compile inside `setup.kernels.build`)."""
    with span("setup.kernels"):
        return _load()


def _load() -> ctypes.CDLL:
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    ll = ctypes.c_longlong
    lib.step_nms.argtypes = [p] * 7 + [i] * 7 + [ll] * 10 + [f, f, p]
    lib.step_nms.restype = i
    lib.step_tube_roi_align.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, f, i, p]
    lib.step_tube_roi_align.restype = i
    lib.step_max_pool3x3.argtypes = [p, p, i, i, i, i, i, i, p]
    lib.step_max_pool3x3.restype = i
    lib.step_max_pool3d_same.argtypes = [p, p] + [i] * 12 + [p]
    lib.step_max_pool3d_same.restype = i
    lib.step_scale_bias_relu.argtypes = [p, p, p, p, i, ctypes.c_int64, i, p]
    lib.step_scale_bias_relu.restype = i
    lib.step_conv3x3x3_bn_relu_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.step_conv3x3x3_bn_relu_f32.restype = i
    for taps in IGEMM_TAPS.values():
        fn = getattr(lib, taps)
        fn.argtypes = [p, i, p, p, p, p, i, p, i] + [i] * 11 + [p]
        fn.restype = i
    lib.step_conv3x3x3_tube_bf16.argtypes = [p, i, p, p, p, i, i, i, i, i, i, p]
    lib.step_conv3x3x3_tube_bf16.restype = i
    lib.step_stem_conv.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.step_stem_conv.restype = i
    lib.step_attn_pool.argtypes = [p, ll, ll, p, p, p, i, f, p, i, i, i, i, i, i, p]
    lib.step_attn_pool.restype = i
    lib.step_cuda_error_string.argtypes = [i]
    lib.step_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device,
           contiguous: bool = True) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _need_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {t.device}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        text = library().step_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")


# The most boxes a problem may have: csrc/nms.cu keeps a group's P x P
# suppression bits in shared memory (128 KiB at 1024) and a box in 10 bits
# of its keys.
NMS_MAX_BOXES = 1024
_VALID_CODE = {torch.float32: 1, torch.bool: 2}


def nms_many_forward(boxes: torch.Tensor, scores: torch.Tensor,
                     valid: torch.Tensor | None, keep_mask: torch.Tensor,
                     iou_threshold: float, score_threshold: float,
                     keep_idx: torch.Tensor | None = None,
                     out_boxes: torch.Tensor | None = None,
                     out_scores: torch.Tensor | None = None) -> None:
    """Launch `csrc/nms.cu` on G1 x G2 groups of P boxes, each group scored
    by C rows: boxes `[G1, G2, P, 4]` f32 (coordinates contiguous), scores
    `[G1, G2, P, C]` f32 or bf16, valid `[G1, G2, P]` f32 or bool, or None.
    The inputs may have any strides, so an expanded view costs nothing. The
    kernel pre-masks the scores as `ops/nms.py::premask_scores` does, and
    writes K slots per (group, row) into contiguous outputs: keep_mask
    `[G1, G2, C, K]` f32 and, where given, keep_idx int32, out_boxes
    `[G1, G2, C, K, 4]` f32 (the kept boxes) and out_scores f32 (the kept
    box's score times the mask)."""
    _need_cuda(boxes, "nms")
    dev = boxes.device
    if boxes.dim() != 4 or scores.dim() != 4 or keep_mask.dim() != 4:
        raise ValueError(f"boxes {tuple(boxes.shape)}, scores {tuple(scores.shape)}, "
                         f"keep_mask {tuple(keep_mask.shape)}: expected [G1, G2, P, 4], "
                         "[G1, G2, P, C] and [G1, G2, C, K]")
    G1, G2, P = boxes.shape[:3]
    C, K = scores.shape[3], keep_mask.shape[3]
    if not 1 <= P <= NMS_MAX_BOXES:
        raise ValueError(f"nms kernel takes 1 to NMS_MAX_BOXES = {NMS_MAX_BOXES} boxes "
                         f"per problem (a group's P x P suppression bits live in "
                         f"shared memory), got {P}")
    _check(boxes, "boxes", torch.float32, (G1, G2, P, 4), dev, contiguous=False)
    if boxes.stride(3) != 1:
        raise ValueError("boxes: the 4 coordinates of a box are not contiguous")
    _check(scores, "scores", tuple(_DTYPE_CODE), (G1, G2, P, C), dev, contiguous=False)
    if valid is not None:
        _check(valid, "valid", tuple(_VALID_CODE), (G1, G2, P), dev, contiguous=False)
    _check(keep_mask, "keep_mask", torch.float32, (G1, G2, C, K), dev)
    for name, t, dtype, shape in (("keep_idx", keep_idx, torch.int32, (G1, G2, C, K)),
                                  ("out_boxes", out_boxes, torch.float32,
                                   (G1, G2, C, K, 4)),
                                  ("out_scores", out_scores, torch.float32,
                                   (G1, G2, C, K))):
        if t is not None:
            _check(t, name, dtype, shape, dev)
    if out_boxes is not None and out_boxes.data_ptr() % 16:
        raise ValueError("out_boxes is not 16-byte aligned")
    if keep_mask.numel() == 0:
        return
    ptr =lambda t: None if t is None else t.data_ptr()  # noqa: E731
    vs = (0, 0, 0) if valid is None else valid.stride()
    lib = library()
    with torch.cuda.device(dev):
        err = lib.step_nms(
            boxes.data_ptr(), scores.data_ptr(), ptr(valid), ptr(keep_idx),
            keep_mask.data_ptr(), ptr(out_boxes), ptr(out_scores),
            _DTYPE_CODE[scores.dtype], 0 if valid is None else _VALID_CODE[valid.dtype],
            G1 * G2, G2, P, C, K, *boxes.stride()[:3], *scores.stride(), *vs,
            iou_threshold, score_threshold, _stream(dev))
    _raise_on(err, "nms kernel launch")


def tube_roi_align_forward(features: torch.Tensor, tubes: torch.Tensor,
                           out: torch.Tensor, spatial_scale: float,
                           sampling_ratio: int) -> None:
    """Launch `csrc/roi_align.cu`: features `[B, T', H, W, C]` (f32 or
    bf16), tubes `[B, N, T, 4]` f32 (slice t' pools the boxes of frame
    `ops/roi_align.py::feature_time_indices(T, T')[t']`), out
    `[B, N, T', pooled, pooled, C]` in the feature dtype. `sampling_ratio
    <= 0` is the adaptive branch."""
    _need_cuda(features, "roi_align")
    dev = features.device
    B, Tp, H, W, C = features.shape
    N, T, pooled = tubes.shape[1], tubes.shape[2], out.shape[3]
    _check(features, "features", tuple(_DTYPE_CODE), (B, Tp, H, W, C), dev)
    _check(tubes, "tubes", torch.float32, (B, N, T, 4), dev)
    _check(out, "out", features.dtype, (B, N, Tp, pooled, pooled, C), dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.step_tube_roi_align(
            features.data_ptr(), tubes.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[features.dtype], B, N, T, Tp, H, W, C, pooled,
            float(spatial_scale), int(sampling_ratio), _stream(dev))
    _raise_on(err, "roi_align kernel launch")


def ndhwc(x: torch.Tensor) -> torch.Tensor:
    """The contiguous channels-last `[N, T, H, W, C]` view of an NCDHW
    tensor, which is what the backbone kernels read. The backbone keeps its
    tensors in `channels_last_3d` order, where this is a free permute; a
    tensor in another order is first copied into it, explicitly
    (`x.contiguous(memory_format=torch.channels_last_3d)`), so no kernel
    ever reads strided memory. `ndhwc.copies` counts those copies."""
    if x.dim() != 5:
        raise ValueError(f"expected an NCDHW tensor, got shape {tuple(x.shape)}")
    view = x.permute(0, 2, 3, 4, 1)
    if not view.is_contiguous():
        view = x.contiguous(memory_format=torch.channels_last_3d).permute(0, 2, 3, 4, 1)
        ndhwc.copies += 1
    return view


ndhwc.copies = 0


def empty_ncdhw(shape, like: torch.Tensor) -> torch.Tensor:
    """An uninitialized NCDHW tensor in `channels_last_3d` order, with
    `like`'s dtype and device."""
    return torch.empty(shape, dtype=like.dtype, device=like.device,
                       memory_format=torch.channels_last_3d)


def max_pool3x3_forward(x: torch.Tensor, out: torch.Tensor) -> None:
    """Launch `csrc/pool3d.cu`: x and out `[N, T, H, W, C]`, f32 or bf16."""
    _need_cuda(x, "max_pool3x3")
    dev = x.device
    if x.dim() != 5:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected [N, T, H, W, C]")
    _check(x, "x", tuple(_DTYPE_CODE), x.shape, dev)
    _check(out, "out", x.dtype, x.shape, dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.step_max_pool3x3(x.data_ptr(), out.data_ptr(),
                                   _DTYPE_CODE[x.dtype], *x.shape, _stream(dev))
    _raise_on(err, "max_pool3x3 kernel launch")


def max_pool3d_same_contract(window, stride) -> tuple[tuple, tuple]:
    """(window, stride) as int tuples if `csrc/pool3d_same.cu` takes them
    (three axes, each window 1 to 3, each stride 1 or 2); else ValueError."""
    window, stride = tuple(int(k) for k in window), tuple(int(s) for s in stride)
    if len(window) != 3 or len(stride) != 3 or not (
            all(1 <= k <= 3 for k in window) and all(1 <= s <= 2 for s in stride)):
        raise ValueError(f"max_pool3d_same kernel takes windows of 1 to 3 and strides of "
                         f"1 or 2 on each axis, got window {window}, stride {stride}")
    return window, stride


def max_pool3d_same_forward(x: torch.Tensor, out: torch.Tensor, window, stride) -> None:
    """Launch `csrc/pool3d_same.cu`: x `[N, T, H, W, C]` and out `[N,
    ceil(T/st), ceil(H/sh), ceil(W/sw), C]`, f32 or bf16; `window` and
    `stride` (t, h, w), each window 1 to 3 and each stride 1 or 2; TF-SAME
    padding of -inf."""
    _need_cuda(x, "max_pool3d_same")
    dev = x.device
    if x.dim() != 5:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected [N, T, H, W, C]")
    window, stride = max_pool3d_same_contract(window, stride)
    N, T, H, W, C = x.shape
    shape = (N, *(-(-n // s) for n, s in zip((T, H, W), stride)), C)
    _check(x, "x", tuple(_DTYPE_CODE), x.shape, dev)
    _check(out, "out", x.dtype, shape, dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.step_max_pool3d_same(x.data_ptr(), out.data_ptr(), _DTYPE_CODE[x.dtype],
                                       *x.shape, *window, *stride, _stream(dev))
    _raise_on(err, "max_pool3d_same kernel launch")


def scale_bias_relu_forward(x: torch.Tensor, scale: torch.Tensor,
                            bias: torch.Tensor, out: torch.Tensor) -> None:
    """Launch `csrc/bn_relu.cu`: x and out `[rows, C]` (f32 or bf16),
    scale and bias `[C]` f32."""
    _need_cuda(x, "scale_bias_relu")
    dev = x.device
    if x.dim() != 2:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected [rows, C]")
    rows, C = x.shape
    _check(x, "x", tuple(_DTYPE_CODE), (rows, C), dev)
    _check(scale, "scale", torch.float32, (C,), dev)
    _check(bias, "bias", torch.float32, (C,), dev)
    _check(out, "out", x.dtype, (rows, C), dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.step_scale_bias_relu(x.data_ptr(), scale.data_ptr(),
                                       bias.data_ptr(), out.data_ptr(),
                                       _DTYPE_CODE[x.dtype], rows, C, _stream(dev))
    _raise_on(err, "scale_bias_relu kernel launch")


# The bf16 conv kernel's tiles (csrc/conv3d.cu): 64 reduction elements per
# chunk, and the output-channel tile widths it is built for (csrc/wgmma.cuh).
CONV_TILE_K = 64
CONV_TILE_N = (32, 48, 64, 96, 128, 144, 160, 192, 208, 224, 256)


def conv_tile_n(K: int) -> int:
    """The bf16 conv kernel's output-channel tile for K channels: the
    widest tile that divides K (K itself up to 256: 192, 208, 224; else a
    divisor: 288 → 144, 320 → 160, 384 → 192), so no lane is wasted; for a
    K that no tile divides, the narrowest tile that holds it, or 128, with
    the ragged end masked."""
    exact = [n for n in CONV_TILE_N if K % n == 0]
    if exact:
        return max(exact)
    return min((n for n in CONV_TILE_N if n >= K), default=128)


def conv_packed_shape(C: int, K: int, taps: int = 27) -> tuple[int, int, int]:
    """(Kw, Rpad, Cpad) of the packed bf16 weight of a conv with `taps`
    taps (27 or 1): C rounded up to 8, the reduction taps * Cpad rounded up
    to CONV_TILE_K, K up to its tile."""
    cpad = -(-C // 8) * 8
    rpad = -(-taps * cpad // CONV_TILE_K) * CONV_TILE_K
    bn = conv_tile_n(K)
    return -(-K // bn) * bn, rpad, cpad


def conv3x3x3_bn_relu_forward(x: torch.Tensor, w: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor,
                              out: torch.Tensor, warpgroups: int = 0) -> None:
    """Launch `csrc/conv3d.cu`: x `[N, T, H, W, C]` and out
    `[N, T, H, W, K]` in one dtype, scale and bias `[K]` f32. In float32 w
    is tap-major `[27, C, K]` (the CUDA-core kernel); in bfloat16 it is the
    packed `[Kw, Rpad]` matrix of `ops/conv3d.py::pack_conv_weight` (the
    tensor-core kernel, `igemm_forward`), whose block the launcher picks
    from the shape unless `warpgroups` forces one (2, or the widest for the
    tile width)."""
    _need_cuda(x, "conv3x3x3_bn_relu")
    dev = x.device
    if x.dim() != 5 or w.dim() not in (2, 3) or out.dim() != 5:
        raise ValueError(f"x {tuple(x.shape)}, w {tuple(w.shape)}, out "
                         f"{tuple(out.shape)}: expected [N, T, H, W, C], a "
                         "weight and [N, T, H, W, K]")
    N, T, H, W, C = x.shape
    K = out.shape[4]
    if C < 1:
        raise ValueError("conv3x3x3_bn_relu kernel needs at least one input channel")
    _check(x, "x", tuple(_DTYPE_CODE), (N, T, H, W, C), dev)
    _check(scale, "scale", torch.float32, (K,), dev)
    _check(bias, "bias", torch.float32, (K,), dev)
    _check(out, "out", x.dtype, (N, T, H, W, K), dev)
    if x.dtype == torch.bfloat16:
        igemm_forward(x, w, scale, bias, (out,), 27, warpgroups)
        return
    _check(w, "w", x.dtype, (27, C, K), dev)
    with torch.cuda.device(dev):
        err = library().step_conv3x3x3_bn_relu_f32(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
            out.data_ptr(), N, T, H, W, C, K, _stream(dev))
    _raise_on(err, "conv3x3x3_bn_relu kernel launch")


# The C entries of the bf16 implicit GEMM (csrc/igemm.cuh) by taps: the
# 3x3x3 conv (csrc/conv3d.cu) and the 1x1x1 conv (csrc/gemm.cu).
IGEMM_TAPS = {27: "step_conv3x3x3_bf16", 1: "step_conv1x1x1_bf16"}


def row_stride(t: torch.Tensor, name: str) -> int:
    """The row stride, in elements, of a channels-last `[N, T, H, W, C]`
    view whose positions are evenly strided rows of contiguous channels: a
    dense tensor (stride C) or a channel slice of a wider one. Else
    ValueError."""
    if t.dim() != 5 or t.stride(4) != 1:
        raise ValueError(f"{name}: expected [N, T, H, W, C] with contiguous channels, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")
    ld, span = t.stride(3), 1
    for d in (3, 2, 1, 0):
        if t.shape[d] > 1 and t.stride(d) != span * ld:
            raise ValueError(f"{name}: positions of shape {tuple(t.shape)} are not evenly "
                             f"strided rows (strides {t.stride()})")
        span *= t.shape[d]
    return ld


def igemm_forward(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None,
                  bias: torch.Tensor, outs, taps: int, warpgroups: int = 0) -> None:
    """Launch the bf16 tensor-core implicit GEMM (`csrc/igemm.cuh`) of a
    stride-1 SAME conv with `taps` taps, 27 (3x3x3, `csrc/conv3d.cu`) or 1
    (1x1x1, `csrc/gemm.cu`), with the affine or bias and the ReLU in its
    epilogue: x `[N, T, H, W, C]` bf16 rows (`row_stride`: a channel slice
    is read in place), w the packed `[Kw, Rpad]` weight of
    `ops/conv3d.py::pack_conv_weight`, scale `[K]` f32 or None (1), bias
    `[K]` f32; `outs` one or two bf16 `[N, T, H, W, k_i]` row views (each may
    be a channel slice of a wider tensor) whose columns, concatenated, are
    the K output channels. The 1x1x1 conv takes C a multiple of 8 and x
    16-byte aligned."""
    _need_cuda(x, "igemm")
    dev = x.device
    if taps not in IGEMM_TAPS or not 1 <= len(outs) <= 2:
        raise ValueError(f"igemm: taps {taps} (1 or 27), {len(outs)} outputs (1 or 2)")
    N, T, H, W, C = x.shape
    ldx = row_stride(x, "x")
    lds = [row_stride(o, f"out{i}") for i, o in enumerate(outs)]
    K = sum(o.shape[4] for o in outs)
    split = outs[0].shape[4]
    _check(x, "x", torch.bfloat16, x.shape, dev, contiguous=False)
    for i, o in enumerate(outs):
        _check(o, f"out{i}", torch.bfloat16, (N, T, H, W, o.shape[4]), dev, contiguous=False)
    if scale is not None:
        _check(scale, "scale", torch.float32, (K,), dev)
    _check(bias, "bias", torch.float32, (K,), dev)
    kw, rpad, cpad = conv_packed_shape(C, K, taps)
    _check(w, "w", torch.bfloat16, (kw, rpad), dev)
    if taps == 1 and (C % 8 or ldx % 8 or x.data_ptr() % 16):
        raise ValueError(f"igemm: the 1x1x1 conv takes C and the row stride in multiples "
                         f"of 8 and a 16-byte aligned x, got C {C}, row stride {ldx}")
    out1, ld1 = (outs[1].data_ptr(), lds[1]) if len(outs) == 2 else (None, 0)
    with torch.cuda.device(dev):
        err = getattr(library(), IGEMM_TAPS[taps])(
            x.data_ptr(), ldx, w.data_ptr(), None if scale is None else scale.data_ptr(),
            bias.data_ptr(), outs[0].data_ptr(), lds[0], out1, ld1, split,
            N, T, H, W, C, K, cpad, rpad, conv_tile_n(K), int(warpgroups), _stream(dev))
    _raise_on(err, f"igemm (taps {taps}) kernel launch")


# The tube conv (csrc/conv3d.cu::tube_conv_kernel): the heads' 3x3x3 convs
# over the 7x7 ROI grid, its output-channel tile widths (csrc/wgmma.cuh's
# WgmmaRS) and the channels of one reduction chunk.
TUBE_GRID = 7
TUBE_TILE_N = (64, 128, 160)
TUBE_CHUNK = 64


def tube_tile_n(K: int) -> int:
    """The tube conv's output-channel tile for K channels, chosen as
    `conv_tile_n` chooses among `TUBE_TILE_N` (320 → 160, 384 → 128)."""
    exact = [n for n in TUBE_TILE_N if K % n == 0]
    if exact:
        return max(exact)
    return min((n for n in TUBE_TILE_N if n >= K), default=128)


def tube_packed_shape(C: int, K: int) -> tuple[int, int, int, int]:
    """The tube conv's packed weight: [tiles, steps, tile width, 64], one
    step a (chunk of 64 channels, tap) pair, chunk-major."""
    bn = tube_tile_n(K)
    return -(-K // bn), 27 * -(-C // TUBE_CHUNK), bn, TUBE_CHUNK


def tube_conv_forward(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      out: torch.Tensor) -> None:
    """Launch the tube conv (`csrc/conv3d.cu::tube_conv_kernel`): the 3x3x3
    SAME conv of x `[N, T, 7, 7, C]` bf16 rows (`row_stride`: a channel
    slice is read in place; C a multiple of 8, x 16-byte aligned) with the
    tile-packed weight of `ops/conv3d.py::pack_tube_weight`, bias `[K]`
    f32, then the ReLU, into out `[N, T, 7, 7, K]` bf16 rows (a channel
    slice of a wider tensor or dense)."""
    _need_cuda(x, "tube_conv")
    dev = x.device
    N, T, H, W, C = x.shape
    K = out.shape[-1]
    if (H, W) != (TUBE_GRID, TUBE_GRID) or C % 8:
        raise ValueError(f"tube_conv takes [N, T, 7, 7, C] with C a multiple of 8, got "
                         f"{tuple(x.shape)}")
    ldx, ldo = row_stride(x, "x"), row_stride(out, "out")
    _check(x, "x", torch.bfloat16, x.shape, dev, contiguous=False)
    _check(out, "out", torch.bfloat16, (N, T, H, W, K), dev, contiguous=False)
    _check(bias, "bias", torch.float32, (K,), dev)
    _check(w, "w", torch.bfloat16, tube_packed_shape(C, K), dev)
    if ldx % 8 or x.data_ptr() % 16:
        raise ValueError(f"tube_conv: x's row stride {ldx} must be a multiple of 8 and x "
                         "16-byte aligned")
    with torch.cuda.device(dev):
        err = library().step_conv3x3x3_tube_bf16(
            x.data_ptr(), ldx, w.data_ptr(), bias.data_ptr(), out.data_ptr(), ldo, N, T, C, K,
            tube_tile_n(K), _stream(dev))
    _raise_on(err, "tube_conv kernel launch")


# The stem conv kernel (csrc/stem_conv.cu): input channels it takes, and its
# output channels, one wgmma width.
STEM_CHANNELS = (2, 3)
STEM_OUT = 64


def stem_packed_shape(C: int) -> tuple[int, int]:
    """(segment, Rpad) of the stem kernel's packed weight for C input
    channels: each of the 49 (dt, dh) row segments holds the 7 dw taps x C
    channels padded to a multiple of 8 (24 for C = 3, 16 for C = 2), and
    the 49 segments are padded to CONV_TILE_K."""
    seg = -(-7 * C // 8) * 8
    return seg, -(-49 * seg // CONV_TILE_K) * CONV_TILE_K


def stem_conv_shape(shape) -> tuple:
    """The `[N, ceil(T/2), ceil(H/2), ceil(W/2), 64]` output of the stem
    kernel for an `[N, T, H, W, C]` input."""
    N, T, H, W = shape[:4]
    return (N, -(-T // 2), -(-H // 2), -(-W // 2), STEM_OUT)


def stem_conv_forward(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor | None,
                      bias: torch.Tensor | None, out: torch.Tensor, relu: bool) -> None:
    """Launch `csrc/stem_conv.cu`: x `[N, T, H, W, C]` bf16 (C 2 or 3), w
    the packed `[64, Rpad]` bf16 weight of `ops/stem_conv.py::
    pack_stem_weight`, scale and bias `[64]` f32 or None (1 and 0), out
    `[N, ceil(T/2), ceil(H/2), ceil(W/2), 64]` bf16; the 7x7x7 stride-2
    TF-SAME convolution, then the scale, the bias and, with `relu`, the
    ReLU."""
    _need_cuda(x, "stem_conv")
    dev = x.device
    if x.dim() != 5 or x.shape[4] not in STEM_CHANNELS:
        raise ValueError(f"x has shape {tuple(x.shape)}, expected [N, T, H, W, C] with C "
                         f"in {STEM_CHANNELS}")
    C = x.shape[4]
    _check(x, "x", torch.bfloat16, x.shape, dev)
    _check(w, "w", torch.bfloat16, (STEM_OUT, stem_packed_shape(C)[1]), dev)
    for name, t in (("scale", scale), ("bias", bias)):
        if t is not None:
            _check(t, name, torch.float32, (STEM_OUT,), dev)
    _check(out, "out", torch.bfloat16, stem_conv_shape(x.shape), dev)
    if w.data_ptr() % 16 or out.data_ptr() % 4:
        raise ValueError("stem_conv: w must be 16-byte and out 4-byte aligned")
    lib = library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(dev):
        err = lib.step_stem_conv(x.data_ptr(), w.data_ptr(), ptr(scale), ptr(bias),
                                 out.data_ptr(), *x.shape, int(bool(relu)), _stream(dev))
    _raise_on(err, "stem_conv kernel launch")


# MViTv2's attention pools (csrc/attn_pool.cu): the channels of a head it
# takes, its spatial strides (the temporal stride is 1), its weights' dtypes.
ATTN_POOL_D = 96
ATTN_POOL_STRIDES = (1, 2, 4, 8)
_ATTN_POOL_WEIGHT_CODE = {torch.float32: 0, torch.bfloat16: 1}


def attn_pool_contract(qkv: torch.Tensor, part: int, heads: int, size, stride,
                       weight: torch.Tensor, norm_weight: torch.Tensor,
                       norm_bias: torch.Tensor) -> None:
    """Raise unless `csrc/attn_pool.cu` takes this pool: qkv a contiguous
    bf16 `[B, T·H·W, 3·dim_out]` (16-byte aligned) whose part `part` holds
    `heads` heads of d = 96, stride (1, s, s) with s in 1, 2, 4, 8, the
    weight `[96, 1, 3, 3, 3]` and the norm's weight and bias `[96]`, all
    three contiguous and all float32 or all bf16. Shapes and dtypes only, so
    it answers on any device."""
    if qkv.dtype != torch.bfloat16:
        raise ValueError(f"attn_pool takes bfloat16 activations, got {qkv.dtype}")
    T, H, W = size
    if qkv.dim() != 3 or qkv.shape[1] != T * H * W or qkv.shape[2] % 3:
        raise ValueError(f"attn_pool: qkv {tuple(qkv.shape)} is not [B, T·H·W, 3·dim_out] "
                         f"of the grid {tuple(size)}")
    if not 0 <= part < 3:
        raise ValueError(f"attn_pool: part {part} is not 0 (q), 1 (k) or 2 (v)")
    dim_out = qkv.shape[2] // 3
    if heads < 1 or dim_out != heads * ATTN_POOL_D:
        raise ValueError(f"attn_pool takes heads of d = {ATTN_POOL_D}: {dim_out} channels "
                         f"over {heads} heads")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("attn_pool reads qkv in place: it must be contiguous and "
                         "16-byte aligned")
    if len(stride) != 3 or stride[0] != 1 or stride[1] != stride[2] \
            or stride[1] not in ATTN_POOL_STRIDES:
        raise ValueError(f"attn_pool takes strides (1, s, s) for s in {ATTN_POOL_STRIDES}, "
                         f"got {tuple(stride)}")
    d = ATTN_POOL_D
    for name, t, shape in (("weight", weight, (d, 1, 3, 3, 3)), ("norm_weight", norm_weight, (d,)),
                           ("norm_bias", norm_bias, (d,))):
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"attn_pool: {name} {tuple(t.shape)} is not a contiguous {shape}")
        if t.dtype != weight.dtype or t.dtype not in _ATTN_POOL_WEIGHT_CODE:
            raise ValueError(f"attn_pool: the weight and the norm's weight and bias must be "
                             f"all float32 or all bfloat16, got {weight.dtype}, {norm_weight.dtype}, "
                             f"{norm_bias.dtype}")


def attn_pool_shape(qkv_shape, heads: int, size, stride) -> tuple:
    """`[B, heads, T·Ho·Wo, d]`: the pooled part's shape, each side
    `(n - 1) // s + 1` (a 3x3x3 window at padding 1)."""
    B, _, C = qkv_shape
    n = 1
    for side, s in zip(size, stride):
        n *= (side - 1) // s + 1
    return (B, heads, n, C // 3 // heads)


def attn_pool_forward(qkv: torch.Tensor, part: int, heads: int, size, stride,
                      weight: torch.Tensor, norm_weight: torch.Tensor, norm_bias: torch.Tensor,
                      eps: float, out: torch.Tensor) -> None:
    """Launch `csrc/attn_pool.cu` on the part `part` of qkv `[B, T·H·W,
    3·dim_out]` bf16 (`attn_pool_contract`): the depthwise 3x3x3 conv at
    padding 1 and `stride`, then the LayerNorm over d at `eps`, into out
    `[B, heads, T·Ho·Wo, 96]` bf16, contiguous."""
    _need_cuda(qkv, "attn_pool")
    dev = qkv.device
    attn_pool_contract(qkv, part, heads, size, stride, weight, norm_weight, norm_bias)
    for name, t in (("weight", weight), ("norm_weight", norm_weight), ("norm_bias", norm_bias)):
        _check(t, name, weight.dtype, t.shape, dev)
    _check(out, "out", torch.bfloat16, attn_pool_shape(qkv.shape, heads, size, stride), dev)
    if out.data_ptr() % 16:
        raise ValueError("attn_pool: out must be 16-byte aligned")
    B, _, C = qkv.shape
    with torch.cuda.device(dev):
        err = library().step_attn_pool(
            qkv.data_ptr(), C, part * (C // 3), weight.data_ptr(), norm_weight.data_ptr(),
            norm_bias.data_ptr(), _ATTN_POOL_WEIGHT_CODE[weight.dtype], float(eps),
            out.data_ptr(), B, heads, *size, stride[1], _stream(dev))
    _raise_on(err, "attn_pool kernel launch")
