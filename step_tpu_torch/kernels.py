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

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("nms.cu", "roi_align.cu", "pool3d.cu", "bn_relu.cu", "conv3d.cu",
           "errors.cu")
HEADERS = ("wgmma.cuh",)
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
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
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
    """The loaded kernel library, built first if needed."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.step_nms_many.argtypes = [p, p, p, p, i, i, i, f, p]
    lib.step_nms_many.restype = i
    lib.step_tube_roi_align.argtypes = [p, p, p, i, i, i, i, i, i, i, i, i, f, i, p]
    lib.step_tube_roi_align.restype = i
    lib.step_max_pool3x3.argtypes = [p, p, i, i, i, i, i, i, p]
    lib.step_max_pool3x3.restype = i
    lib.step_scale_bias_relu.argtypes = [p, p, p, p, i, ctypes.c_int64, i, p]
    lib.step_scale_bias_relu.restype = i
    lib.step_conv3x3x3_bn_relu_f32.argtypes = [p, p, p, p, p, i, i, i, i, i, i, p]
    lib.step_conv3x3x3_bn_relu_f32.restype = i
    lib.step_conv3x3x3_bn_relu_bf16.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, i, i, i, p]
    lib.step_conv3x3x3_bn_relu_bf16.restype = i
    lib.step_cuda_error_string.argtypes = [i]
    lib.step_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
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


def nms_many_forward(live: torch.Tensor, boxes: torch.Tensor,
                     keep_idx: torch.Tensor, keep_mask: torch.Tensor,
                     iou_threshold: float) -> None:
    """Launch `csrc/nms.cu` on pre-masked live scores `[N, P]` f32 and boxes
    `[N, P, 4]` f32, writing keep_idx `[N, K]` int32 and keep_mask f32."""
    _need_cuda(live, "nms")
    dev = live.device
    N, P = live.shape
    K = keep_idx.shape[1]
    if not 1 <= P <= 32:
        raise ValueError(f"nms kernel takes 1..32 boxes per problem, got {P}")
    _check(live, "live", torch.float32, (N, P), dev)
    _check(boxes, "boxes", torch.float32, (N, P, 4), dev)
    _check(keep_idx, "keep_idx", torch.int32, (N, K), dev)
    _check(keep_mask, "keep_mask", torch.float32, (N, K), dev)
    lib = library()
    with torch.cuda.device(dev):
        err = lib.step_nms_many(live.data_ptr(), boxes.data_ptr(),
                                keep_idx.data_ptr(), keep_mask.data_ptr(),
                                N, P, K, iou_threshold, _stream(dev))
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
    ever reads strided memory."""
    if x.dim() != 5:
        raise ValueError(f"expected an NCDHW tensor, got shape {tuple(x.shape)}")
    view = x.permute(0, 2, 3, 4, 1)
    if not view.is_contiguous():
        view = x.contiguous(memory_format=torch.channels_last_3d).permute(0, 2, 3, 4, 1)
    return view


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


def conv_packed_shape(C: int, K: int) -> tuple[int, int, int]:
    """(Kw, Rpad, Cpad) of the packed bf16 conv weight: C rounded up to 8,
    the reduction 27 * Cpad rounded up to CONV_TILE_K, K up to its tile."""
    cpad = -(-C // 8) * 8
    rpad = -(-27 * cpad // CONV_TILE_K) * CONV_TILE_K
    bn = conv_tile_n(K)
    return -(-K // bn) * bn, rpad, cpad


def conv3x3x3_bn_relu_forward(x: torch.Tensor, w: torch.Tensor,
                              scale: torch.Tensor, bias: torch.Tensor,
                              out: torch.Tensor, warpgroups: int = 0) -> None:
    """Launch `csrc/conv3d.cu`: x `[N, T, H, W, C]` and out
    `[N, T, H, W, K]` in one dtype, scale and bias `[K]` f32. In float32 w
    is tap-major `[27, C, K]` (the CUDA-core kernel); in bfloat16 it is the
    packed `[Kw, Rpad]` matrix of `ops/conv3d.py::pack_conv3x3x3_weight`
    (the tensor-core kernel), whose block the launcher picks from the shape
    unless `warpgroups` forces one (2, or the widest for the tile width;
    `conv_tune.py` compares them)."""
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
    lib = library()
    if x.dtype == torch.float32:
        _check(w, "w", x.dtype, (27, C, K), dev)
        with torch.cuda.device(dev):
            err = lib.step_conv3x3x3_bn_relu_f32(
                x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                out.data_ptr(), N, T, H, W, C, K, _stream(dev))
    else:
        kw, rpad, cpad = conv_packed_shape(C, K)
        _check(w, "w", x.dtype, (kw, rpad), dev)
        with torch.cuda.device(dev):
            err = lib.step_conv3x3x3_bn_relu_bf16(
                x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                out.data_ptr(), N, T, H, W, C, K, cpad, rpad, conv_tile_n(K),
                int(warpgroups), _stream(dev))
    _raise_on(err, "conv3x3x3_bn_relu kernel launch")
