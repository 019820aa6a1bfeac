"""Build and bind the CUDA kernels in `csrc/`.

The sources are compiled by `nvcc` for Hopper (`sm_90a`) into one shared
library with a plain C interface, loaded with ctypes (no PyTorch headers in
the build, so it takes seconds). The build runs on first use and lands in
`_build/` beside this file, named by a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.

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
SOURCES = ("nms.cu", "roi_align.cu", "errors.cu")
# -fmad=false: the NMS kernel must equal its plain version bit for bit, so
# no multiply-add may be contracted into an FMA. -Xptxas -v prints each
# kernel's registers and spills into the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
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
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libstep_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the sources if no library for them exists yet.

    Returns (library path, compiler log; empty when nothing was built).
    Raises with the compiler's output if nvcc fails. Concurrent builders
    each write a private temporary file and rename it into place.
    """
    target = library_path()
    if target.exists():
        return target, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               *(str(CSRC / name) for name in SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return target, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.step_nms_many.argtypes = [p, p, p, p, i, i, i, f, p]
    lib.step_nms_many.restype = i
    lib.step_tube_roi_align.argtypes = [p, p, p, i, i, i, i, i, i, i, i, f, i, p]
    lib.step_tube_roi_align.restype = i
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


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        text = library().step_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({text})")


def nms_many_forward(live: torch.Tensor, boxes: torch.Tensor,
                     keep_idx: torch.Tensor, keep_mask: torch.Tensor,
                     iou_threshold: float) -> None:
    """Launch `csrc/nms.cu` on pre-masked live scores `[N, P]` f32 and boxes
    `[N, P, 4]` f32, writing keep_idx `[N, K]` int32 and keep_mask f32."""
    dev = live.device
    if dev.type != "cuda":
        raise ValueError(f"nms kernel needs CUDA tensors, got {dev}")
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
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.step_nms_many(live.data_ptr(), boxes.data_ptr(),
                                keep_idx.data_ptr(), keep_mask.data_ptr(),
                                N, P, K, iou_threshold, stream)
    _raise_on(err, "nms kernel launch")


def tube_roi_align_forward(features: torch.Tensor, boxes: torch.Tensor,
                           out: torch.Tensor, spatial_scale: float,
                           sampling_ratio: int) -> None:
    """Launch `csrc/roi_align.cu`: features `[B, T', H, W, C]` (f32 or
    bf16), per-slice boxes `[B, N, T', 4]` f32, out
    `[B, N, T', pooled, pooled, C]` in the feature dtype."""
    dev = features.device
    if dev.type != "cuda":
        raise ValueError(f"roi_align kernel needs CUDA tensors, got {dev}")
    if sampling_ratio <= 0:
        raise ValueError("roi_align kernel: adaptive sampling "
                         "(sampling_ratio <= 0) is not implemented")
    B, Tp, H, W, C = features.shape
    N, pooled = boxes.shape[1], out.shape[3]
    _check(features, "features", tuple(_DTYPE_CODE), (B, Tp, H, W, C), dev)
    _check(boxes, "boxes", torch.float32, (B, N, Tp, 4), dev)
    _check(out, "out", features.dtype, (B, N, Tp, pooled, pooled, C), dev)
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.step_tube_roi_align(
            features.data_ptr(), boxes.data_ptr(), out.data_ptr(),
            _DTYPE_CODE[features.dtype], B, N, Tp, H, W, C, pooled,
            float(spatial_scale), int(sampling_ratio), stream)
    _raise_on(err, "roi_align kernel launch")
