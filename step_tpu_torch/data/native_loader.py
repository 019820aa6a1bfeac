"""ctypes binding of the native clip loader, `native/clip_loader.cc`.

The port's own wrapper of the JAX package's C++ loader
(`step_tpu/data/native_loader.py`): the source is compiled as it is, with
the flags of its CMake build (`-O3 -march=native -std=gnu++17`, linked
against libjpeg and pthreads), by the host's C++ compiler into
`step_tpu_torch/_build/`, on first use, under a name that hashes the source,
the flags and the host. `decode_clip(paths, size)` decodes, resizes and normalizes a
clip's JPEG frames on host threads → float32 `[T, size, size, 3]`.

Where the build fails (no compiler, no libjpeg headers) `native_available()`
is False and the UCF reader decodes with cv2, as the JAX package does; the
reader records which decoder ran (`UCFDataset.decoder`). Setting
`STEP_TPU_DISABLE_NATIVE=1` forces cv2: the two decoders' pixels are near
but not bit-identical.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from step_tpu_torch.data.pipeline import RGB_MEAN, RGB_STD

SOURCE = Path(__file__).resolve().parents[2] / "native" / "clip_loader.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
# The flags of native/CMakeLists.txt's Release build, so the library is the
# JAX package's bit for bit on the same compiler.
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=gnu++17", "-shared")
LIBS = ("-ljpeg", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def library_path() -> Path:
    """Where the library built from the current source and flags lives, on
    this host: `-march=native` code may not run on another machine's CPU,
    so a checkout copied between machines builds its own."""
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS + (platform.node(),
                                                    platform.machine())).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libstep_clip_loader_{h.hexdigest()[:16]}.so"


def _build(path: Path) -> bool:
    """Compile the loader into `path` (through a temporary file renamed into
    place, so a concurrent process never loads a half-written library)."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not SOURCE.is_file():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp, *LIBS],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
        return True
    except (subprocess.SubprocessError, OSError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None if it cannot be built
    or loaded."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        path = library_path() if SOURCE.is_file() else None
        if path is None or (not path.exists() and not _build(path)):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            _build_failed = True
            return None
        lib.stpu_decode_clip.restype = ctypes.c_int
        lib.stpu_decode_clip.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ]
        lib.stpu_version.restype = ctypes.c_int
        lib.stpu_version.argtypes = []
        _lib = lib
        return _lib


def native_available() -> bool:
    if os.environ.get("STEP_TPU_DISABLE_NATIVE"):
        return False
    return get_lib() is not None


def decode_clip(paths: Sequence[str], size: int, mean: np.ndarray = RGB_MEAN,
                std: np.ndarray = RGB_STD, n_threads: int = 4) -> np.ndarray:
    """Decode, resize to `size` x `size` (bilinear) and normalize the frames
    at `paths` → float32 `[T, size, size, 3]`. Raises FileNotFoundError on a
    frame that does not decode, RuntimeError if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native clip loader unavailable")
    n = len(paths)
    out = np.empty((n, size, size, 3), np.float32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    mean_arr = np.ascontiguousarray(mean, np.float32)
    std_arr = np.ascontiguousarray(std, np.float32)
    if mean_arr.shape != (3,) or std_arr.shape != (3,):
        raise ValueError(f"mean and std must have 3 entries, got {mean_arr.shape}, "
                         f"{std_arr.shape}")
    rc = lib.stpu_decode_clip(
        c_paths, n, size, size,
        mean_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        std_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_threads)
    if rc != 0:
        raise FileNotFoundError(f"native decode failed for {paths[-rc - 1]}")
    return out
