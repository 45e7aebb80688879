"""ctypes bindings for the port's native C++ cloud reader and writer
(``loader.cpp``; a copy of ``tpuslam/native/bindings.py`` that builds
its own library).

The library is built at first use in a process by the host C++ compiler
(``c++ -O3 -fPIC -std=c++17 -shared``) into
``build/native/libtpuslam_torch_native.so`` under the checkout's root,
never into the package, and rebuilt when the source's hash, kept beside
it, changes (``core/build_cache.py``, shared with the CUDA kernels'
build).  Where there is no compiler, or the build fails, ``available()``
is False and the Python readers and writers of ``tpuslam_torch.data``
serve instead; they are the behavioural oracle the native ones are
tested against.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from tpuslam_torch.core import build_cache

SOURCE = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
LIB_NAME = "libtpuslam_torch_native.so"
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _digest() -> str:
    return build_cache.digest(FLAGS, SOURCE.parent, [SOURCE])


def build() -> Optional[Path]:
    """The library's path, compiled unless the one on disk was built from
    this source; None when there is no compiler or the build fails."""
    digest = _digest()
    lib_path = BUILD_DIR / LIB_NAME
    if build_cache.current(lib_path, digest):
        return lib_path
    cxx = shutil.which("c++") or shutil.which("g++")
    if cxx is None:
        return None

    def compile_(tmp_dir: Path, tmp_lib: Path) -> None:
        subprocess.run([cxx, *FLAGS, "-o", str(tmp_lib), str(SOURCE)],
                       capture_output=True, timeout=120, check=True)

    try:
        return build_cache.build_into(lib_path, digest, compile_)
    except (OSError, subprocess.SubprocessError):
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        for name in ("tpuslam_load_obj", "tpuslam_load_off"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ]
        for name in ("tpuslam_write_obj", "tpuslam_write_off"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_long
            fn.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_long,
            ]
        lib.tpuslam_free.restype = None
        lib.tpuslam_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _call(fn_name: str, path: str) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    out = ctypes.POINTER(ctypes.c_float)()
    n = getattr(lib, fn_name)(path.encode(), ctypes.byref(out))
    if n <= 0 or not out:
        return np.zeros((0, 3), dtype=np.float32)
    try:
        arr = np.ctypeslib.as_array(out, shape=(n, 3)).copy()
    finally:
        lib.tpuslam_free(out)
    return arr


def load_obj(path: str) -> np.ndarray:
    return _call("tpuslam_load_obj", path)


def load_off(path: str) -> np.ndarray:
    return _call("tpuslam_load_off", path)


def _write(fn_name: str, path: str, points: np.ndarray) -> bool:
    lib = _load()
    if lib is None:
        raise RuntimeError("native writer unavailable")
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected [N, 3] points, got {pts.shape}")
    buf = pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    return bool(getattr(lib, fn_name)(path.encode(), buf, len(pts)))


def write_obj(path: str, points: np.ndarray) -> bool:
    return _write("tpuslam_write_obj", path, points)


def write_off(path: str, points: np.ndarray) -> bool:
    return _write("tpuslam_write_off", path, points)
