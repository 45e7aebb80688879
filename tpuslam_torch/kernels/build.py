"""Build and load the port's CUDA kernels.

Every ``tpuslam_torch/csrc/*.cu`` file is compiled by ``nvcc`` for
``sm_90a`` (Hopper) into one shared library with a plain C interface,
``build/kernels/libtpuslam_torch_kernels.so`` under the checkout's root,
and loaded with ``ctypes``.  The sources include no PyTorch header, so a
build takes seconds.  It happens at first use in a process and is
skipped when the library on disk was built from the same sources (a
content hash is kept beside it).  Nothing here runs at import time: the
package imports where there is no ``nvcc`` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
LIB_NAME = "libtpuslam_torch_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lib: Optional[ctypes.CDLL] = None
# what the last build in this process did: seconds spent in nvcc (0.0
# when the library on disk was current) and nvcc's -Xptxas -v report
last_build = {"seconds": 0.0, "log": "", "path": ""}


def _nvcc() -> str:
    """The toolkit's nvcc: ``$CUDA_HOME/bin/nvcc``, else the one on PATH."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    for c in candidates:
        if os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
        "kernels of tpuslam_torch are built from source at first use"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it is current;
    returns its path.  Raises with nvcc's output when the build fails."""
    sources = _sources()
    digest = _digest(sources)
    lib_path = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / (LIB_NAME + ".sha256")
    if (
        not force
        and lib_path.exists()
        and stamp.exists()
        and stamp.read_text().strip() == digest
    ):
        last_build.update(seconds=0.0, log="(current)", path=str(lib_path))
        return lib_path
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename, so a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", tmp, *map(str, sources),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    stamp.write_text(digest + "\n")
    last_build.update(
        seconds=seconds, log=proc.stdout + proc.stderr, path=str(lib_path)
    )
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, loaded once per
    process, with every entry point's argument types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        # tpuslam_nn_dense(src, tgt, count, batch, n, m, idx, dist, stream)
        lib.tpuslam_nn_dense.argtypes = [p, p, p, i, i, i, p, p, p]
        lib.tpuslam_nn_dense.restype = ctypes.c_int
        _lib = lib
    return _lib
