"""Build and load the port's CUDA kernels.

Every ``tpuslam_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
for ``sm_90a`` (Hopper), all of them at once, and the objects are linked
into one shared library with a plain C interface,
``build/kernels/libtpuslam_torch_kernels.so`` under the checkout's root,
loaded with ``ctypes``.  The sources include no PyTorch header, so a
build takes seconds.  It happens at first use in a process and is
skipped when the library on disk was built from the same sources: a
hash of every file under ``csrc/`` (the shared ``*.cuh`` headers
included) is kept beside it.  Nothing here runs at import time: the
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

import torch

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


def _digest(csrc: Path = CSRC) -> str:
    """Hash of the build flags and of every file under ``csrc``."""
    h = hashlib.sha256(" ".join(ARCH_FLAGS).encode())
    for f in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(str(f.relative_to(csrc)).encode())
        h.update(f.read_bytes())
    return h.hexdigest()


def _run_all(cmds: list[list[str]]) -> list[subprocess.CompletedProcess]:
    """Run the commands concurrently; wait for every one of them."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    done = []
    for c, p in zip(cmds, procs):
        out = p.communicate()[0]
        done.append(subprocess.CompletedProcess(c, p.returncode, out, ""))
    return done


def build(force: bool = False) -> Path:
    """Compile ``csrc/*.cu`` into the shared library unless it is current;
    returns its path.  Raises with nvcc's output when the build fails."""
    digest = _digest()
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
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp_dir:
        objs = [Path(tmp_dir) / (src.stem + ".o") for src in _sources()]
        compiles = [
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
            for src, obj in zip(_sources(), objs)
        ]
        # link beside the target and rename, so a concurrent loader never
        # sees a half-written library
        tmp_lib = Path(tmp_dir) / LIB_NAME
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                *map(str, objs)]
        log = []
        for proc in _run_all(compiles) + _run_all([link]):
            log.append(proc.stdout)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): "
                    f"{' '.join(proc.args)}\n{proc.stdout}"
                )
        os.replace(tmp_lib, lib_path)
    stamp.write_text(digest + "\n")
    last_build.update(
        seconds=time.perf_counter() - t0, log="".join(log), path=str(lib_path)
    )
    return lib_path


def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built if needed, loaded once per
    process, with every entry point's argument types declared."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        for name, argtypes in (
            # (src, tgt, count, batch, n, m, threads, rows_per_thread,
            #  splits, stage_rows, depth, smem_bytes, idx, dist, stream)
            ("tpuslam_nn_dense", [p, p, p, *[i] * 9, p, p, p]),
            # (saug, aux, caug, radii, eps, warm, batch, n, c, gsrc,
            #  chunks, splits, span, stage, smem_bytes, adm, stream)
            ("tpuslam_bound_pass", [p, p, p, p, p, p, *[i] * 9, p, p]),
            # (src, packed, cand, counts, batch, n, m, ts, width, g, gsrc,
            #  chunks, splits, stage_rows, depth, smem_bytes, idx, dist,
            #  stream)
            ("tpuslam_nn_cand", [p, p, p, p, *[i] * 12, p, p, p]),
            # (scalars, ty, target, batch, n, m, threads, rows_per_thread,
            #  splits, parts, denom, stream)
            ("tpuslam_cpd_denom", [p, p, p, i, i, i, i, i, i, p, p, p]),
            # (scalars, ty, target, weights4, batch, n, m, threads,
            #  rows_per_thread, splits, parts, acc, stream)
            ("tpuslam_cpd_moments", [p, p, p, p, i, i, i, i, i, i, p, p, p]),
            # (scalars, ty, target, table, counts, n, m, width, threads,
            #  rows_per_thread, denom, stream)
            ("tpuslam_cpd_denom_cand", [p, p, p, p, p, i, i, i, i, i, p, p]),
            # (scalars, ty, target, weights4, table, counts, n, m, width,
            #  threads, rows_per_thread, acc, stream)
            ("tpuslam_cpd_moments_cand", [p, p, p, p, p, p, i, i, i, i, i, p, p]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C entry point ``name`` with ``args`` and the current CUDA
    stream of ``device``; raise if the launch was refused."""
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed, cudaError {rc}")
