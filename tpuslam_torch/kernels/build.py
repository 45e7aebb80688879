"""Build and load the port's CUDA kernels.

Every ``tpuslam_torch/csrc/*.cu`` file is compiled by its own ``nvcc``
for ``sm_90a`` (Hopper), all of them at once, and the objects are linked
into one shared library with a plain C interface,
``build/kernels/libtpuslam_torch_kernels.so`` under the checkout's root,
loaded with ``ctypes``.  The sources include no PyTorch header, so a
build takes seconds.  It happens at first use in a process and is
skipped when the library on disk was built from the same sources: a
hash of every file under ``csrc/`` (the shared ``*.cuh`` headers
included) is kept beside it (``core/build_cache.py``).  Nothing here
runs at import time: the package imports where there is no ``nvcc`` and
no card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from tpuslam_torch.core import build_cache

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
    return build_cache.digest(ARCH_FLAGS, csrc,
                              sorted(p for p in csrc.rglob("*") if p.is_file()))


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
    if not force and build_cache.current(lib_path, digest):
        last_build.update(seconds=0.0, log="(current)", path=str(lib_path))
        return lib_path
    nvcc = _nvcc()
    t0 = time.perf_counter()
    log = []

    def compile_(tmp_dir: Path, tmp_lib: Path) -> None:
        objs = [tmp_dir / (src.stem + ".o") for src in _sources()]
        compiles = [
            [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-c", str(src), "-o", str(obj)]
            for src, obj in zip(_sources(), objs)
        ]
        link = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp_lib),
                *map(str, objs)]
        for proc in _run_all(compiles) + _run_all([link]):
            log.append(proc.stdout)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): "
                    f"{' '.join(proc.args)}\n{proc.stdout}"
                )

    build_cache.build_into(lib_path, digest, compile_)
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
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        for name, argtypes in (
            # (src, tgt, count, batch, n, m, threads, rows_per_thread,
            #  splits, stage_rows, depth, smem_bytes, arm, arm_value, tally,
            #  idx, dist, stream)
            ("tpuslam_nn_dense", [p, p, p, *[i] * 9, p, i, p, p, p, p]),
            # (saug, aux, caug, radii, eps, warm, batch, n, c, gsrc,
            #  chunks, splits, span, stage, smem_bytes, tally, adm, stream)
            ("tpuslam_bound_pass", [p, p, p, p, p, p, *[i] * 9, p, p, p]),
            # (src, packed, cand, counts, batch, n, m, ts, width, g, gsrc,
            #  chunks, splits, stage_rows, depth, smem_bytes, arm, arm_value,
            #  tally, idx, dist, stream)
            ("tpuslam_nn_cand", [p, p, p, p, *[i] * 12, p, i, p, p, p, p]),
            # (scalars, ty, target, batch, n, m, threads, rows_per_thread,
            #  splits, parts, pred, pred_value, live, tally, denom, stream)
            ("tpuslam_cpd_denom", [p, p, p, *[i] * 6, p, p, i, p, p, p, p]),
            # (scalars, ty, target, weights4, batch, n, m, threads,
            #  rows_per_thread, splits, parts, pred, pred_value, live, tally,
            #  acc, stream)
            ("tpuslam_cpd_moments", [p, p, p, p, *[i] * 6, p, p, i, p, p, p, p]),
            # (scalars, ty, target, table, counts, n, m, width, threads,
            #  rows_per_thread, pred, pred_value, tally, denom, stream)
            ("tpuslam_cpd_denom_cand", [p, p, p, p, p, *[i] * 5, p, i, p, p, p]),
            # (scalars, ty, target, weights4, table, counts, n, m, width,
            #  threads, rows_per_thread, pred, pred_value, tally, acc, stream)
            ("tpuslam_cpd_moments_cand", [p, p, p, p, p, p, *[i] * 5, p, i, p, p, p]),
            # (mov, mov_mask, tgt, tgt_mask, m0, n0, m, n, sigma2, constant,
            #  trunc, cut, log_t, checked, f_sub, cta_rows_n, cta_rows_m,
            #  width_m, width_n, budget_n, budget_m, cap_n, cap_m, work, the
            #  17 outputs of cpd_cand.Plan, tally, stream)
            ("tpuslam_cpd_plan", [p, p, p, p, *[i] * 4, p, p, p, f, f, *[i] * 10,
                                  *[p] * 20]),
            # (before, after, w, batch, n, chunk_rows, nchunks, part1, means,
            #  part2, arrivals, r, t, tally, stream)
            ("tpuslam_procrustes", [p, p, p, i, i, i, i, p, p, p, p, p, p, p, p]),
            # (h, batch, r, s, det, tally, stream)
            ("tpuslam_svd_rotation_det", [p, i, p, p, p, p, p]),
            # (diff, w, n_corr, batch, n, chunk_rows, nchunks, part, arrivals,
            #  err, tally, stream)
            ("tpuslam_masked_sq_error", [p, p, p, i, i, i, i, p, p, p, p, p]),
            # (p1, y, px, m, pt1, x, n, batch, chunk_rows, chunks_m, chunks_n,
            #  part, arrivals, sums, tally, stream)
            ("tpuslam_mstep_moments", [p, p, p, i, p, p, *[i] * 5, p, p, p, p, p]),
            # (targets, centers, ak, sigma, alpha, m, k, p, w, e_param, tally,
            #  out, stream)
            ("tpuslam_fgt_predict", [p, p, p, p, p, *[i] * 4, f, p, p, p]),
            # (points, weights, mask, centers, order, lengths, sigma, alpha,
            #  coeff, n, k, p, w, chunk_rows, smem_bytes, tally, ak, stream)
            ("tpuslam_fgt_expand", [*[p] * 9, *[i] * 6, p, p, p]),
        ):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        # (n, m, f_sub, cap_n, cap_m) -> bytes of K5's plan's workspace
        lib.tpuslam_cpd_plan_workspace.argtypes = [i] * 5
        lib.tpuslam_cpd_plan_workspace.restype = ctypes.c_longlong
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
