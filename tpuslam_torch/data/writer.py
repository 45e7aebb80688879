"""Cloud writers — save a (transformed) cloud back to disk.

A numpy-only copy of ``tpuslam/data/writer.py`` on the port's native
writer (``tpuslam_torch/native``): importing the original runs
``tpuslam/__init__.py``, which imports JAX.  Both packages write the
same bytes (``tests/test_torch_front.py``).

Beyond-reference capability: the reference only prints the recovered
transform (``mainwrapper.cpp:29-34``); a registration tool's natural
output is the transformed cloud itself.  Formats mirror the loaders'
subset so a written file round-trips through ``load_cloud`` bit-for-bit:

* ``.obj`` — one ``v x y z`` line per point (no faces, so loading
  yields exactly the written vertex list);
* ``.off`` — ``OFF`` header with ``N 0 0`` counts, one row per point.

Coordinates are printed with ``%.9g``: 9 significant decimal digits
round-trip any binary32 exactly, so ``load_cloud(save_cloud(x)) == x``
bitwise.  The native C++ writer (``tpuslam_torch/native/loader.cpp``) and
this Python fallback produce BYTE-IDENTICAL files (asserted in
``tests/test_torch_front.py``) — same contract as the loader pair.
"""

from __future__ import annotations

import os

import numpy as np


def _format_rows(points: np.ndarray, prefix: str) -> str:
    return "".join(
        f"{prefix}{float(p[0]):.9g} {float(p[1]):.9g} {float(p[2]):.9g}\n"
        for p in points
    )


def _save_obj_python(path: str, points: np.ndarray) -> None:
    with open(path, "w", newline="") as fh:
        fh.write(_format_rows(points, "v "))


def _save_off_python(path: str, points: np.ndarray) -> None:
    with open(path, "w", newline="") as fh:
        fh.write(f"OFF\n{len(points)} 0 0\n")
        fh.write(_format_rows(points, ""))


def save_cloud(path: str, points: np.ndarray) -> bool:
    """Write ``points`` (``f32[N, 3]``-coercible) to ``path`` by
    extension (.obj / .off); native C++ writer when the toolchain is
    available, byte-identical Python fallback otherwise.  Returns True
    on success, False on failure (unwritable path, bad extension)."""
    pts = np.ascontiguousarray(np.asarray(points), dtype=np.float32)
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"expected [N, 3] points, got {pts.shape}")
    ext = os.path.splitext(path)[1].lower()
    if ext not in (".obj", ".off"):
        return False
    try:
        from tpuslam_torch.native import bindings

        if bindings.available():
            writer = (
                bindings.write_obj if ext == ".obj" else bindings.write_off
            )
            return writer(path, pts)
    except Exception:  # noqa: BLE001 — fall through to the Python path
        pass
    try:
        if ext == ".obj":
            _save_obj_python(path, pts)
        else:
            _save_off_python(path, pts)
        return True
    except OSError:
        return False
