"""Cloud loaders (port of ``tpuslam/data/loader.py``, the parts the
dense-ICP slice uses).

These are numpy-only copies of the JAX package's readers: importing
``tpuslam.data.loader`` runs ``tpuslam/__init__.py``, which imports JAX,
and the port must run where JAX is not installed.
``tests/test_torch_types.py`` pins each copy to its original.

Covered: ``synthetic://N[?lattice=1]``, ``.obj`` and ``.off`` (the
pure-Python readers; the native C++ OBJ/OFF loader is not used).  A
missing or unparsable file returns an empty ``(0, 3)`` cloud, like the
reference (``common.cpp:16-23``).  ``.ply``, ``.stl`` and ``.dae`` are
not ported yet and load as empty clouds with a notice on stderr.
"""

from __future__ import annotations

import os
import sys

import numpy as np


def _load_obj_python(path: str) -> np.ndarray:
    """Parse OBJ: positions from ``v`` lines, then expand per face corner
    (Assimp emits one vertex per face-corner reference)."""
    vertices: list[tuple[float, float, float]] = []
    faces: list[list[int]] = []
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            if line.startswith("v "):
                parts = line.split()
                vertices.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    # "f v", "f v/vt", "f v/vt/vn", "f v//vn"; negative = relative
                    s = tok.split("/")[0]
                    if not s:
                        continue
                    i = int(s)
                    idx.append(i - 1 if i > 0 else len(vertices) + i)
                if len(idx) >= 3:
                    faces.append(idx)
    if not vertices:
        return np.zeros((0, 3), dtype=np.float32)
    verts = np.asarray(vertices, dtype=np.float32)
    if not faces:
        # point-cloud OBJ without faces: the vertex list itself
        return verts
    flat = np.concatenate([np.asarray(f, dtype=np.int64) for f in faces])
    return verts[flat]


def _load_off(path: str) -> np.ndarray:
    """Parse OFF: the raw vertex list (Assimp does not duplicate here)."""
    with open(path, "r", errors="replace") as fh:
        header = fh.readline().strip()
        if not header.startswith("OFF"):
            return np.zeros((0, 3), dtype=np.float32)
        # header may carry counts on the same line ("OFF 8 6 12")
        rest = header[3:].split()
        counts: list[int] = [int(t) for t in rest] if rest else []
        while len(counts) < 3:
            line = fh.readline()
            if not line:
                return np.zeros((0, 3), dtype=np.float32)
            line = line.split("#")[0].strip()
            if not line:
                continue
            counts.extend(int(t) for t in line.split())
        nv = counts[0]
        # bounded by what the file could hold (a vertex row is at least 6
        # bytes, "0 0 0\n"), so a corrupt header over a short body yields
        # the prefix actually present, not an allocation failure
        cap = min(nv, os.fstat(fh.fileno()).st_size // 6 + 16)
        out = np.empty((cap, 3), dtype=np.float32)
        filled = 0
        while filled < nv:
            line = fh.readline()
            if not line:
                break
            line = line.split("#")[0].strip()
            if not line:
                continue
            parts = line.split()
            out[filled, 0] = float(parts[0])
            out[filled, 1] = float(parts[1])
            out[filled, 2] = float(parts[2])
            filled += 1
        return out[:filled].copy()


# Relative cloud paths (e.g. "data/bunny.obj") resolve against the CWD
# first, then these roots: the checkout this package lies in.
SEARCH_ROOTS = [
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
]


def resolve_path(path: str) -> str:
    if os.path.isabs(path) or os.path.exists(path):
        return path
    for root in SEARCH_ROOTS:
        candidate = os.path.join(root, path)
        if os.path.exists(candidate):
            return candidate
    return path


def _random_rotation(rng: np.random.Generator) -> np.ndarray:
    """Uniform random SO(3) rotation (quaternion from an isotropic
    Gaussian, normalized) — deterministic under the caller's rng."""
    q = rng.standard_normal(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ],
        dtype=np.float32,
    )


def synthetic_fixture() -> str:
    """Which cloud ``synthetic://N`` builds here: ``"tiled-bunny"`` when
    ``data/bunny.obj`` resolves, else ``"uniform-box"``."""
    return "tiled-bunny" if len(load_cloud("data/bunny.obj")) else "uniform-box"


def synthetic_cloud(n: int, lattice: bool = False) -> np.ndarray:
    """Deterministic synthetic cloud of >= n points: the bunny tiled on a
    grid, each tile given an independent random rotation about its own
    center plus jitter (``lattice=True`` keeps translated copies only).
    Without ``data/bunny.obj`` it is a uniform random box of side 10,
    seeded by ``n``."""
    base = load_cloud("data/bunny.obj")
    if len(base) == 0:  # reference data unavailable: uniform fallback
        rng = np.random.Generator(np.random.PCG64(n))
        return (rng.random((n, 3), dtype=np.float64) * 10.0).astype(
            np.float32
        )
    reps = -(-n // len(base))  # ceil
    side = int(np.ceil(reps ** (1.0 / 3.0)))
    spread = base.max(axis=0) - base.min(axis=0)
    center = ((base.max(axis=0) + base.min(axis=0)) * 0.5).astype(np.float32)
    rng = np.random.Generator(np.random.PCG64(n))
    tiles = []
    for i in range(reps):
        ix, iy, iz = i % side, (i // side) % side, i // (side * side)
        offset = np.array([ix, iy, iz], dtype=np.float32) * spread * 1.1
        jitter = (rng.random(3, dtype=np.float64) * 0.05 * spread).astype(
            np.float32
        )
        if lattice:
            tiles.append(base + offset + jitter)
        else:
            rot = _random_rotation(rng)
            tiles.append((base - center) @ rot.T + center + offset + jitter)
    return np.concatenate(tiles, axis=0)[: max(n, 1)]


def load_cloud(path: str) -> np.ndarray:
    """Load a cloud as ``f32[N, 3]``; empty array on failure
    (mirrors ``LoadCloud``, ``common.cpp:16-23``)."""
    if path.startswith("synthetic://"):
        try:
            spec = path[len("synthetic://"):]
            lattice = False
            if "?" in spec:
                spec, query = spec.split("?", 1)
                lattice = query == "lattice=1"
            n = int(spec)
            if n <= 0:
                return np.zeros((0, 3), dtype=np.float32)
            return synthetic_cloud(n, lattice=lattice)
        except (ValueError, MemoryError):
            # same contract as a malformed file: empty cloud, no raise
            return np.zeros((0, 3), dtype=np.float32)
    path = resolve_path(path)
    if not os.path.exists(path):
        return np.zeros((0, 3), dtype=np.float32)
    ext = os.path.splitext(path)[1].lower()
    readers = {".obj": _load_obj_python, ".off": _load_off}
    if ext in readers:
        try:
            return readers[ext](path)
        except Exception:  # noqa: BLE001 — unparsable => empty, like Assimp failure
            return np.zeros((0, 3), dtype=np.float32)
    print(
        f"[tpuslam_torch] unsupported cloud format '{ext}' for {path} "
        f"(supported: .obj, .off, synthetic://N)",
        file=sys.stderr,
    )
    return np.zeros((0, 3), dtype=np.float32)
