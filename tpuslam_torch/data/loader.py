"""Cloud loaders (port of ``tpuslam/data/loader.py``).

These are numpy-only copies of the JAX package's readers: importing
``tpuslam.data.loader`` runs ``tpuslam/__init__.py``, which imports JAX,
and the port must run where JAX is not installed.
``tests/test_torch_types.py`` and ``tests/test_torch_front.py`` pin each
copy to its original.

Formats: ``synthetic://N[?lattice=1]``, ``.obj`` and ``.off`` (the
native C++ reader of ``tpuslam_torch/native`` where the host compiler
built it, else the pure-Python readers, which it equals), ``.ply``,
``.stl`` and ``.dae``.  Any other extension loads as an empty cloud with
a notice on stderr.  A missing or unparsable file returns an empty
``(0, 3)`` cloud, like the reference (``common.cpp:16-23``).

The ``synthetic://`` query is parsed as in the JAX package, which this
port is held to: only the exact query ``lattice=1`` selects the lattice
variant, and any other query is ignored (``synthetic://N?foo`` is
``synthetic://N``).
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


# numpy dtype + byte size per PLY scalar type name (both naming schemes)
_PLY_TYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _load_ply(path: str) -> np.ndarray:
    """Parse PLY (ascii / binary little- or big-endian): the vertex
    element's (x, y, z) properties, extra per-vertex properties skipped.

    Like the OFF path, the vertex list is taken as-is (no per-face-corner
    duplication): the reference's Assimp PLY importer also builds one
    mesh vertex per PLY vertex element (``loader.cpp:30-66`` merges mesh
    vertex buffers; PLY faces index a shared vertex list, unlike OBJ's
    per-corner attribute tuples).  Faces are ignored.  Anything
    malformed yields an empty cloud (the ``LoadCloud`` failure contract,
    ``common.cpp:16-23``)."""
    with open(path, "rb") as fh:
        if fh.readline().strip() != b"ply":
            return np.zeros((0, 3), dtype=np.float32)
        fmt = None
        elements: list[dict] = []
        cur = None
        while True:
            raw = fh.readline()
            if not raw:  # EOF before end_header
                return np.zeros((0, 3), dtype=np.float32)
            line = raw.decode("ascii", errors="replace").strip()
            if not line or line.startswith(("comment", "obj_info")):
                continue
            parts = line.split()
            if parts[0] == "format":
                fmt = parts[1] if len(parts) > 1 else None
            elif parts[0] == "element" and len(parts) >= 3:
                cur = {"name": parts[1], "count": int(parts[2]),
                       "props": []}
                elements.append(cur)
            elif parts[0] == "property" and cur is not None:
                if len(parts) >= 5 and parts[1] == "list":
                    cur["props"].append(("list", parts[2], parts[3],
                                         parts[4]))
                elif len(parts) >= 3:
                    cur["props"].append(("scalar", parts[1], parts[2]))
            elif parts[0] == "end_header":
                break
        if fmt not in ("ascii", "binary_little_endian",
                       "binary_big_endian"):
            return np.zeros((0, 3), dtype=np.float32)
        vertex = next(
            (e for e in elements if e["name"] == "vertex"), None
        )
        if vertex is None or vertex["count"] <= 0:
            return np.zeros((0, 3), dtype=np.float32)
        names = [p[2] if p[0] == "scalar" else None
                 for p in vertex["props"]]
        try:
            cols = [names.index(c) for c in ("x", "y", "z")]
        except ValueError:
            return np.zeros((0, 3), dtype=np.float32)

        if fmt == "ascii":
            # A list property inside the vertex element shifts token
            # columns per-row (the list length is data-dependent), so
            # positional indexing would misparse coordinates — reject,
            # mirroring the binary path's guard below.  Ascii rows are
            # read line-by-line; the PLY spec technically allows tokens
            # reflowed across lines, which this (like most readers)
            # treats as malformed (empty cloud), not misparsed.
            if any(p[0] != "scalar" for p in vertex["props"]):
                return np.zeros((0, 3), dtype=np.float32)
            # elements appear in declaration order; list-carrying
            # elements before vertex are consumed row by row
            for e in elements:
                if e is vertex:
                    break
                for _ in range(e["count"]):
                    if not fh.readline():
                        return np.zeros((0, 3), dtype=np.float32)
            out = np.empty((vertex["count"], 3), dtype=np.float32)
            filled = 0
            while filled < vertex["count"]:
                raw = fh.readline()
                if not raw:
                    break
                toks = raw.split()
                if not toks:
                    continue
                out[filled] = [float(toks[c]) for c in cols]
                filled += 1
            return out[:filled].copy()

        # binary: the vertex element must be reachable by fixed strides
        # (a variable-length list BEFORE it cannot be skipped blindly)
        endian = "<" if fmt == "binary_little_endian" else ">"
        for e in elements:
            if e is vertex:
                break
            if any(p[0] == "list" for p in e["props"]):
                return np.zeros((0, 3), dtype=np.float32)
            stride = sum(
                np.dtype(_PLY_TYPES[p[1]]).itemsize for p in e["props"]
            )
            fh.seek(e["count"] * stride, os.SEEK_CUR)
        if any(p[0] != "scalar" or p[1] not in _PLY_TYPES
               for p in vertex["props"]):
            return np.zeros((0, 3), dtype=np.float32)
        dt = np.dtype(
            [(f"p{i}", endian + _PLY_TYPES[p[1]])
             for i, p in enumerate(vertex["props"])]
        )
        buf = fh.read(dt.itemsize * vertex["count"])
        rows = np.frombuffer(buf, dtype=dt,
                             count=len(buf) // dt.itemsize)
        out = np.empty((len(rows), 3), dtype=np.float32)
        for k, c in enumerate(cols):
            out[:, k] = rows[f"p{c}"].astype(np.float32)
        return out


def _load_stl(path: str) -> np.ndarray:
    """Parse STL (ascii and binary) the way the reference sees it:
    Assimp's STL importer emits THREE vertices per facet in file order
    and the reference never requests ``aiProcess_JoinIdenticalVertices``
    (``loader.cpp:32``), so shared corners stay duplicated — a cube of
    12 facets is 36 points.

    Binary detection follows the de-facto rule (the 'solid' prefix is
    unreliable — binary exporters write it too): the file is binary iff
    its size matches ``84 + 50 * facet_count`` from the header."""
    size = os.path.getsize(path)
    with open(path, "rb") as fh:
        head = fh.read(84)
        if len(head) == 84:
            (count,) = np.frombuffer(head[80:84], dtype="<u4")
            if size == 84 + 50 * int(count):
                body = fh.read(50 * int(count))
                # facet record: normal f32[3], vertices f32[9], attr u16
                rec = np.frombuffer(body, dtype="<u1").reshape(-1, 50)
                tri = rec[:, :48].copy().view("<f4").reshape(-1, 12)
                return (
                    tri[:, 3:12].astype(np.float32).reshape(-1, 3)
                )
    pts: list[float] = []
    with open(path, "r", errors="replace") as fh:
        for line in fh:
            parts = line.split()
            if len(parts) == 4 and parts[0] == "vertex":
                pts.extend(
                    (float(parts[1]), float(parts[2]), float(parts[3]))
                )
    return np.asarray(pts, dtype=np.float32).reshape(-1, 3)


def _load_dae(path: str) -> np.ndarray:
    """Parse Collada geometry positions: every ``<geometry><mesh>``'s
    POSITION source, concatenated in document order.

    Matches the reference's observable semantics: its ``ProcessNode``
    reads each mesh's raw vertex buffer and IGNORES node transforms
    (``loader.cpp:46-66`` never touches ``mTransformation``), so scene
    placement does not move points here either.  Triangulation is
    irrelevant — only positions are consumed.

    The namespace is detected from the root tag, so both COLLADA 1.4
    (2005/11 schema) and 1.5 (2008/03) documents parse; a document that
    parses to zero points still warns on stderr — silence would read as
    a successfully-loaded empty registration."""
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    # root tag is '{<schema-uri>}COLLADA' — take whatever URI the file
    # declares (1.4 = .../2005/11/..., 1.5 = .../2008/03/...)
    uri = root.tag[1:].split("}", 1)[0] if root.tag.startswith("{") else ""
    ns = {"c": uri or "http://www.collada.org/2005/11/COLLADASchema"}
    clouds = []
    for geom in root.iter("{%s}geometry" % ns["c"]):
        for mesh in geom.findall("c:mesh", ns):
            # <vertices><input semantic="POSITION" source="#id"/>
            src_id = None
            verts = mesh.find("c:vertices", ns)
            if verts is not None:
                for inp in verts.findall("c:input", ns):
                    if inp.get("semantic") == "POSITION":
                        src_id = (inp.get("source") or "").lstrip("#")
            for source in mesh.findall("c:source", ns):
                if src_id is not None and source.get("id") != src_id:
                    continue
                arr = source.find("c:float_array", ns)
                if arr is None or not arr.text:
                    continue
                vals = np.asarray(arr.text.split(), dtype=np.float32)
                if vals.size % 3 == 0 and vals.size:
                    clouds.append(vals.reshape(-1, 3))
                break
    if not clouds:
        print(
            f"[tpuslam_torch] Collada document {path} parsed to zero points "
            f"(namespace '{ns['c']}')",
            file=sys.stderr,
        )
        return np.zeros((0, 3), dtype=np.float32)
    return np.concatenate(clouds, axis=0)


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
    readers = {".obj": _load_obj_python, ".off": _load_off, ".ply": _load_ply,
               ".stl": _load_stl, ".dae": _load_dae}
    if ext in readers:
        try:
            if ext in (".obj", ".off"):
                from tpuslam_torch.native import bindings

                if bindings.available():
                    return bindings.load_obj(path) if ext == ".obj" else bindings.load_off(path)
            return readers[ext](path)
        except Exception:  # noqa: BLE001 — unparsable => empty, like Assimp failure
            return np.zeros((0, 3), dtype=np.float32)
    # unsupported format: keep the empty-cloud contract, but say so
    # loudly instead of silently registering nothing (the reference's
    # Assimp accepts many formats, loader.cpp:30-66)
    print(
        f"[tpuslam_torch] unsupported cloud format '{ext}' for {path} "
        f"(supported: .obj, .off, .ply, .stl, .dae, synthetic://N)",
        file=sys.stderr,
    )
    return np.zeros((0, 3), dtype=np.float32)
