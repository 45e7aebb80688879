"""K2: the bound pass of the hierarchical exact NN — the wrapper of the
CUDA kernel ``csrc/bound.cu`` and its plain PyTorch version.

Port of ``tpuslam/kernels/pallas_bound.py::bound_pass_pallas`` and its
batch form ``bound_pass_pallas_batch``.  For each group of ``gsrc``
Morton-sorted sources, a bool row over the C target tiles: tile j is
admitted when a valid source ``s`` of the group has
``dc2[s, j] <= (ub[s] + r_j)^2 + eps``, with ``dc2 = s2 + saug @ caug``
(hi/lo bf16 split operands, products exact in float32), ``ub`` the
per-source upper bound ``min_j sqrt(max(dc2, 0) + eps) + r_j``,
tightened by the warm bound and inflated by ``(1 + 1e-5)`` and
``1e-6``.  The contract is a superset of the tiles that hold a true
nearest neighbour.

Kernel and plain version sum the twelve products of ``dc2`` in the same
fixed order (k ascending, then ``+ s2``), so on finite inputs they admit
identical sets.  (On a NaN input ``torch.amin`` propagates the NaN where
the kernel's ``fminf`` skips it.)

The kernel's launch geometry is chosen here (``bound_geometry``), where
the CPU tests reach it, and checked again by the C entry point.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel, or raises.  There is no other path.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from tpuslam_torch.ops.spatial import sqrt_rn

# the JAX kernel's inflation constants, float32(1 + 1e-5) and
# float32(1e-6), held as the Python floats of those float32 values
INFLATE_MUL = float(torch.tensor(1.0 + 1e-5, dtype=torch.float32))
INFLATE_ADD = float(torch.tensor(1e-6, dtype=torch.float32))
K = 12  # depth of the centre-distance product
# (source, tile) elements per chunk of the plain version
REF_ELEMS = 1 << 24

# kernel launches made by the wrappers below (CPU calls do not count),
# in all and by batch size B; a launch captured into a CUDA graph counts
# at each replay, booked by the device-resident loops (kernels.book_replay)
LAUNCHES = 0
BATCH_LAUNCHES: Counter = Counter()

# launch geometry of csrc/bound.cu (its kThreads, kR and kMaxCluster)
THREADS = 128
SOURCES_PER_THREAD = 4
CHUNK = THREADS * SOURCES_PER_THREAD  # sources per block
MAX_CLUSTER = 8  # blocks of one group: a portable thread-block cluster
STAGE_TILES = 256  # tiles staged in shared memory at a time
MIN_SPAN = 32  # fewest tiles a block is given when splitting for the grid
BLOCKS_TARGET = 4 * 132  # four blocks on each of the H100's 132 SMs
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may have


class BoundGeometry(NamedTuple):
    """How K2 is launched: a group's ``chunks`` x ``splits`` blocks form
    one cluster; block (chunk, split) serves ``CHUNK`` sources against
    ``span`` tiles, ``stage`` of them in shared memory at a time."""

    chunks: int
    splits: int
    span: int
    stage: int
    smem_bytes: int


def bound_geometry(batch: int, n: int, c: int, gsrc: int) -> BoundGeometry:
    """K2's geometry for ``batch`` pairs of ``n`` sources in groups of
    ``gsrc`` against ``c`` tiles.  Splits the tiles until a block's range
    fits one stage, then, while the grid has fewer than ``BLOCKS_TARGET``
    blocks, until a range would drop below ``MIN_SPAN`` tiles; a cluster
    holds at most ``MAX_CLUSTER`` blocks.  Raises where a group's sources
    need more than one cluster or the shared memory would not fit."""
    chunks = -(-gsrc // CHUNK)
    if chunks > MAX_CLUSTER:
        raise ValueError(
            f"gsrc {gsrc} exceeds {MAX_CLUSTER * CHUNK}: K2 serves a group "
            "from one thread-block cluster")
    splits = 1
    while chunks * splits * 2 <= MAX_CLUSTER and -(-c // splits) > STAGE_TILES:
        splits *= 2
    blocks = batch * (n // gsrc) * chunks
    while (chunks * splits * 2 <= MAX_CLUSTER and blocks * splits < BLOCKS_TARGET
           and -(-c // (2 * splits)) >= MIN_SPAN):
        splits *= 2
    span = -(-c // splits)
    stage = min(span, STAGE_TILES)
    smem = 4 * stage * (K + 1) + 4 * CHUNK + 4 * span
    if smem > SMEM_LIMIT:
        raise ValueError(f"K2 needs {smem} bytes of shared memory for C = {c}")
    return BoundGeometry(chunks, splits, span, stage, smem)


def center_dist2(a: torch.Tensor, caug: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """f32[r, C] ``s2 + sum_k a[:, k] * caug[k, :]`` summed k ascending,
    one float32 rounding per term (``a`` and ``caug`` hold bf16 values,
    so each product is exact)."""
    acc = a[:, 0:1] * caug[0:1, :]
    for k in range(1, K):
        acc = acc + a[:, k:k + 1] * caug[k:k + 1, :]
    return acc + s2[:, None]


def bound_pass_ref(
    saug: torch.Tensor,
    aux: torch.Tensor,
    caug: torch.Tensor,
    radii: torch.Tensor,
    eps: torch.Tensor,
    warm: torch.Tensor,
    gsrc: int,
) -> torch.Tensor:
    """The plain version of K2 on any device: bool[B, N // gsrc, C].
    Chunked over whole groups so a (rows, C) block stays bounded."""
    b, n, _ = saug.shape
    c = caug.shape[2]
    ts = n // gsrc
    f32 = dict(dtype=torch.float32, device=saug.device)
    mul = torch.tensor(INFLATE_MUL, **f32)
    add = torch.tensor(INFLATE_ADD, **f32)
    out = torch.empty((b, ts, c), dtype=torch.bool, device=saug.device)
    groups = max(1, REF_ELEMS // max(gsrc * c, 1))
    for p in range(b):
        cf = caug[p].float()
        e = eps[p]
        for g0 in range(0, ts, groups):
            g1 = min(ts, g0 + groups)
            rows = slice(g0 * gsrc, g1 * gsrc)
            x = aux[p, rows]
            dc2 = center_dist2(saug[p, rows].float(), cf, x[:, 0])
            ub = torch.amin(
                sqrt_rn(torch.clamp_min(dc2, 0.0) + e) + radii[p], dim=1
            )
            ub = torch.where(warm[p], torch.minimum(ub, x[:, 1]), ub)
            ub = ub * mul + add
            t = ub[:, None] + radii[p][None, :]
            adm = (dc2 <= t * t + e) & (x[:, 2:3] > 0)
            out[p, g0:g1] = adm.reshape(g1 - g0, gsrc, c).any(dim=1)
    return out


def _check(saug, aux, caug, radii, eps, warm, gsrc) -> None:
    if saug.dim() != 3 or saug.shape[2] != K:
        raise ValueError(f"saug must be [B, N, 12], got {tuple(saug.shape)}")
    b, n, _ = saug.shape
    if tuple(aux.shape) != (b, n, 4):
        raise ValueError(f"aux must be [{b}, {n}, 4], got {tuple(aux.shape)}")
    if caug.dim() != 3 or tuple(caug.shape[:2]) != (b, K):
        raise ValueError(f"caug must be [{b}, 12, C], got {tuple(caug.shape)}")
    c = caug.shape[2]
    if tuple(radii.shape) != (b, c):
        raise ValueError(f"radii must be [{b}, {c}], got {tuple(radii.shape)}")
    if tuple(eps.shape) != (b,) or tuple(warm.shape) != (b,):
        raise ValueError(
            f"eps and warm must be [{b}], got {tuple(eps.shape)}, "
            f"{tuple(warm.shape)}"
        )
    if gsrc <= 0 or n % gsrc != 0:
        raise ValueError(f"N = {n} is not a multiple of gsrc = {gsrc}")
    tensors = (saug, aux, caug, radii, eps, warm)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("K2's operands must share one device")
    if saug.dtype != torch.bfloat16 or caug.dtype != torch.bfloat16:
        raise TypeError(f"saug and caug must be bfloat16, got {saug.dtype}, {caug.dtype}")
    if any(t.dtype != torch.float32 for t in (aux, radii, eps)):
        raise TypeError("aux, radii and eps must be float32")
    if warm.dtype != torch.bool:
        raise TypeError(f"warm must be bool, got {warm.dtype}")


def bound_pass_batch(
    saug: torch.Tensor,
    aux: torch.Tensor,
    caug: torch.Tensor,
    radii: torch.Tensor,
    eps: torch.Tensor,
    warm: torch.Tensor,
    gsrc: int,
) -> torch.Tensor:
    """K2 on ``saug`` bf16[B, N, 12], ``aux`` f32[B, N, 4] (s2, warm upper
    bound, valid flag, 0), ``caug`` bf16[B, 12, C], ``radii`` f32[B, C],
    ``eps`` f32[B], ``warm`` bool[B], all on one device -> ``adm``
    bool[B, N // gsrc, C].

    On the CPU this is the plain version.  On CUDA it launches the kernel
    on the current stream (``eps`` and ``warm`` stay on the device) and
    raises if the launch is refused, or for a ``gsrc`` or ``C`` that
    ``bound_geometry`` cannot serve."""
    global LAUNCHES
    _check(saug, aux, caug, radii, eps, warm, gsrc)
    if saug.device.type == "cpu":
        return bound_pass_ref(saug, aux, caug, radii, eps, warm, gsrc)
    if saug.device.type != "cuda":
        raise RuntimeError(f"K2 runs on CPU or CUDA tensors, not {saug.device}")
    for name, t in (("saug", saug), ("aux", aux), ("caug", caug),
                    ("radii", radii), ("eps", eps), ("warm", warm)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if aux.data_ptr() % 16:
        raise ValueError("aux must be 16-byte aligned")
    b, n, _ = saug.shape
    c = caug.shape[2]

    from tpuslam_torch.kernels import counted, tally_ptr
    from tpuslam_torch.kernels.build import launch

    geo = bound_geometry(b, n, c, gsrc)
    # every byte is stored by the kernel
    adm = torch.empty((b, n // gsrc, c), dtype=torch.bool, device=saug.device)
    launch(
        "tpuslam_bound_pass", saug.device,
        saug.data_ptr(), aux.data_ptr(), caug.data_ptr(), radii.data_ptr(),
        eps.data_ptr(), warm.data_ptr(), b, n, c, gsrc, *geo,
        tally_ptr("K2", saug.device), adm.data_ptr(),
    )
    if counted("bound", b):
        LAUNCHES += 1
        BATCH_LAUNCHES[b] += 1
    return adm


def bound_pass(
    saug: torch.Tensor,
    aux: torch.Tensor,
    caug: torch.Tensor,
    radii: torch.Tensor,
    eps: torch.Tensor,
    warm: torch.Tensor,
    gsrc: int,
) -> torch.Tensor:
    """B=1 form: ``saug`` bf16[N, 12], ``aux`` f32[N, 4], ``caug``
    bf16[12, C], ``radii`` f32[C], ``eps`` and ``warm`` 0-d -> bool[N //
    gsrc, C].  Same dispatch as the batch form."""
    return bound_pass_batch(
        saug[None], aux[None], caug[None], radii[None],
        eps.reshape(1), warm.reshape(1), gsrc,
    )[0]
