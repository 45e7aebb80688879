"""K3: the candidate rescore of the hierarchical exact NN — the wrapper
of the CUDA kernel ``csrc/nn_cand.cu`` and its plain PyTorch version.

Port of ``tpuslam/kernels/pallas_nn_cand.py::nearest_neighbors_cand``
and its batch form ``nearest_neighbors_cand_batch``.  Each group of
``gsrc`` Morton-sorted sources carries a row of target-tile ids
(``candidates``, ``g`` sorted target rows per tile) of which the first
``counts`` are live.  For each source: the exact nearest of the live
tiles' rows, folded lexicographically on (distance, original index), so
it is bit-identical to K1 whenever the true nearest neighbour lies in an
admitted tile.  ``tgt_packed`` rows are ``(x, y, z, original index)``;
sentinel rows (past the target count) sit at 1e19 with index 3.4e38.
A distance >= 1e37, or no live slot, gives ``(0, 3.4e38)``.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel, or raises.  There is no other path.  The kernel's
launch geometry is chosen here (``cand_geometry``), where the CPU tests
reach it, and checked again by the C entry point.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple, Tuple

import torch

from tpuslam_torch.kernels.nn_dense import BIG, fma_sq_dist

NO_MATCH = 1e37  # distances at or above it report (0, BIG)
# (source, row) elements per chunk of the plain version
REF_ELEMS = 1 << 24

# kernel launches made by the wrappers below (CPU calls do not count),
# in all and by batch size B
LAUNCHES = 0
BATCH_LAUNCHES: Counter = Counter()

# launch geometry of csrc/nn_cand.cu (its kThreads, kR, kMaxSplits)
SOURCES_PER_THREAD = 4
CHUNK = 128 * SOURCES_PER_THREAD  # sources per block
MAX_SPLITS = 8  # blocks sharing a group's slots: a portable cluster
STAGE_ROWS = 512  # target rows per stage of the shared-memory ring
RING_DEPTH = 3  # stages in flight
BLOCKS_TARGET = 16 * 132  # two waves of eight blocks on each of 132 SMs


class CandGeometry(NamedTuple):
    """How K3 is launched: each ``CHUNK`` sources of a group are served by
    a cluster of ``splits`` blocks, each folding a contiguous share of the
    group's live slots, staged ``stage_rows`` rows at a time through a
    ring of ``depth`` stages in ``smem_bytes`` of dynamic shared memory."""

    chunks: int
    splits: int
    stage_rows: int
    depth: int
    smem_bytes: int


def cand_geometry(batch: int, ts: int, width: int, gsrc: int) -> CandGeometry:
    """K3's geometry for ``batch`` pairs of ``ts`` groups of ``gsrc``
    sources and tables ``width`` slots wide.  The slots are split (in
    powers of two, at most ``MAX_SPLITS``, never more than the width)
    until the grid reaches ``BLOCKS_TARGET`` blocks.  The tile size ``g``
    does not enter: the live rows are staged as one flat list, so the
    ring has the same size for every ``g``."""
    chunks = -(-gsrc // CHUNK)
    units = batch * ts * chunks
    splits = 1
    while splits < MAX_SPLITS and splits < width and units * splits < BLOCKS_TARGET:
        splits *= 2
    # ring (16-byte rows), partial (distance, index) per source, slot ids
    smem = 16 * RING_DEPTH * STAGE_ROWS + 8 * CHUNK + 4 * width
    return CandGeometry(chunks, splits, STAGE_ROWS, RING_DEPTH, smem)


def nearest_neighbors_cand_ref(
    src: torch.Tensor,
    tgt_packed: torch.Tensor,
    candidates: torch.Tensor,
    counts: torch.Tensor,
    g: int,
    gsrc: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K3 on any device: (i32[B, N], f32[B, N]).
    Gathers each group's live rows and folds them with K1's distance
    (``fma_sq_dist``); chunked over sources so a (chunk, rows) block
    stays bounded.  Reads ``counts`` back to the host."""
    b, n, _ = src.shape
    m = tgt_packed.shape[1]
    ts, width = candidates.shape[1], candidates.shape[2]
    tiles = m // g
    dev = src.device
    within = torch.arange(g, device=dev)
    idx = torch.zeros((b, n), dtype=torch.int32, device=dev)
    dist = torch.full((b, n), BIG, dtype=torch.float32, device=dev)
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    live = torch.clamp(counts, 0, width).tolist()
    for p in range(b):
        for grp in range(ts):
            ids = candidates[p, grp, :live[p][grp]].long()
            ids = ids[(ids >= 0) & (ids < tiles)]
            if ids.numel() == 0:
                continue
            rows = tgt_packed[p, (ids[:, None] * g + within).reshape(-1)]
            chunk = max(1, REF_ELEMS // rows.shape[0])
            for lo in range(grp * gsrc, (grp + 1) * gsrc, chunk):
                hi = min((grp + 1) * gsrc, lo + chunk)
                d = fma_sq_dist(src[p, lo:hi], rows[:, :3])
                best = torch.amin(d, dim=1)
                w = torch.amin(
                    torch.where(d == best[:, None], rows[None, :, 3], big),
                    dim=1,
                )
                none = best >= NO_MATCH
                dist[p, lo:hi] = torch.where(none, big, best)
                idx[p, lo:hi] = torch.where(
                    none, torch.zeros_like(w), w
                ).to(torch.int32)
    return idx, dist


def _check(src, tgt_packed, candidates, counts, g, gsrc) -> None:
    if src.dim() != 3 or src.shape[2] != 3:
        raise ValueError(f"src must be [B, N, 3], got {tuple(src.shape)}")
    b, n, _ = src.shape
    if tgt_packed.dim() != 3 or tgt_packed.shape[0] != b or tgt_packed.shape[2] != 4:
        raise ValueError(
            f"tgt_packed must be [{b}, M, 4], got {tuple(tgt_packed.shape)}"
        )
    if candidates.dim() != 3 or candidates.shape[0] != b:
        raise ValueError(
            f"candidates must be [{b}, ts, L], got {tuple(candidates.shape)}"
        )
    ts = candidates.shape[1]
    if tuple(counts.shape) != (b, ts):
        raise ValueError(f"counts must be [{b}, {ts}], got {tuple(counts.shape)}")
    if g <= 0 or gsrc <= 0 or ts * gsrc != n or tgt_packed.shape[1] % g:
        raise ValueError(
            f"need N = ts * gsrc and M a multiple of g: N {n}, ts {ts}, "
            f"gsrc {gsrc}, M {tgt_packed.shape[1]}, g {g}"
        )
    tensors = (src, tgt_packed, candidates, counts)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("K3's operands must share one device")
    if src.dtype != torch.float32 or tgt_packed.dtype != torch.float32:
        raise TypeError("src and tgt_packed must be float32")
    if candidates.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("candidates and counts must be int32")


def nearest_neighbors_cand_batch(
    src: torch.Tensor,
    tgt_packed: torch.Tensor,
    candidates: torch.Tensor,
    counts: torch.Tensor,
    g: int,
    gsrc: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 on ``src`` f32[B, N, 3] (sorted), ``tgt_packed`` f32[B, M, 4],
    ``candidates`` i32[B, N // gsrc, L], ``counts`` i32[B, N // gsrc],
    all on one device -> (idx i32[B, N], dist f32[B, N]).

    On the CPU this is the plain version.  On CUDA it launches the kernel
    on the current stream (``counts`` stays on the device) and raises if
    the launch is refused."""
    global LAUNCHES
    _check(src, tgt_packed, candidates, counts, g, gsrc)
    if src.device.type == "cpu":
        return nearest_neighbors_cand_ref(
            src, tgt_packed, candidates, counts, g, gsrc
        )
    if src.device.type != "cuda":
        raise RuntimeError(f"K3 runs on CPU or CUDA tensors, not {src.device}")
    for name, t in (("src", src), ("tgt_packed", tgt_packed),
                    ("candidates", candidates), ("counts", counts)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tgt_packed.data_ptr() % 16:
        raise ValueError("tgt_packed must be 16-byte aligned")
    b, n, _ = src.shape
    m = tgt_packed.shape[1]
    ts, width = candidates.shape[1], candidates.shape[2]
    if max(n, m) >= 2**31 or width * g >= 2**31:
        raise ValueError("sizes exceed the kernel's int32 indexing")

    from tpuslam_torch.kernels.build import launch

    idx = torch.empty((b, n), dtype=torch.int32, device=src.device)
    dist = torch.empty((b, n), dtype=torch.float32, device=src.device)
    launch(
        "tpuslam_nn_cand", src.device,
        src.data_ptr(), tgt_packed.data_ptr(), candidates.data_ptr(),
        counts.data_ptr(), b, n, m, ts, width, g, gsrc,
        *cand_geometry(b, ts, width, gsrc), idx.data_ptr(), dist.data_ptr(),
    )
    LAUNCHES += 1
    BATCH_LAUNCHES[b] += 1
    return idx, dist


def nearest_neighbors_cand(
    src: torch.Tensor,
    tgt_packed: torch.Tensor,
    candidates: torch.Tensor,
    counts: torch.Tensor,
    g: int,
    gsrc: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B=1 form: ``src`` f32[N, 3], ``tgt_packed`` f32[M, 4],
    ``candidates`` i32[N // gsrc, L], ``counts`` i32[N // gsrc] ->
    (i32[N], f32[N]).  Same dispatch as the batch form."""
    idx, dist = nearest_neighbors_cand_batch(
        src[None], tgt_packed[None], candidates[None], counts[None], g, gsrc
    )
    return idx[0], dist[0]
