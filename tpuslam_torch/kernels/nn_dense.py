"""K1: dense exact nearest-neighbour search — the wrapper of the CUDA
kernel ``csrc/nn_dense.cu`` and its plain PyTorch version.

Port of ``tpuslam/kernels/pallas_nn.py::nearest_neighbors_pallas_batch``
and its B=1 form ``nearest_neighbors_pallas``.  For each source row: the
index and squared distance of the nearest valid target row (index <
count), the first index winning a tie, ``(0, 3.4e38)`` when there is no
valid target.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel, or raises.  There is no other path.  The kernel's
launch geometry is chosen here (``dense_geometry``), where the CPU tests
reach it, and checked again by the C entry point.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple, Optional, Tuple

import torch

BIG = 3.4e38  # no-match distance, the JAX oracle's float32(3.4e38)
# source rows per chunk of the plain version: a chunk holds a few
# (chunk, M) float64 temporaries, about 4 GB at M = 102,400
REF_CHUNK = 1024

# kernel launches made by the wrappers below (CPU calls do not count),
# in all and by batch size B; a launch captured into a CUDA graph counts
# at each replay, booked by the device-resident loops (kernels.book_replay)
LAUNCHES = 0
BATCH_LAUNCHES: Counter = Counter()

# launch geometry of csrc/nn_dense.cu (its kThreads, kSeg, kMaxSplits)
THREADS = 128
SEGMENT = 32  # targets per segment of the running minimum
MAX_SPLITS = 8  # blocks sharing a source block's targets: a portable cluster
STAGE_ROWS = 512  # target rows per stage of the shared-memory ring
RING_DEPTH = 3  # stages in flight
FILL_BLOCKS = 256  # about two blocks on each of 132 SMs
BLOCKS_TARGET = 12 * 132  # the grid the target splits aim for
MIN_SPLIT_ROWS = 256  # no split gets fewer target rows


class DenseGeometry(NamedTuple):
    """How K1 is launched: ``threads`` threads a block, each holding
    ``rows_per_thread`` sources; the target range split over a cluster of
    ``splits`` blocks, each staging its share ``stage_rows`` rows at a time
    through a ring of ``depth`` stages in ``smem_bytes`` of dynamic shared
    memory."""

    threads: int
    rows_per_thread: int
    splits: int
    stage_rows: int
    depth: int
    smem_bytes: int


def dense_geometry(batch: int, n: int, m: int) -> DenseGeometry:
    """K1's geometry for ``batch`` pairs of ``n`` sources and ``m`` target
    rows.  Four sources a thread, or two where even eight splits would
    leave fewer than ``FILL_BLOCKS`` blocks; then the target range is
    split (at most ``MAX_SPLITS`` ways, each split at least
    ``MIN_SPLIT_ROWS`` rows) until the grid reaches ``BLOCKS_TARGET``
    blocks.  The ring holds no more rows than a split's share."""

    def blocks(rows_per_thread: int) -> int:
        return batch * -(-n // (THREADS * rows_per_thread))

    rpt = 4 if blocks(4) * MAX_SPLITS >= FILL_BLOCKS else 2
    splits = max(1, min(MAX_SPLITS, -(-BLOCKS_TARGET // max(blocks(rpt), 1)),
                        m // MIN_SPLIT_ROWS))
    share = -(-max(m, 1) // splits)
    stage_rows = min(STAGE_ROWS, -(-share // SEGMENT) * SEGMENT)
    # ring (12-byte rows), partial (minimum, segment row) per source
    smem = 12 * RING_DEPTH * stage_rows + 8 * THREADS * rpt
    return DenseGeometry(THREADS, rpt, splits, stage_rows, RING_DEPTH, smem)


def fma_sq_dist(src: torch.Tensor, tgt: torch.Tensor) -> torch.Tensor:
    """f32[c, M] squared distances of ``src`` f32[c, 3] to ``tgt``
    f32[M, 3], rounded as the oracle rounds them:
    ``fma(dz, dz, fma(dx, dx, dy*dy))``.  The differences and ``dy*dy``
    are single float32 operations, and each fused step is computed in
    float64 (where the product of two float32 values is exact) and
    rounded to float32.  That double rounding can differ from a true
    fused multiply-add with probability about 2**-29 per operation."""
    dx = (tgt[None, :, 0] - src[:, None, 0]).double()
    dy = tgt[None, :, 1] - src[:, None, 1]
    dz = (tgt[None, :, 2] - src[:, None, 2]).double()
    d = dx.mul_(dx).add_((dy * dy).double()).float().double()
    return dz.mul_(dz).add_(d).float()


def _chunk_nn(
    src: torch.Tensor, tgt: torch.Tensor, tgt_invalid: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``src`` f32[c, 3] against ``tgt`` f32[M, 3] (``fma_sq_dist``)."""
    d = fma_sq_dist(src, tgt)
    d = torch.where(tgt_invalid[None, :], torch.full_like(d, BIG), d)
    # argmin returns the first minimal index, as the oracle's strict '<'
    idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, idx[:, None])[:, 0]
    return idx.to(torch.int32), best


def nearest_neighbors_dense_ref(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_count: torch.Tensor,
    chunk: int = REF_CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of K1 on any device: ``src`` f32[B, N, 3],
    ``tgt`` f32[B, M, 3], ``tgt_count`` i32[B] -> (i32[B, N], f32[B, N]).
    Chunked over sources so a (chunk, M) distance block stays bounded."""
    b, n, _ = src.shape
    m = tgt.shape[1]
    rows = torch.arange(m, device=tgt.device)
    idx = torch.empty((b, n), dtype=torch.int32, device=src.device)
    dist = torch.empty((b, n), dtype=torch.float32, device=src.device)
    for p in range(b):
        invalid = rows >= tgt_count[p]
        for lo in range(0, n, chunk):
            i, d = _chunk_nn(src[p, lo:lo + chunk], tgt[p], invalid)
            idx[p, lo:lo + chunk] = i
            dist[p, lo:lo + chunk] = d
    return idx, dist


def plain_under_contract(
    src: torch.Tensor, tgt: torch.Tensor, tgt_count: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version read under K1's contract, for inputs with NaN or
    inf rows: ``torch.argmin`` takes a NaN distance, where K1 never does,
    so a valid target row holding a NaN is given as +inf (its distance
    then never wins either), and a source with no distance below 3.4e38
    reports ``(0, 3.4e38)``.  On finite inputs whose nearest distances
    stay below 3.4e38 this is the plain version, bit for bit."""
    tgt = torch.where(torch.isnan(tgt).any(-1, keepdim=True),
                      torch.full_like(tgt, float("inf")), tgt)
    idx, dist = nearest_neighbors_dense_ref(src, tgt, tgt_count)
    none = ~(dist < BIG)
    return (torch.where(none, torch.zeros_like(idx), idx),
            torch.where(none, torch.full_like(dist, BIG), dist))


def _check(src: torch.Tensor, tgt: torch.Tensor, count: torch.Tensor) -> None:
    if src.dim() != 3 or src.shape[2] != 3:
        raise ValueError(f"src must be [B, N, 3], got {tuple(src.shape)}")
    if tgt.dim() != 3 or tgt.shape[2] != 3 or tgt.shape[0] != src.shape[0]:
        raise ValueError(
            f"tgt must be [B, M, 3] with B = {src.shape[0]}, "
            f"got {tuple(tgt.shape)}"
        )
    if tuple(count.shape) != (src.shape[0],):
        raise ValueError(f"count must be [B], got {tuple(count.shape)}")
    if not (src.device == tgt.device == count.device):
        raise ValueError(
            f"src, tgt and count lie on {src.device}, {tgt.device} and "
            f"{count.device}: they must share one device"
        )
    if src.dtype != torch.float32 or tgt.dtype != torch.float32:
        raise TypeError(f"src and tgt must be float32, got {src.dtype}, {tgt.dtype}")
    if count.dtype != torch.int32:
        raise TypeError(f"count must be int32, got {count.dtype}")


def _predicated_out(arm, arm_value: int, out, shape, device):
    """The output pair of a launch: ``out`` or new tensors; with ``arm`` (a
    device i32[1] arm code) ``out`` is required, as only the selected
    launch of several writes it."""
    if arm is not None:
        if out is None:
            raise ValueError("a predicated launch writes into out=(idx, dist)")
        if arm.dtype != torch.int32 or arm.numel() != 1 or arm.device != device:
            raise ValueError("arm must be an int32 tensor of one element on the operands' device")
    if out is None:
        return (torch.empty(shape, dtype=torch.int32, device=device),
                torch.empty(shape, dtype=torch.float32, device=device))
    idx, dist = out
    if (tuple(idx.shape) != shape or tuple(dist.shape) != shape or idx.dtype != torch.int32
            or dist.dtype != torch.float32 or not idx.is_contiguous()
            or not dist.is_contiguous() or idx.device != device or dist.device != device):
        raise ValueError(f"out must be contiguous (i32{list(shape)}, f32{list(shape)}) "
                         f"on {device}")
    return idx, dist


def nearest_neighbors_dense_batch(
    src: torch.Tensor,
    tgt: torch.Tensor,
    tgt_count: torch.Tensor,
    arm: Optional[torch.Tensor] = None,
    arm_value: int = -1,
    out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on ``src`` f32[B, N, 3], ``tgt`` f32[B, M, 3], ``tgt_count``
    i32[B], all on one device -> (idx i32[B, N], dist f32[B, N]).

    On the CPU this is the plain version.  On CUDA it launches the kernel
    on the current stream (count stays on the device; nothing is read
    back) and raises if the launch is refused.

    ``arm`` (i32[1] on the device) predicates the launch: it writes
    ``out`` only where ``arm == arm_value`` (the hierarchical search's arm
    code), else returns at once; it is counted here all the same, and the
    device's tally counts it as skipped (``kernels.launch_counts``).  The
    plain version reads the code on the host."""
    global LAUNCHES
    _check(src, tgt, tgt_count)
    b, n, _ = src.shape
    idx, dist = _predicated_out(arm, arm_value, out, (b, n), src.device)
    if src.device.type == "cpu":
        if arm is None or int(arm.reshape(())) == arm_value:
            ref_idx, ref_dist = nearest_neighbors_dense_ref(src, tgt, tgt_count)
            idx.copy_(ref_idx)
            dist.copy_(ref_dist)
        return idx, dist
    if src.device.type != "cuda":
        raise RuntimeError(f"K1 runs on CPU or CUDA tensors, not {src.device}")
    for name, t in (("src", src), ("tgt", tgt), ("count", tgt_count)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    m = tgt.shape[1]
    if max(n, m) >= 2**31:
        raise ValueError(f"row counts {n}, {m} exceed the kernel's int32 indices")

    from tpuslam_torch.kernels import counted, tally_ptr
    from tpuslam_torch.kernels.build import launch

    launch(
        "tpuslam_nn_dense", src.device,
        src.data_ptr(), tgt.data_ptr(), tgt_count.data_ptr(),
        b, n, m, *dense_geometry(b, n, m),
        None if arm is None else arm.data_ptr(), arm_value,
        tally_ptr("K1", src.device), idx.data_ptr(), dist.data_ptr(),
    )
    if counted("nn_dense", b):
        LAUNCHES += 1
        BATCH_LAUNCHES[b] += 1
    return idx, dist


def nearest_neighbors_dense(
    src: torch.Tensor, tgt: torch.Tensor, tgt_count: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B=1 form: ``src`` f32[N, 3], ``tgt`` f32[M, 3], ``tgt_count`` a 0-d
    int32 tensor -> (i32[N], f32[N]).  Same dispatch as the batch form."""
    idx, dist = nearest_neighbors_dense_batch(
        src[None], tgt[None], tgt_count.reshape(1)
    )
    return idx[0], dist[0]
