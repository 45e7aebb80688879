"""K1: dense exact nearest-neighbour search — the wrapper of the CUDA
kernel ``csrc/nn_dense.cu`` and its plain PyTorch version.

Port of ``tpuslam/kernels/pallas_nn.py::nearest_neighbors_pallas_batch``
and its B=1 form ``nearest_neighbors_pallas``.  For each source row: the
index and squared distance of the nearest valid target row (index <
count), the first index winning a tie, ``(0, 3.4e38)`` when there is no
valid target.

Dispatch: a tensor on the CPU takes the plain version; a CUDA tensor
launches the kernel, or raises.  There is no other path.
"""

from __future__ import annotations

from typing import Tuple

import torch

BIG = 3.4e38  # no-match distance, the JAX oracle's float32(3.4e38)
# source rows per chunk of the plain version: a chunk holds a few
# (chunk, M) float64 temporaries, about 4 GB at M = 102,400
REF_CHUNK = 1024

# kernel launches made by the wrappers below (CPU calls do not count)
LAUNCHES = 0


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


def nearest_neighbors_dense_batch(
    src: torch.Tensor, tgt: torch.Tensor, tgt_count: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on ``src`` f32[B, N, 3], ``tgt`` f32[B, M, 3], ``tgt_count``
    i32[B], all on one device -> (idx i32[B, N], dist f32[B, N]).

    On the CPU this is the plain version.  On CUDA it launches the kernel
    on the current stream (count stays on the device; nothing is read
    back) and raises if the launch is refused."""
    global LAUNCHES
    _check(src, tgt, tgt_count)
    if src.device.type == "cpu":
        return nearest_neighbors_dense_ref(src, tgt, tgt_count)
    if src.device.type != "cuda":
        raise RuntimeError(f"K1 runs on CPU or CUDA tensors, not {src.device}")
    for name, t in (("src", src), ("tgt", tgt), ("count", tgt_count)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, n, _ = src.shape
    m = tgt.shape[1]
    if max(n, m) >= 2**31:
        raise ValueError(f"row counts {n}, {m} exceed the kernel's int32 indices")

    from tpuslam_torch.kernels.build import launch

    idx = torch.empty((b, n), dtype=torch.int32, device=src.device)
    dist = torch.empty((b, n), dtype=torch.float32, device=src.device)
    launch(
        "tpuslam_nn_dense", src.device,
        src.data_ptr(), tgt.data_ptr(), tgt_count.data_ptr(),
        b, n, m, idx.data_ptr(), dist.data_ptr(),
    )
    LAUNCHES += 1
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
