"""P: weighted Procrustes with a 3x3 SVD, the ICP error sum and the CPD
M-step's moments — the wrappers of the CUDA kernels ``csrc/procrustes.cu``
and their plain PyTorch versions.

Port-only: the JAX package computes these with ``jnp`` outside any
Pallas kernel (``tpuslam/ops/procrustes.py:47-67``, the error at
``tpuslam/algorithms/icp.py:173-174``, the M-step's sums at
``tpuslam/algorithms/cpd.py:408``), inside its loops' one device
program.  The plain versions are the port's CPU path: ``torch.sum`` and
``torch.linalg.svd``/``det``, which on CUDA are cuSOLVER calls that read
the host.  The kernels read nothing back, so an ICP or CPD iteration can
run inside a CUDA graph.

* ``weighted_procrustes_batch``: before, after f32[B, N, 3], w f32[B, N]
  -> R f32[B, 3, 3], t f32[B, 3] (the JAX formula: two centred passes,
  ``R = U diag(1, 1, det(U V^T)) V^T``, ``t = mu_a - R mu_b``); two
  launches;
* ``svd_rotation_det_batch``: h f32[B, 3, 3] -> (R, s descending, det(U V^T)),
  the CPD M-step's entry (its scale uses ``s0 + s1 + det s2``); one launch;
* ``mean_sq_error_batch``: diff f32[B, N, 3], w f32[B, N], n_corr f32[B]
  -> ``sum w |diff|^2 / max(n_corr, 1)`` f32[B]; one launch;
* ``mstep_moments_batch``: p1 f32[B, M], moving f32[B, M, 3], px
  f32[B, M, 3], pt1 f32[B, N], target f32[B, N, 3] -> the M-step's sums
  f64[B, 18] (``MSTEP_SUMS``); one launch.

The kernels sum a pair's rows in float64 over a fixed partition of
``CHUNK_ROWS`` rows and add the partials in a fixed order (the last
block of a pair to finish adds them), so a pair of a batch gets the bits
of its solo call.  The plain versions of Procrustes and the error sum in
float32 in torch's order and run pair by pair (``per_pair``): kernel and
plain agree to float32 rounding, not bit for bit.  The plain version of
the moments sums in float64, per chunk of ``CHUNK_ROWS`` rows, the
chunks' partials added in index order.  A non-finite cross-covariance
gives a NaN R, s and det on both (``torch.linalg.svd`` would raise: the
plain version feeds it zeros and replaces the result, without a host
read).

Dispatch: tensors on the CPU take the plain versions; CUDA tensors launch
the kernels, or raise.  There is no other path.
"""

from __future__ import annotations

from collections import Counter
from typing import Tuple

import torch

from tpuslam_torch.ops.geometry import per_pair

# rows a block sums: the fixed partition of a pair's rows (200 blocks at
# 102,400 rows, two an SM on the H100's 132)
CHUNK_ROWS = 512
# the M-step's sums (y the moving rows, x the target rows), in order
MSTEP_SUMS = ("sum p1", "sum p1 y (3)", "sum pt1 x (3)", "sum px y^T (9, row-major)",
              "sum pt1 |x|^2", "sum p1 |y|^2")
MSTEP_WIDTH = 18

# kernel launches made by the wrappers below (CPU calls do not count), in
# all (every entry), by entry (kernels.P_ENTRIES) and by batch size B; a
# launch captured into a CUDA graph counts at each replay, booked by the
# device-resident loops (kernels.book_replay)
LAUNCHES = 0
ENTRY_LAUNCHES: Counter = Counter()
BATCH_LAUNCHES: Counter = Counter()


def svd_rotation_det_ref(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the SVD entry for one f32[3, 3] ``h``:
    ``(R, s, det(U V^T))`` by ``torch.linalg.svd``/``det``."""
    finite = torch.isfinite(h).all()
    u, s, vt = torch.linalg.svd(
        torch.where(finite, h, torch.zeros_like(h)), full_matrices=False
    )
    det = torch.linalg.det(torch.matmul(u, vt))
    d = torch.cat(
        [torch.ones(2, dtype=h.dtype, device=h.device), det.reshape(1)]
    )
    r = torch.matmul(u * d[None, :], vt)
    nan = torch.full_like(r, float("nan"))
    return (torch.where(finite, r, nan), torch.where(finite, s, nan[0]),
            torch.where(finite, det, nan[0, 0]))


def weighted_procrustes_ref(
    before: torch.Tensor, after: torch.Tensor, weights: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version for one pair: ``before``/``after`` f32[N, 3],
    ``weights`` f32[N] -> (R f32[3, 3], t f32[3])."""
    w = weights.to(before.dtype)
    total = torch.clamp_min(torch.sum(w), 1e-12)
    mu_b = torch.sum(before * w[:, None], dim=0) / total
    mu_a = torch.sum(after * w[:, None], dim=0) / total
    bc = before - mu_b
    ac = after - mu_a
    # H = sum_i w_i ac_i bc_i^T  (common.cpp:530)
    h = torch.matmul((ac * w[:, None]).T, bc)
    r, _, _ = svd_rotation_det_ref(h)
    t = mu_a - torch.matmul(r, mu_b)
    return r, t


def mean_sq_error_ref(diff: torch.Tensor, w: torch.Tensor, n_corr: torch.Tensor) -> torch.Tensor:
    """The plain version of the error entry for one pair."""
    return torch.sum(torch.sum(diff * diff, dim=-1) * w) / torch.clamp_min(n_corr, 1.0)


def _chunked_sum(values: torch.Tensor) -> torch.Tensor:
    """float64 sums of ``values`` f64[R, K] over rows: one ``torch.sum``
    a chunk of ``CHUNK_ROWS`` rows, then the chunks' partials added in
    index order (a sequential ``cumsum``)."""
    rows, k = values.shape
    nch = _chunks(rows)
    padded = torch.nn.functional.pad(values, (0, 0, 0, nch * CHUNK_ROWS - rows))
    parts = torch.sum(padded.reshape(nch, CHUNK_ROWS, k), dim=1)
    return torch.cumsum(parts, dim=0)[-1]


def mstep_moments_ref(p1: torch.Tensor, moving: torch.Tensor, px: torch.Tensor,
                      pt1: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The plain version of the moments entry for one pair: ``p1`` f32[M],
    ``moving`` f32[M, 3], ``px`` f32[M, 3], ``pt1`` f32[N], ``target``
    f32[N, 3] -> f64[18] in ``MSTEP_SUMS``'s order, each product of two
    floats exact in float64."""
    p, y, x = p1.double(), moving.double(), px.double()
    q, t = pt1.double(), target.double()
    side_m = torch.cat([p[:, None], p[:, None] * y, (x[:, :, None] * y[:, None, :]).reshape(-1, 9),
                        (p * torch.sum(y * y, dim=1))[:, None]], dim=1)
    side_n = torch.cat([q[:, None] * t, (q * torch.sum(t * t, dim=1))[:, None]], dim=1)
    sm, sn = _chunked_sum(side_m), _chunked_sum(side_n)
    return torch.cat([sm[0:4], sn[0:3], sm[4:13], sn[3:4], sm[13:14]])


def _rows_check(name: str, rows: torch.Tensor, w: torch.Tensor, *others: torch.Tensor) -> None:
    if rows.dim() != 3 or rows.shape[2] != 3:
        raise ValueError(f"{name}: rows must be [B, N, 3], got {tuple(rows.shape)}")
    if tuple(w.shape) != tuple(rows.shape[:2]):
        raise ValueError(f"{name}: weights must be {tuple(rows.shape[:2])}, got {tuple(w.shape)}")
    for t in (rows, w, *others):
        if t.device != rows.device:
            raise ValueError(f"{name}: operands must share one device")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: operands must be float32, got {t.dtype}")
    if rows.shape[0] > 65535 or rows.shape[1] >= 2**31:
        raise ValueError(f"{name}: {tuple(rows.shape)} exceeds the kernel's grid")


def _device_of(name: str, t: torch.Tensor) -> bool:
    """True for CUDA (launch), False for the CPU (plain version)."""
    if t.device.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{name} runs on CPU or CUDA tensors, not {t.device}")
    return t.device.type == "cuda"


def _chunks(n: int) -> int:
    """Blocks of a pair's ``n`` rows: at least one, so a pair of no rows
    still has a block that writes its result."""
    return max(1, -(-n // CHUNK_ROWS))


def _launch(name: str, entry: str, device: torch.device, batch: int, *args) -> None:
    """Launch entry point ``name`` (kernel P's entry ``entry`` of
    ``kernels.P_ENTRIES``) with ``args`` and the entry's tally row."""
    global LAUNCHES
    from tpuslam_torch.kernels import counted, tally_ptr
    from tpuslam_torch.kernels.build import launch

    launch(name, device, *args, tally_ptr(entry, device))
    if counted("procrustes", batch):
        LAUNCHES += 1
        ENTRY_LAUNCHES[entry] += 1
        BATCH_LAUNCHES[batch] += 1


def weighted_procrustes_batch(
    before: torch.Tensor, after: torch.Tensor, weights: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """P on ``before``, ``after`` f32[B, N, 3] and ``weights`` f32[B, N] ->
    (R f32[B, 3, 3], t f32[B, 3]); two launches for all B pairs on CUDA,
    the plain version pair by pair on the CPU."""
    _rows_check("weighted_procrustes", before, weights, after)
    if after.shape != before.shape:
        raise ValueError(f"after {tuple(after.shape)} must match before {tuple(before.shape)}")
    if not _device_of("weighted_procrustes", before):
        return per_pair(weighted_procrustes_ref, before, after, weights)
    from tpuslam_torch.kernels import arrivals_ptr

    before, after, weights = (t.contiguous() for t in (before, after, weights))
    b, n, _ = before.shape
    nch = _chunks(n)
    dev = before.device
    part1 = torch.empty((b, nch, 7), dtype=torch.float64, device=dev)
    means = torch.empty((b, 8), dtype=torch.float32, device=dev)
    part2 = torch.empty((b, nch, 9), dtype=torch.float64, device=dev)
    r = torch.empty((b, 3, 3), dtype=torch.float32, device=dev)
    t = torch.empty((b, 3), dtype=torch.float32, device=dev)
    _launch("tpuslam_procrustes", "P procrustes", dev, b, before.data_ptr(), after.data_ptr(),
            weights.data_ptr(), b, n, CHUNK_ROWS, nch, part1.data_ptr(), means.data_ptr(),
            part2.data_ptr(), arrivals_ptr(dev), r.data_ptr(), t.data_ptr())
    return r, t


def svd_rotation_det_batch(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The SVD entry on ``h`` f32[B, 3, 3] -> (R f32[B, 3, 3], s f32[B, 3]
    descending, det f32[B]); one launch on CUDA, the plain version pair by
    pair on the CPU."""
    if h.dim() != 3 or tuple(h.shape[1:]) != (3, 3):
        raise ValueError(f"h must be [B, 3, 3], got {tuple(h.shape)}")
    if h.dtype != torch.float32:
        raise TypeError(f"h must be float32, got {h.dtype}")
    if not _device_of("svd_rotation_det", h):
        return per_pair(svd_rotation_det_ref, h)
    h = h.contiguous()
    b = h.shape[0]
    r = torch.empty((b, 3, 3), dtype=torch.float32, device=h.device)
    s = torch.empty((b, 3), dtype=torch.float32, device=h.device)
    det = torch.empty((b,), dtype=torch.float32, device=h.device)
    _launch("tpuslam_svd_rotation_det", "P svd", h.device, b, h.data_ptr(), b, r.data_ptr(),
            s.data_ptr(), det.data_ptr())
    return r, s, det


def mean_sq_error_batch(diff: torch.Tensor, w: torch.Tensor, n_corr: torch.Tensor) -> torch.Tensor:
    """The error entry on ``diff`` f32[B, N, 3], ``w`` f32[B, N] and
    ``n_corr`` f32[B] -> f32[B]; one launch on CUDA, the plain version
    pair by pair on the CPU."""
    _rows_check("mean_sq_error", diff, w, n_corr)
    if tuple(n_corr.shape) != (diff.shape[0],):
        raise ValueError(f"n_corr must be [{diff.shape[0]}], got {tuple(n_corr.shape)}")
    if not _device_of("mean_sq_error", diff):
        return per_pair(mean_sq_error_ref, diff, w, n_corr)
    from tpuslam_torch.kernels import arrivals_ptr

    diff, w, n_corr = (t.contiguous() for t in (diff, w, n_corr))
    b, n, _ = diff.shape
    nch = _chunks(n)
    part = torch.empty((b, nch), dtype=torch.float64, device=diff.device)
    err = torch.empty((b,), dtype=torch.float32, device=diff.device)
    _launch("tpuslam_masked_sq_error", "P error", diff.device, b, diff.data_ptr(), w.data_ptr(),
            n_corr.data_ptr(), b, n, CHUNK_ROWS, nch, part.data_ptr(), arrivals_ptr(diff.device),
            err.data_ptr())
    return err


def mstep_moments_batch(p1: torch.Tensor, moving: torch.Tensor, px: torch.Tensor,
                        pt1: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The moments entry: ``p1`` f32[B, M], ``moving`` f32[B, M, 3], ``px``
    f32[B, M, 3], ``pt1`` f32[B, N], ``target`` f32[B, N, 3] -> the CPD
    M-step's sums f64[B, 18] (``MSTEP_SUMS``); one launch for all B pairs
    on CUDA, the plain version pair by pair on the CPU."""
    _rows_check("mstep_moments", moving, p1, px)
    _rows_check("mstep_moments", target, pt1)
    if px.shape != moving.shape or target.shape[0] != moving.shape[0]:
        raise ValueError(f"px {tuple(px.shape)} must match moving {tuple(moving.shape)}, and "
                         f"target {tuple(target.shape)} its pairs")
    if target.device != moving.device:
        raise ValueError("mstep_moments: operands must share one device")
    if not _device_of("mstep_moments", moving):
        return per_pair(mstep_moments_ref, p1, moving, px, pt1, target)
    from tpuslam_torch.kernels import arrivals_ptr

    p1, moving, px, pt1, target = (t.contiguous() for t in (p1, moving, px, pt1, target))
    b, m, _ = moving.shape
    n = target.shape[1]
    ch_m, ch_n = _chunks(m), _chunks(n)
    dev = moving.device
    part = torch.empty((b, ch_m + ch_n, MSTEP_WIDTH), dtype=torch.float64, device=dev)
    sums = torch.empty((b, MSTEP_WIDTH), dtype=torch.float64, device=dev)
    _launch("tpuslam_mstep_moments", "P moments", dev, b, p1.data_ptr(), moving.data_ptr(),
            px.data_ptr(), m, pt1.data_ptr(), target.data_ptr(), n, b, CHUNK_ROWS, ch_m, ch_n,
            part.data_ptr(), arrivals_ptr(dev), sums.data_ptr())
    return sums
