"""K6 and K7: the Fast Gauss Transform's prediction and expansion — the
wrappers of the CUDA kernels ``csrc/fgt.cu`` and their plain PyTorch
versions.

No Pallas kernel stands behind them: the JAX package's FGT
(``tpuslam/ops/fgt.py``) is ``jnp`` left to XLA, and the plain versions
here are the port's torch composition of it (``ComputeFGTPredict`` and
``ComputeA_k`` of the reference's ``fgt.cpp``).  Those form every Taylor
monomial ``dy^alpha`` of every (row, centre) pair as a float32 tensor
before one contraction: at 100,000 targets and 128 centres of order 8 a
[chunk, K, pd] intermediate is 6 GB in all, written and read several
times, where the contraction itself is a few milliseconds of float32
work.  The kernels form the monomials in registers (K6) or from per-row
powers in shared memory (K7) and contract them where they are made:

* K6, ``predict``: ``out[m, w] = sum_k g(y_m, c_k) sum_alpha dy^alpha
  ak[k, alpha, w]`` over the centres inside the far-field radius, one
  launch for all M targets (the plain version's host loop over chunks of
  targets is the CPU's alone);
* K7, ``expand``: ``ak[k, alpha, w] = C_alpha sum_{n in k} g_n w_n
  dy_n^alpha`` over each cluster's rows in the ``SegmentOrder`` the
  caller keeps, with no [N, pd, W] summands.

Each monomial, ``dy``, ``|dy|^2`` and its far-field decision are rounded
as the plain version rounds them; the sums run in another fixed order
(``csrc/fgt.cu``), so the two agree to a tolerance, and two calls of a
kernel give the same bits.  Orders 6 and 8 run compiled instances of K6;
any other order from 1 to ``MAX_ORDER`` its run-time instance.  The
kernels take W = 1 (the denominators' Kt1) or W = 4 (P1 and PX) weight
columns, the plain versions any.

Dispatch: tensors on the CPU take the plain versions; CUDA tensors launch
the kernels, or raise.  There is no other path.  Both launches are
graph-safe (sigma is read on the device; outputs come from ``torch.empty``;
no host read), as the CPD loop's captured chunks need.  ``PLAIN_CALLS``
counts the plain versions' calls by device type, so a run can show that
no E-step on the card took the torch composition.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import torch

from tpuslam_torch.kernels.cpd_dense import device_scalar
from tpuslam_torch.ops.fgt import (
    SegmentOrder,
    _monomials,
    fgt_tables,
    pd_size,
    predict_chunk,
    segment_sum,
)

# kernel launches made by the wrappers below (CPU calls do not count)
PREDICT_LAUNCHES = 0
EXPAND_LAUNCHES = 0
# calls of the plain versions, by device type ("cpu", "cuda")
PLAIN_CALLS: Counter = Counter()

WIDTHS = (1, 4)  # weight columns the kernels take
MAX_ORDER = 1024  # kMaxOrder of csrc/fgt.cu
EXPAND_THREADS = 512  # kExpandThreads: K7 stages at most this many rows at once
# K7's shared memory for the staged rows' powers and weights
EXPAND_STAGE_BYTES = 40 * 1024


def _check(name: str, p: int, *tensors) -> None:
    """Raise unless the ``(label, tensor, dtype, shape)`` operands (None in
    a shape for any size) share one device and are contiguous, with the
    dtype and shape given, and ``p`` is a valid order."""
    if not isinstance(p, int) or p < 1:
        raise ValueError(f"{name}: the truncation order must be an int >= 1, got {p!r}")
    device = tensors[0][1].device
    for label, t, dtype, shape in tensors:
        if t.device != device:
            raise ValueError(f"{name}: {label} is on {t.device}, not {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: {label} must be {dtype}, got {t.dtype}")
        if t.dim() != len(shape) or any(s is not None and s != d
                                         for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name}: {label} must be {list(shape)}, got {list(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous")


def _on_card(name: str, p: int, w: int, device: torch.device) -> bool:
    """True for CUDA (launch), False for the CPU (plain version); raise
    on another device and on what the kernels do not take."""
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise RuntimeError(f"{name} runs on CPU or CUDA tensors, not {device}")
    if w not in WIDTHS:
        raise ValueError(f"{name}: the kernel takes {WIDTHS} weight columns, not {w}")
    if p > MAX_ORDER:
        raise ValueError(f"{name}: the kernel takes orders up to {MAX_ORDER}, not {p}")
    return True


def _sigma(sigma, device) -> torch.Tensor:
    s = device_scalar(sigma, torch.float32, device)
    if s.numel() != 1:
        raise ValueError(f"sigma must hold one value, got {list(s.shape)}")
    return s.contiguous()


def predict_plain(targets: torch.Tensor, centers: torch.Tensor, ak: torch.Tensor, sigma,
                  e_param: float, p: int, chunk: Optional[int] = None) -> torch.Tensor:
    """The torch composition of ``predict`` (``ComputeFGTPredict``,
    ``fgt.cpp:90-145``), in chunks of ``chunk`` targets
    (``ops/fgt.py::predict_chunk`` when None): per chunk the [chunk, K,
    pd] monomials and one float32 matrix product (TF32 stays off,
    ``ops/procrustes.py``)."""
    PLAIN_CALLS[targets.device.type] += 1
    m = targets.shape[0]
    k, pd, w = ak.shape
    if chunk is None:
        chunk = predict_chunk(targets.device, k, p)
    flat = ak.reshape(k * pd, w)
    out = torch.empty((m, w), dtype=torch.float32, device=targets.device)
    for lo in range(0, m, chunk):
        tgt = targets[lo:lo + chunk]
        dy = (tgt[:, None, :] - centers[None, :, :]) / sigma
        s = torch.sum(dy * dy, dim=-1)  # [c, K]
        g = torch.where(s > e_param, torch.zeros_like(s), torch.exp(-s))
        prods = _monomials(dy, p)  # [c, K, pd]
        out[lo:lo + chunk] = torch.matmul(
            (g[:, :, None] * prods).reshape(tgt.shape[0], k * pd), flat)
    return out


def predict(targets: torch.Tensor, centers: torch.Tensor, ak: torch.Tensor, sigma,
            e_param: float, p: int, chunk: Optional[int] = None) -> torch.Tensor:
    """K6: f32[M, W] approximate Gauss transforms of ``targets`` f32[M, 3]
    from the expansions ``ak`` f32[K, pd, W] about ``centers`` f32[K, 3];
    clusters beyond the far-field radius (``|dy|^2 > e_param``) add zero.
    ``sigma`` is the FGT's bandwidth (a device scalar or a number).  The
    CPU takes the plain version (``chunk`` targets a step); CUDA launches
    the kernel once on the current stream."""
    global PREDICT_LAUNCHES
    k = centers.shape[0] if centers.dim() == 2 else -1
    _check("fgt predict", p, ("targets", targets, torch.float32, (None, 3)),
           ("centers", centers, torch.float32, (None, 3)),
           ("ak", ak, torch.float32, (k, pd_size(p), None)))
    if not _on_card("fgt predict", p, ak.shape[2], targets.device):
        return predict_plain(targets, centers, ak, sigma, e_param, p, chunk)
    from tpuslam_torch.kernels import counted, tally_ptr
    from tpuslam_torch.kernels.build import launch

    dev = targets.device
    m, w = targets.shape[0], ak.shape[2]
    out = torch.empty((m, w), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    h = _sigma(sigma, dev)
    launch("tpuslam_fgt_predict", dev, targets.data_ptr(), centers.data_ptr(), ak.data_ptr(),
           h.data_ptr(), fgt_tables(p, dev).alpha.data_ptr(), m, k, p, w, float(e_param),
           tally_ptr("K6", dev), out.data_ptr())
    if counted("fgt", 1):
        PREDICT_LAUNCHES += 1
    return out


def expand_geometry(p: int, w: int) -> tuple:
    """K7's (rows staged at once, dynamic shared memory bytes) at order
    ``p`` and ``w`` weight columns: as many rows as ``EXPAND_STAGE_BYTES``
    holds (3 p powers and w weights a row), at most ``EXPAND_THREADS``;
    the memory also holds each thread's w sums for the groups' combine.
    The C entry point refuses any other."""
    rows = min(EXPAND_THREADS, EXPAND_STAGE_BYTES // (4 * (3 * p + w)))
    if rows < 1:
        raise ValueError(f"fgt expand: order {p} leaves no room to stage a row")
    return rows, 4 * max(rows * (3 * p + w), EXPAND_THREADS * w)


def expand_plain(points: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor, sigma,
                 centers: torch.Tensor, indx: torch.Tensor, order: SegmentOrder,
                 p: int) -> torch.Tensor:
    """The torch composition of ``expand`` (``ComputeA_k``,
    ``fgt.cpp:262-303``): the [N, pd, W] summands formed in the rows'
    ``order`` and summed per cluster (``ops/fgt.py::segment_sum``), then
    scaled by ``C_alpha``."""
    PLAIN_CALLS[points.device.type] += 1
    rows = order.order
    dy = (points.index_select(0, rows)
          - centers.index_select(0, indx.index_select(0, rows))) / sigma
    g = torch.exp(-torch.sum(dy * dy, dim=-1)) * mask.index_select(0, rows)
    prods = _monomials(dy, p)  # [N, pd]
    contrib = prods[:, :, None] * (g[:, None, None]
                                   * weights.index_select(0, rows)[:, None, :])
    ak = segment_sum(contrib, order.lengths)
    c = fgt_tables(p, points.device).coeff
    return ak * c[None, :, None]


def expand(points: torch.Tensor, weights: torch.Tensor, mask: torch.Tensor, sigma,
           centers: torch.Tensor, indx: torch.Tensor, order: SegmentOrder,
           p: int) -> torch.Tensor:
    """K7: the expansions ``ak`` f32[K, pd, W] of ``points`` f32[N, 3] with
    ``weights`` f32[N, W] and ``mask`` f32[N] (zero on padded rows) about
    ``centers`` f32[K, 3], for the assignments ``indx`` i32[N] and their
    ``order`` (``ops/fgt.py::segment_order``).  The CPU takes the plain
    version; CUDA launches the kernel once on the current stream, a block
    a cluster, which reads the rows through ``order`` alone."""
    global EXPAND_LAUNCHES
    n = points.shape[0] if points.dim() == 2 else -1
    k = centers.shape[0] if centers.dim() == 2 else -1
    _check("fgt expand", p, ("points", points, torch.float32, (None, 3)),
           ("weights", weights, torch.float32, (n, None)),
           ("mask", mask, torch.float32, (n,)),
           ("centers", centers, torch.float32, (None, 3)),
           ("indx", indx, indx.dtype, (n,)),
           ("order", order.order, torch.int64, (n,)),
           ("lengths", order.lengths, torch.int64, (k,)))
    if not _on_card("fgt expand", p, weights.shape[1], points.device):
        return expand_plain(points, weights, mask, sigma, centers, indx, order, p)
    from tpuslam_torch.kernels import counted, tally_ptr
    from tpuslam_torch.kernels.build import launch

    dev = points.device
    w, pd = weights.shape[1], pd_size(p)
    ak = torch.empty((k, pd, w), dtype=torch.float32, device=dev)
    if k == 0:
        return ak
    rows, smem = expand_geometry(p, w)
    tables = fgt_tables(p, dev)
    h = _sigma(sigma, dev)
    launch("tpuslam_fgt_expand", dev, points.data_ptr(), weights.data_ptr(), mask.data_ptr(),
           centers.data_ptr(), order.order.data_ptr(), order.lengths.data_ptr(), h.data_ptr(),
           tables.alpha.data_ptr(), tables.coeff.data_ptr(), n, k, p, w, rows, smem,
           tally_ptr("K7", dev), ak.data_ptr())
    if counted("fgt", 1):
        EXPAND_LAUNCHES += 1
    return ak
