"""K4: the dense two-pass CPD E-step — the wrappers of the CUDA kernels
``csrc/cpd_dense.cu`` and their plain PyTorch versions.

Port of ``tpuslam/kernels/pallas_cpd.py``: ``denom_pass_batch`` (phase
1), ``moments_pass_batch`` (phase 2) and the wrappers around them,
``cpd_estep_pallas_batch`` and its B=1 form ``cpd_estep_pallas``, here
``cpd_estep_dense_batch`` and ``cpd_estep_dense``.  The N x M
responsibility matrix is never materialised: phase 1 gives each target
row its denominator ``c + sum_m exp(-|x_n - Ty_m|^2 / 2 sigma^2)``,
phase 2 each moving row ``sum_n g_mn [1/denom_n, x_n/denom_n]``, both as
running totals over blocks of ``TILE`` rows of the other cloud in
ascending order.  With truncation on, terms whose exponent is below
``log(truncate)`` are 0.

The Gaussian is rounded as XLA rounds ``pallas_cpd._gauss`` on the CPU:
``d = fma(dz, dz, fma(dx, dx, dy*dy))`` (``kernels/nn_dense.fma_sq_dist``,
K1's distance), then ``expo = mult * d`` in float32, so the truncation
decisions are those of the JAX package.  The plain version takes
``torch.exp(expo)``; the kernel takes one ``ex2.approx`` (a few ulps
apart, ``csrc/cpd_gauss.cuh``).  Inside a block the plain version sums in
torch's order and the kernel in its own fixed order; they agree to a
tolerance, not bit for bit.

Launch geometry (``cpd_geometry``): ``THREADS`` threads a CTA, each
holding 1 or 2 output rows, and on small grids the other cloud's blocks
split over several CTAs (per-block partials, added in order by a second
kernel); the C entry points refuse any other.  The kernel's summation
order does not depend on it, so K5 (which uses the same function)
equals K4 bit for bit at any geometry.

Predication (``pred``, ``pred_value``, ``live``, ``out``), for the CPD
loop captured as a CUDA graph, which cannot read the host to choose K5's
route: a pass given a device route code runs only where it equals
``pred_value`` and otherwise writes nothing into ``out``; a pass given a
device count of ``live`` rows covers a fixed capacity of rows and writes
only the first ``live`` (``kernels/cpd_cand.py``'s fat blocks).  The
launch is counted all the same, and the device's tally counts it as
skipped where it did no work.  The plain versions read both on the host.

Dispatch: tensors on the CPU take the plain versions; CUDA tensors
launch the kernels, or raise.  There is no other path.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import NamedTuple, Optional

import torch

from tpuslam_torch.core.types import Sufficient, round_up
from tpuslam_torch.kernels.nn_dense import fma_sq_dist
from tpuslam_torch.ops.geometry import per_pair

TILE = 1024  # rows per block of the running totals, the JAX _TILE
# padded moving rows: far enough that the Gaussian underflows to 0, near
# enough that d^2 stays finite in float32
SENTINEL = 1e15

# kernel launches made by the wrappers below (CPU calls do not count),
# and the launches of both passes by batch size
DENOM_LAUNCHES = 0
MOMENTS_LAUNCHES = 0
BATCH_LAUNCHES: Counter = Counter()

THREADS = 64  # threads a CTA: kCpdThreads of csrc/cpd_gauss.cuh
# a grid of at least this many threads keeps 8 warps on each of the H100's
# 132 SMs: only then does a thread take 2 rows (half the threads)
FILL_THREADS = 132 * 8 * 32
# below that, the other cloud's blocks are split over CTAs until the grid
# holds this many threads (half of what the card keeps resident)
SPLIT_THREADS = 132 * 1024


class CpdGeometry(NamedTuple):
    """Launch geometry of K4's and K5's passes."""

    threads: int  # threads a CTA
    rows_per_thread: int  # output rows a thread holds (kR)
    splits: int  # K4: CTAs that share a row's blocks of the other cloud

    @property
    def cta_rows(self) -> int:
        return self.threads * self.rows_per_thread


def cpd_geometry(rows: int, batch: int = 1, other_blocks: int = 1) -> CpdGeometry:
    """The geometry of a pass over ``rows`` output rows per pair (a
    multiple of ``TILE``) for ``batch`` pairs against ``other_blocks``
    blocks of the other cloud: 2 rows a thread, so that one shared load
    serves both, wherever the grid still has ``FILL_THREADS`` threads
    (376,401 rows: 2,944 CTAs of 128 rows); else 1 row a thread, and K4
    splits the other cloud's blocks over up to ``SPLIT_THREADS / rows``
    CTAs (20,480 rows: 7 splits of 20 blocks; K5's fat blocks at 376k:
    3,072 rows, 44 splits of 368).  K5 walks its own tables and does not
    split."""
    if batch * rows // 2 >= FILL_THREADS:
        return CpdGeometry(THREADS, 2, 1)
    want = -(-SPLIT_THREADS // max(batch * rows, 1))
    return CpdGeometry(THREADS, 1, max(1, min(other_blocks, want)))


def gauss_tile(rows: torch.Tensor, block: torch.Tensor,
               scalars: torch.Tensor) -> torch.Tensor:
    """f32[R, B] Gaussian of ``rows`` f32[R, 3] against ``block`` f32[B, 3]
    under one pair's ``scalars`` f32[4] = (mult, c, truncation flag,
    log(truncate))."""
    expo = scalars[0] * fma_sq_dist(rows, block)
    g = torch.exp(expo)
    cut = torch.logical_and(scalars[2] != 0, expo < scalars[3])
    return torch.where(cut, torch.zeros_like(g), g)


def _kept(g: torch.Tensor, keep) -> torch.Tensor:
    return g if keep is None else torch.where(keep, g, torch.zeros_like(g))


def denom_partial(rows: torch.Tensor, block: torch.Tensor,
                  scalars: torch.Tensor, keep=None) -> torch.Tensor:
    """f32[TILE]: each of ``TILE`` target rows' partial sum over one block
    of ``TILE`` moving rows; terms outside ``keep`` bool[TILE, TILE]
    (where given) count as 0."""
    return torch.sum(_kept(gauss_tile(rows, block, scalars), keep), dim=1)


def moments_partial(rows: torch.Tensor, block: torch.Tensor,
                    weights: torch.Tensor, scalars: torch.Tensor,
                    keep=None) -> torch.Tensor:
    """f32[4, TILE]: each of ``TILE`` moving rows' four moment partials
    over one block of ``TILE`` target rows with their ``weights``
    f32[TILE, 4] (``keep`` as in ``denom_partial``)."""
    g = _kept(gauss_tile(rows, block, scalars), keep)
    return torch.stack(
        [torch.sum(g * weights[:, c], dim=1) for c in range(4)])


def denom_rows(scalars: torch.Tensor, ty: torch.Tensor, rows: torch.Tensor,
               blocks, keep=None) -> torch.Tensor:
    """The plain running total of phase 1 for one block of ``TILE`` target
    ``rows``: the constant, then one partial per moving block of
    ``blocks`` in the order given (``keep``: block id -> the bool[TILE,
    TILE] terms K5 folds, where given).  K4's and K5's plain versions both
    build on it, always on (TILE, TILE) tiles: torch's CPU ``exp`` rounds
    an element by its vector or its scalar path depending on where the
    element falls in the tensor's split across threads, so equal shapes
    are what makes the two plain versions equal bit for bit."""
    run = scalars[1].expand(TILE).clone()
    for j in blocks:
        run = run + denom_partial(rows, ty[j * TILE:(j + 1) * TILE], scalars,
                                  None if keep is None else keep[j])
    return run


def moments_rows(scalars: torch.Tensor, ty_rows: torch.Tensor,
                 target: torch.Tensor, weights4: torch.Tensor,
                 blocks, keep=None) -> torch.Tensor:
    """The plain running totals of phase 2 for one block of ``TILE``
    moving rows over the target blocks of ``blocks`` (see
    ``denom_rows``)."""
    run = torch.zeros((4, TILE), dtype=torch.float32, device=ty_rows.device)
    for i in blocks:
        sl = slice(i * TILE, (i + 1) * TILE)
        run = run + moments_partial(ty_rows, target[sl], weights4[sl], scalars,
                                    None if keep is None else keep[i])
    return run


def denom_pass_ref(scalars: torch.Tensor, ty: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
    """The plain version of phase 1 on any device: ``scalars`` f32[B, 4],
    ``ty`` f32[B, M, 3], ``target`` f32[B, N, 3] (M, N multiples of
    ``TILE``) -> ``denom`` f32[B, 1, N]."""
    b, m, _ = ty.shape
    n = target.shape[1]
    out = torch.empty((b, 1, n), dtype=torch.float32, device=ty.device)
    for p in range(b):
        for i in range(0, n, TILE):
            out[p, 0, i:i + TILE] = denom_rows(
                scalars[p], ty[p], target[p, i:i + TILE], range(m // TILE))
    return out


def moments_pass_ref(scalars: torch.Tensor, ty: torch.Tensor,
                     target: torch.Tensor, weights4: torch.Tensor) -> torch.Tensor:
    """The plain version of phase 2 on any device: ``weights4``
    f32[B, N, 4] beside phase 1's operands -> ``acc`` f32[B, 4, M]."""
    b, m, _ = ty.shape
    n = target.shape[1]
    out = torch.empty((b, 4, m), dtype=torch.float32, device=ty.device)
    for p in range(b):
        for j in range(0, m, TILE):
            out[p, :, j:j + TILE] = moments_rows(
                scalars[p], ty[p, j:j + TILE], target[p], weights4[p],
                range(n // TILE))
    return out


def _check(scalars, ty, target, weights4=None) -> None:
    if scalars.dim() != 2 or scalars.shape[1] != 4:
        raise ValueError(f"scalars must be [B, 4], got {tuple(scalars.shape)}")
    b = scalars.shape[0]
    for name, t, width in (("ty", ty, 3), ("target", target, 3),
                           ("weights4", weights4, 4)):
        if t is None:
            continue
        if t.dim() != 3 or t.shape[0] != b or t.shape[2] != width:
            raise ValueError(f"{name} must be [{b}, *, {width}], got {tuple(t.shape)}")
        if t.shape[1] % TILE:
            raise ValueError(f"{name} rows {t.shape[1]} must be a multiple of {TILE}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if weights4 is not None and weights4.shape[1] != target.shape[1]:
        raise ValueError("weights4 and target must have the same rows")
    if scalars.dtype != torch.float32:
        raise TypeError(f"scalars must be float32, got {scalars.dtype}")
    tensors = [t for t in (scalars, ty, target, weights4) if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("K4's operands must share one device")


def cuda_ready(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every operand is a contiguous, 16-byte aligned CUDA
    tensor of fewer than 2**31 elements (the kernels index rows with
    int)."""
    for t in tensors:
        if t.device.type != "cuda":
            raise RuntimeError(f"{name} runs on CPU or CUDA tensors, not {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
        if t.numel() >= 2**31:
            raise ValueError(f"{name}: sizes exceed the kernel's int indexing")


def _partials(geo: CpdGeometry, shape, device):
    """The split passes' scratch: one partial per (pair, block of the other
    cloud, statistic, row), or None without a split."""
    if geo.splits == 1:
        return None
    return torch.empty(shape, dtype=torch.float32, device=device)


def _predicate(pred, pred_value: int, live, out, shape, device):
    """Check a predicated pass's operands and give its output: ``out``, or
    a new tensor of ``shape``.  ``pred`` (a device i32[1] route code) needs
    ``out``, as only the selected pass of several writes it; ``live`` (a
    device i32[1] row count) is one pair's."""
    for name, t in (("pred", pred), ("live", live)):
        if t is not None and (t.dtype != torch.int32 or t.numel() != 1 or t.device != device):
            raise ValueError(f"{name} must be an int32 tensor of one element on {device}")
    if live is not None and shape[0] != 1:
        raise ValueError("live counts the rows of one pair")
    if out is None:
        if pred is not None or live is not None:
            raise ValueError("a predicated pass writes into out")
        return torch.empty(shape, dtype=torch.float32, device=device)
    if (tuple(out.shape) != tuple(shape) or out.dtype != torch.float32
            or not out.is_contiguous() or out.device != device):
        raise ValueError(f"out must be a contiguous f32{list(shape)} on {device}")
    return out


def _selected(pred, pred_value: int) -> bool:
    """The plain versions' predicate, read on the host."""
    return pred is None or int(pred.reshape(())) == pred_value


def _live_rows(live, rows: int) -> int:
    return rows if live is None else max(0, min(rows, int(live.reshape(()))))


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


def denom_pass_batch(scalars: torch.Tensor, ty: torch.Tensor,
                     target: torch.Tensor, pred: Optional[torch.Tensor] = None,
                     pred_value: int = 0, live: Optional[torch.Tensor] = None,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase 1 (``pallas_cpd.denom_pass_batch``): ``denom`` f32[B, 1, N]
    for every target row over all moving rows, starting from the uniform
    constant.  Shapes must be ``TILE`` multiples.  The CPU takes the plain
    version; CUDA launches the kernel on the current stream.  ``pred``,
    ``pred_value``, ``live`` (target rows) and ``out``: the module
    docstring's predication."""
    global DENOM_LAUNCHES
    _check(scalars, ty, target)
    b, m, _ = ty.shape
    n = target.shape[1]
    denom = _predicate(pred, pred_value, live, out, (b, 1, n), ty.device)
    if ty.device.type == "cpu":
        if _selected(pred, pred_value):
            rows = _live_rows(live, n)
            if rows:
                denom[:, :, :rows] = denom_pass_ref(scalars, ty, target[:, :rows])
        return denom
    cuda_ready("K4 denom", scalars, ty, target)
    from tpuslam_torch.kernels import counted, tally_ptr
    from tpuslam_torch.kernels.build import launch

    # over a capacity of rows: the splits any live count may need
    geo = cpd_geometry(TILE if live is not None else n, b, m // TILE)
    parts = _partials(geo, (b, m // TILE, 1, n), ty.device)
    launch("tpuslam_cpd_denom", ty.device, scalars.data_ptr(), ty.data_ptr(),
           target.data_ptr(), b, n, m, geo.threads, geo.rows_per_thread,
           geo.splits, _ptr(parts), _ptr(pred), pred_value, _ptr(live),
           tally_ptr("K4_denom", ty.device), denom.data_ptr())
    if counted("cpd_dense", b):
        DENOM_LAUNCHES += 1
        BATCH_LAUNCHES[b] += 1
    return denom


def moments_pass_batch(scalars: torch.Tensor, ty: torch.Tensor,
                       target: torch.Tensor, weights4: torch.Tensor,
                       pred: Optional[torch.Tensor] = None, pred_value: int = 0,
                       live: Optional[torch.Tensor] = None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Phase 2 (``pallas_cpd.moments_pass_batch``): ``acc`` f32[B, 4, M],
    the moment accumulators of every moving row over all target rows.
    Same dispatch and predication as ``denom_pass_batch`` (``live``:
    moving rows)."""
    global MOMENTS_LAUNCHES
    _check(scalars, ty, target, weights4)
    b, m, _ = ty.shape
    n = target.shape[1]
    acc = _predicate(pred, pred_value, live, out, (b, 4, m), ty.device)
    if ty.device.type == "cpu":
        if _selected(pred, pred_value):
            rows = _live_rows(live, m)
            if rows:
                acc[:, :, :rows] = moments_pass_ref(scalars, ty[:, :rows], target, weights4)
        return acc
    cuda_ready("K4 moments", scalars, ty, target, weights4)
    from tpuslam_torch.kernels import counted, tally_ptr
    from tpuslam_torch.kernels.build import launch

    geo = cpd_geometry(TILE if live is not None else m, b, n // TILE)
    parts = _partials(geo, (b, n // TILE, 4, m), ty.device)
    launch("tpuslam_cpd_moments", ty.device, scalars.data_ptr(), ty.data_ptr(),
           target.data_ptr(), weights4.data_ptr(), b, n, m, geo.threads,
           geo.rows_per_thread, geo.splits, _ptr(parts), _ptr(pred), pred_value,
           _ptr(live), tally_ptr("K4_moments", ty.device), acc.data_ptr())
    if counted("cpd_dense", b):
        MOMENTS_LAUNCHES += 1
        BATCH_LAUNCHES[b] += 1
    return acc


def device_scalar(x, dtype: torch.dtype, device) -> torch.Tensor:
    """``x`` as a tensor of ``dtype`` on ``device``: a Python number is
    filled there (rounded to ``dtype`` on the host, as ``torch.tensor``
    rounds it), not copied from the host, which a CUDA graph's capture
    refuses and which blocks otherwise; a tensor or array is converted."""
    if isinstance(x, (bool, int, float)):
        return torch.full((), torch.tensor(x, dtype=dtype).item(), dtype=dtype, device=device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def estep_scalars(sigma2: torch.Tensor, constant: torch.Tensor,
                  trunc_active: torch.Tensor, truncate: float) -> torch.Tensor:
    """f32[B, 4] = (-0.5 / sigma^2, c, truncation flag, log(truncate)),
    the TPU kernels' scalar rows, on the device."""
    return torch.stack(
        [
            -0.5 / sigma2,
            constant,
            trunc_active.to(torch.float32),
            torch.full_like(sigma2, math.log(truncate)),
        ],
        dim=1,
    ).contiguous()


def moment_weights(denom: torch.Tensor, target: torch.Tensor,
                   target_mask: torch.Tensor, constant: torch.Tensor):
    """``pt1`` f32[B, N] and the phase-2 weights f32[B, N, 4]
    ``[1/denom, x/denom]`` (zero on padded target rows) from ``denom``
    f32[B, N]."""
    pt1 = (1.0 - constant[:, None] / denom) * target_mask
    inv_denom = target_mask / denom
    weights4 = torch.cat(
        [inv_denom[:, :, None], target * inv_denom[:, :, None]], dim=2
    ).contiguous()
    return pt1, weights4


def _log_likelihood(denom: torch.Tensor, target_mask: torch.Tensor,
                    sigma2: torch.Tensor) -> torch.Tensor:
    """One pair's negative log-likelihood from its denominators."""
    return (-torch.sum(torch.log(denom) * target_mask)
            + 3.0 * torch.sum(target_mask) * torch.log(sigma2) / 2.0)


def sufficient_from(acc: torch.Tensor, denom: torch.Tensor, pt1: torch.Tensor,
                    moving_mask: torch.Tensor, target_mask: torch.Tensor,
                    sigma2: torch.Tensor, m0: int, n0: int) -> Sufficient:
    """The batched statistics from the two passes (the tail of
    ``cpd_estep_pallas_batch``), cut back to ``m0`` and ``n0`` rows.  K5's
    wrapper uses it too, so equal passes give equal bits.  The
    log-likelihood sums each pair's rows by itself (``per_pair``): a sum
    over the batch may split a pair's rows otherwise, so a pair of a batch
    gets the bits of its B = 1 call."""
    p1 = acc[:, 0, :] * moving_mask
    px = torch.transpose(acc[:, 1:4, :], 1, 2) * moving_mask[:, :, None]
    err = per_pair(_log_likelihood, denom, target_mask, sigma2)
    return Sufficient(p1=p1[:, :m0], pt1=pt1[:, :n0], px=px[:, :m0], error=err)


def pad_rows(x: torch.Tensor, rows: int, value: float = 0.0) -> torch.Tensor:
    """Pad dim 1 of ``x`` [B, R, ...] to ``rows`` with ``value``."""
    extra = rows - x.shape[1]
    if extra == 0:
        return x
    pad = [0, 0] * (x.dim() - 2) + [0, extra]
    return torch.nn.functional.pad(x, pad, value=value)


def cpd_estep_dense_batch(
    transformed: torch.Tensor,
    moving_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    sigma2: torch.Tensor,
    constant: torch.Tensor,
    trunc_active: torch.Tensor,
    truncate: float = 1e-3,
) -> Sufficient:
    """Batched E-step (``cpd_estep_pallas_batch``): a leading pair axis B
    on every operand, per-pair ``sigma2``, ``constant`` f32[B] and
    ``trunc_active`` bool[B]; all on one device.  Pads both clouds to
    ``TILE`` rows (moving rows at ``SENTINEL``), runs the two passes and
    returns ``Sufficient`` with a leading B."""
    b, m0, _ = transformed.shape
    n0 = target.shape[1]
    m, n = round_up(m0, TILE), round_up(n0, TILE)
    transformed = pad_rows(transformed, m)
    moving_mask = pad_rows(moving_mask, m)
    target = pad_rows(target, n).contiguous()
    target_mask = pad_rows(target_mask, n)
    ty = torch.where(moving_mask[:, :, None] > 0, transformed,
                     torch.full_like(transformed, SENTINEL)).contiguous()
    sigma2 = sigma2.to(torch.float32)
    constant = constant.to(torch.float32)
    scalars = estep_scalars(sigma2, constant, trunc_active, truncate)
    denom = denom_pass_batch(scalars, ty, target).reshape(b, n)
    pt1, weights4 = moment_weights(denom, target, target_mask, constant)
    acc = moments_pass_batch(scalars, ty, target, weights4)
    return sufficient_from(acc, denom, pt1, moving_mask, target_mask,
                           sigma2, m0, n0)


def cpd_estep_dense(
    transformed: torch.Tensor,
    moving_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    sigma2,
    constant,
    trunc_active,
    truncate: float = 1e-3,
) -> Sufficient:
    """B=1 form (``cpd_estep_pallas``), the exact E-step's drop-in:
    ``transformed`` f32[M, 3], ``target`` f32[N, 3], their masks, and
    scalar ``sigma2``, ``constant``, ``trunc_active`` (tensors or Python
    numbers) -> ``Sufficient`` without the pair axis."""
    dev = transformed.device
    out = cpd_estep_dense_batch(
        transformed[None], moving_mask[None], target[None], target_mask[None],
        device_scalar(sigma2, torch.float32, dev).reshape(1),
        device_scalar(constant, torch.float32, dev).reshape(1),
        device_scalar(trunc_active, torch.bool, dev).reshape(1),
        truncate=truncate,
    )
    return Sufficient(p1=out.p1[0], pt1=out.pt1[0], px=out.px[0],
                      error=out.error[0])
