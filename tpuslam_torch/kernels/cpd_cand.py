"""K5: the candidate (block-skipping) CPD E-step — the wrappers of the
CUDA kernels ``csrc/cpd_cand.cu``, their plain PyTorch versions and the
admission that feeds them.

Port of ``tpuslam/kernels/pallas_cpd_cand.py::cpd_estep_cand``.  With
truncation on, every term whose exponent is below ``log(truncate)`` is
exactly 0, so a (target block, moving block) pair of ``TILE`` rows each
whose rigorous minimum distance puts all its pairs past the cutoff adds
exactly +0.0 to each running total of K4 (``kernels/cpd_dense.py``).
Such pairs are skipped; the rest are visited in K4's ascending block
order, so the result is K4's bit for bit.

The wrapper carries over, as torch on the device:

* the bounds: 128-row (or coarser, ``f_sub``) sub-tile spheres of both
  Morton-sorted clouds (``ops/spatial.tile_bounds``), min-pooled to
  block pairs, with the ``1 - 1e-5`` and ``1 + 1e-5`` margins; every
  rounding is XLA's on the CPU, so the admission equals the JAX
  package's bit for bit (``block_admission``);
* per-block counts and candidate tables (``ops/nn_hier._build_cand_table``)
  of width 5/8 of the blocks, rounded up to ``SLOTS``; one block per
  slot (the TPU's SMEM super-slots and table cap are not ported);
* the "fat" blocks whose sets overflow the table, served by K4's passes
  on a gathered subset of rows, up to ``fat_budget``; more than that,
  or fewer than two blocks a side, routes the whole E-step to K4.

Eager torch reads the overflow flag and the fat counts back to the host
once per call (one small copy) to choose K4 or K5 and to size the fat
subsets; ``ROUTE_TRACE`` records the choice.  ``checked=True`` returns
``(Sufficient, overflow)`` instead of routing: on overflow its
statistics are invalid (counts zeroed, fat passes skipped) and must be
discarded.

Dispatch of the kernels: tensors on the CPU take the plain versions;
CUDA tensors launch the kernels, or raise.  There is no other path.
"""

from __future__ import annotations

import math
from collections import deque
from typing import NamedTuple, Tuple, Union

import numpy as np
import torch

from tpuslam_torch.core.types import Sufficient, round_up
from tpuslam_torch.kernels.cpd_dense import (
    SENTINEL,
    TILE,
    cpd_estep_dense,
    cuda_ready,
    denom_pass_batch,
    denom_rows,
    estep_scalars,
    moment_weights,
    moments_pass_batch,
    moments_rows,
    pad_rows,
    sufficient_from,
)
from tpuslam_torch.ops.nn_hier import _build_cand_table
from tpuslam_torch.ops.spatial import sq_norm_xla, sqrt_rn, tile_bounds

SLOTS = 8  # the table width's granule (the TPU kernel's slot count)
# the table holds at most this fraction of the blocks: above it the dense
# scan costs no more
BUDGET_NUM, BUDGET_DEN = 5, 8
# fat blocks served by K4's subset passes before the whole E-step routes
# to K4 (scaled with the block count, the JAX package's budget)
FAT_MAX = 8

# kernel launches made by the wrappers below (CPU calls do not count)
DENOM_LAUNCHES = 0
MOMENTS_LAUNCHES = 0
# the route of each recent cpd_estep_cand call, newest last: "k5", or
# "k4" where the whole E-step went to K4
ROUTE_TRACE: deque = deque(maxlen=4096)


def fat_budget(t_blocks: int) -> int:
    return max(FAT_MAX, t_blocks // 16)


def table_width(t_blocks: int) -> int:
    """Candidate-table width: 5/8 of the blocks, rounded up to ``SLOTS``."""
    w = min(t_blocks, max(BUDGET_NUM * t_blocks // BUDGET_DEN, 1))
    return -(-w // SLOTS) * SLOTS


def cut_factor(truncate: float) -> np.float32:
    """``-log(truncate) * 2 * (1 + 1e-5)`` in float32, multiplied in the
    order XLA folds the constants of ``-log(truncate) * 2.0 * sigma2 *
    (1 + 1e-5)`` on the CPU; the cutoff is this times sigma^2."""
    log_t = np.float32(-np.float32(math.log(truncate)))
    return np.float32(np.float32(log_t * np.float32(2.0)) * np.float32(1.0 + 1e-5))


class Admission(NamedTuple):
    """The block-pair admission of one E-step (``cpd_estep_cand``'s
    ``lb`` .. ``overflow``, with one block per slot)."""

    lb: torch.Tensor  # f32[Tn, Tm] — lower bound on a pair's distance
    adm: torch.Tensor  # bool[Tn, Tm] — the pair may hold a nonzero term
    counts_n: torch.Tensor  # i32[Tn] — admitted moving blocks per target block
    counts_m: torch.Tensor  # i32[Tm] — admitted target blocks per moving block
    fat_n: torch.Tensor  # bool[Tn] — counts_n above width_m
    fat_m: torch.Tensor  # bool[Tm]
    overflow: torch.Tensor  # bool[] — more fat blocks than the budget
    width_m: int  # table width of the denominator pass (moving block ids)
    width_n: int  # table width of the moments pass (target block ids)


def block_admission(
    transformed: torch.Tensor,
    moving_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    sigma2: torch.Tensor,
    trunc_active: torch.Tensor,
    truncate: float = 1e-3,
) -> Admission:
    """Admission of every block pair for clouds padded to ``TILE`` rows
    (``pallas_cpd_cand.py:257-311``).  A pair is skipped only when the
    minimum distance any of its points can have puts the exponent past
    the cutoff; without truncation every pair is admitted.  Bounds are
    taken at the finest sub-tile size whose bound matrix stays at most
    64M entries (128 rows up to ~1M rows), so a Morton run that crosses
    an octant boundary spoils one sub-tile's sphere, not a block's."""
    n, m = target.shape[0], transformed.shape[0]
    tn, tm = n // TILE, m // TILE
    f_sub = next(f for f in (8, 4, 2, 1) if (tn * f) * (tm * f) <= 64 * 1024 * 1024)
    sub = TILE // f_sub
    tb_n = tile_bounds(target, target_mask, sub)
    tb_m = tile_bounds(transformed, moving_mask, sub)
    diff = tb_n.centers[:, None, :] - tb_m.centers[None, :, :]
    cdist = sqrt_rn(sq_norm_xla(diff))
    lb = torch.clamp_min(
        cdist - tb_n.radii[:, None] - tb_m.radii[None, :], 0.0
    ) * (1.0 - 1e-5)
    lb = torch.amin(lb.reshape(tn, f_sub, tm, f_sub), dim=(1, 3))
    d2_cut = float(cut_factor(truncate)) * sigma2
    adm = torch.logical_or(torch.logical_not(trunc_active), (lb * lb) <= d2_cut)
    counts_n = torch.sum(adm, dim=1, dtype=torch.int32)
    counts_m = torch.sum(adm, dim=0, dtype=torch.int32)
    width_m, width_n = table_width(tm), table_width(tn)
    fat_n = counts_n > width_m
    fat_m = counts_m > width_n
    overflow = torch.logical_or(
        torch.sum(fat_n) > fat_budget(tn), torch.sum(fat_m) > fat_budget(tm))
    return Admission(lb, adm, counts_n, counts_m, fat_n, fat_m, overflow,
                     width_m, width_n)


def _live(cand: torch.Tensor, counts: torch.Tensor, blocks: int):
    """Each row's live table ids within ``[0, blocks)``, read to the host."""
    live = torch.clamp(counts, 0, cand.shape[1]).tolist()
    return [[j for j in row[:k] if 0 <= j < blocks]
            for row, k in zip(cand.tolist(), live)]


def denom_cand_ref(scalars: torch.Tensor, ty: torch.Tensor, target: torch.Tensor,
                   cand: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The plain version of K5's phase 1 on any device: ``scalars`` f32[4],
    ``ty`` f32[M, 3], ``target`` f32[N, 3], ``cand`` i32[N / TILE, W]
    (moving block ids) and ``counts`` i32[N / TILE] -> ``denom`` f32[N].
    Built on ``cpd_dense.denom_rows``, so it equals K4's plain version
    wherever the skipped blocks add only zeros."""
    out = torch.empty(target.shape[0], dtype=torch.float32, device=ty.device)
    for i, blocks in enumerate(_live(cand, counts, ty.shape[0] // TILE)):
        sl = slice(i * TILE, (i + 1) * TILE)
        out[sl] = denom_rows(scalars, ty, target[sl], blocks)
    return out


def moments_cand_ref(scalars: torch.Tensor, ty: torch.Tensor,
                     target: torch.Tensor, weights4: torch.Tensor,
                     cand: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The plain version of K5's phase 2: ``weights4`` f32[N, 4], ``cand``
    i32[M / TILE, W] (target block ids), ``counts`` i32[M / TILE] ->
    ``acc`` f32[4, M]."""
    out = torch.empty((4, ty.shape[0]), dtype=torch.float32, device=ty.device)
    for j, blocks in enumerate(_live(cand, counts, target.shape[0] // TILE)):
        sl = slice(j * TILE, (j + 1) * TILE)
        out[:, sl] = moments_rows(scalars, ty[sl], target, weights4, blocks)
    return out


def _check(scalars, ty, target, cand, counts, out_rows, weights4=None) -> None:
    if tuple(scalars.shape) != (4,) or scalars.dtype != torch.float32:
        raise ValueError(f"scalars must be f32[4], got {tuple(scalars.shape)}")
    for name, t, width in (("ty", ty, 3), ("target", target, 3),
                           ("weights4", weights4, 4)):
        if t is None:
            continue
        if t.dim() != 2 or t.shape[1] != width or t.shape[0] % TILE:
            raise ValueError(
                f"{name} must be [rows, {width}] with rows a multiple of {TILE}, "
                f"got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if weights4 is not None and weights4.shape[0] != target.shape[0]:
        raise ValueError("weights4 and target must have the same rows")
    blocks = out_rows // TILE
    if cand.dim() != 2 or cand.shape[0] != blocks or tuple(counts.shape) != (blocks,):
        raise ValueError(
            f"cand must be [{blocks}, W] and counts [{blocks}], got "
            f"{tuple(cand.shape)} and {tuple(counts.shape)}")
    if cand.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("cand and counts must be int32")
    tensors = [t for t in (scalars, ty, target, weights4, cand, counts)
               if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("K5's operands must share one device")


def denom_cand(scalars: torch.Tensor, ty: torch.Tensor, target: torch.Tensor,
               cand: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """K5's phase 1: ``denom`` f32[N] over each target block's live table
    entries.  The CPU takes the plain version; CUDA launches the kernel on
    the current stream (counts and table stay on the device)."""
    global DENOM_LAUNCHES
    _check(scalars, ty, target, cand, counts, target.shape[0])
    if ty.device.type == "cpu":
        return denom_cand_ref(scalars, ty, target, cand, counts)
    cuda_ready("K5 denom", scalars, ty, target, cand, counts)
    from tpuslam_torch.kernels.build import launch

    n, m = target.shape[0], ty.shape[0]
    denom = torch.empty(n, dtype=torch.float32, device=ty.device)
    launch("tpuslam_cpd_denom_cand", ty.device, scalars.data_ptr(),
           ty.data_ptr(), target.data_ptr(), cand.data_ptr(), counts.data_ptr(),
           n, m, cand.shape[1], denom.data_ptr())
    DENOM_LAUNCHES += 1
    return denom


def moments_cand(scalars: torch.Tensor, ty: torch.Tensor, target: torch.Tensor,
                 weights4: torch.Tensor, cand: torch.Tensor,
                 counts: torch.Tensor) -> torch.Tensor:
    """K5's phase 2: ``acc`` f32[4, M] over each moving block's live table
    entries.  Same dispatch as ``denom_cand``."""
    global MOMENTS_LAUNCHES
    _check(scalars, ty, target, cand, counts, ty.shape[0], weights4)
    if ty.device.type == "cpu":
        return moments_cand_ref(scalars, ty, target, weights4, cand, counts)
    cuda_ready("K5 moments", scalars, ty, target, weights4, cand, counts)
    from tpuslam_torch.kernels.build import launch

    n, m = target.shape[0], ty.shape[0]
    acc = torch.empty((4, m), dtype=torch.float32, device=ty.device)
    launch("tpuslam_cpd_moments_cand", ty.device, scalars.data_ptr(),
           ty.data_ptr(), target.data_ptr(), weights4.data_ptr(),
           cand.data_ptr(), counts.data_ptr(), n, m, cand.shape[1],
           acc.data_ptr())
    MOMENTS_LAUNCHES += 1
    return acc


def _block_rows(fat: torch.Tensor, count: int) -> torch.Tensor:
    """Row indices of the first ``count`` flagged blocks (all of them,
    ascending), without another read back."""
    ids = torch.argsort(torch.logical_not(fat).to(torch.uint8), stable=True)[:count]
    within = torch.arange(TILE, device=fat.device)
    return (ids[:, None] * TILE + within[None, :]).reshape(-1)


def cpd_estep_cand(
    transformed: torch.Tensor,
    moving_mask: torch.Tensor,
    target: torch.Tensor,
    target_mask: torch.Tensor,
    sigma2,
    constant,
    trunc_active,
    truncate: float = 1e-3,
    checked: bool = False,
) -> Union[Sufficient, Tuple[Sufficient, torch.Tensor]]:
    """Drop-in for ``cpd_dense.cpd_estep_dense`` (same contract, same
    bits) that skips block pairs proven to add exact zeros.  Most
    effective when both clouds are Morton-sorted; correct for any row
    order.  ``sigma2``, ``constant`` and ``trunc_active`` are scalars
    (tensors or Python numbers).  With ``checked=True`` returns
    ``(Sufficient, overflow bool[])`` and does not route to K4 on
    overflow (see the module docstring)."""
    dev = transformed.device
    sigma2 = torch.as_tensor(sigma2, dtype=torch.float32, device=dev)
    constant = torch.as_tensor(constant, dtype=torch.float32, device=dev)
    trunc_active = torch.as_tensor(trunc_active, device=dev).to(torch.bool)
    m0, n0 = transformed.shape[0], target.shape[0]
    m, n = round_up(m0, TILE), round_up(n0, TILE)
    tn, tm = n // TILE, m // TILE

    def dense():
        return cpd_estep_dense(transformed, moving_mask, target, target_mask,
                               sigma2, constant, trunc_active, truncate)

    if tn < 2 or tm < 2:  # too small to skip anything
        ROUTE_TRACE.append("k4")
        out = dense()
        return (out, torch.zeros((), dtype=torch.bool, device=dev)) if checked else out

    mov = pad_rows(transformed[None], m)[0]
    mov_mask = pad_rows(moving_mask[None], m)[0]
    tgt = pad_rows(target[None], n)[0].contiguous()
    tgt_mask = pad_rows(target_mask[None], n)[0]
    a = block_admission(mov, mov_mask, tgt, tgt_mask, sigma2, trunc_active,
                        truncate)
    # the one read back of the call: route, and size the fat subsets
    overflow, n_fat_n, n_fat_m = torch.stack(
        [a.overflow.to(torch.int64), a.fat_n.sum(), a.fat_m.sum()]).tolist()
    if overflow and not checked:
        ROUTE_TRACE.append("k4")
        return dense()
    ROUTE_TRACE.append("k5")

    # on overflow (checked only) every count is zeroed: the kernels become
    # count-gated no-ops and the caller discards the result
    zero = torch.zeros_like(a.counts_n[:1])
    counts_n = torch.where(a.fat_n | bool(overflow), zero, a.counts_n)
    counts_m = torch.where(a.fat_m | bool(overflow), zero, a.counts_m)
    ty = torch.where(mov_mask[:, None] > 0, mov,
                     torch.full_like(mov, SENTINEL)).contiguous()
    scalars = estep_scalars(sigma2.reshape(1), constant.reshape(1),
                            trunc_active.reshape(1), truncate)

    cand_m = _build_cand_table(a.adm, counts_n, a.width_m)
    denom = denom_cand(scalars[0], ty, tgt, cand_m, counts_n)
    if n_fat_n and not overflow:
        # fat target blocks: K4's phase 1 on their rows, in the same
        # moving-block order, so bit-identical to the full K4 pass
        rows = _block_rows(a.fat_n, n_fat_n)
        sub = tgt.index_select(0, rows)[None].contiguous()
        denom = denom.index_copy(
            0, rows, denom_pass_batch(scalars, ty[None], sub).reshape(-1))

    pt1, weights4 = moment_weights(denom[None], tgt[None], tgt_mask[None],
                                   constant.reshape(1))
    cand_n = _build_cand_table(a.adm.T, counts_m, a.width_n)
    acc = moments_cand(scalars[0], ty, tgt, weights4[0], cand_n, counts_m)
    if n_fat_m and not overflow:
        # fat moving blocks: K4's phase 2 on their rows
        rows = _block_rows(a.fat_m, n_fat_m)
        sub = ty.index_select(0, rows)[None].contiguous()
        acc = acc.index_copy(
            1, rows, moments_pass_batch(scalars, sub, tgt[None], weights4)[0])

    out = sufficient_from(acc[None], denom[None], pt1, mov_mask[None],
                          tgt_mask[None], sigma2.reshape(1), m0, n0)
    out = Sufficient(p1=out.p1[0], pt1=out.pt1[0], px=out.px[0], error=out.error[0])
    if checked:
        return out, torch.tensor(bool(overflow), device=dev)
    return out
