"""K5: the candidate (segment-skipping) CPD E-step — the wrappers of the
CUDA kernels ``csrc/cpd_cand.cu``, their plain PyTorch versions and the
admission that feeds them.

Port of ``tpuslam/kernels/pallas_cpd_cand.py::cpd_estep_cand``.  With
truncation on, every term whose exponent is below ``log(truncate)`` is
exactly 0, so a pair of row sets whose rigorous minimum distance puts
all its pairs past the cutoff adds exactly +0.0 to each running total
of K4 (``kernels/cpd_dense.py``).  Such pairs are skipped; the rest are
visited in K4's ascending block order, so the result is K4's bit for
bit.

The plan of a call (``cand_plan``: everything the passes read beside
the clouds), in the composition that the plain version ``cand_plan_ref``
keeps as torch on any device:

* the bounds: 128-row (or coarser, ``f_sub``) sub-tile spheres of both
  Morton-sorted clouds (``ops/spatial.tile_bounds``) with the
  ``1 - 1e-5`` and ``1 + 1e-5`` margins, admitted per sub-tile pair and
  min-pooled to block pairs; every rounding is XLA's on the CPU, so the
  block admission equals the JAX package's bit for bit
  (``block_admission``);
* per-block counts of width 5/8 of the blocks, rounded up to ``SLOTS``
  (the TPU's SMEM super-slots and table cap are not ported), and the
  "fat" blocks whose sets overflow the table, served by K4's passes on a
  gathered subset of rows, up to ``fat_budget``; more than that, or
  fewer than two blocks a side, routes the whole E-step to K4.

On CUDA the plan is not torch's: one hand-written kernel,
``csrc/cpd_plan.cu`` (three launches, no host read), writes it bit-equal
to that composition on the card.

Unlike the JAX package, the kernels skip at the sub-tile grain: each CTA
of ``cpd_geometry(rows).cta_rows`` output rows gets its own table
(``cta_tables``): the other cloud's blocks in which any sub-tile is
admitted against its rows, ascending, each with a mask of the 128-row
segments to fold.

Outside a captured loop, eager torch reads the overflow flag and the fat
counts back to the host once per call (one small copy) to choose K4 or
K5 and to size the fat subsets; ``ROUTE_TRACE`` records the choice.  A
host ``False`` for the truncation flag (the exact mode) goes to K4 at
once: its admission would admit everything, and a device flag that is
false takes K4's route too.  ``checked=True`` returns ``(Sufficient,
overflow)`` instead of routing: on overflow its statistics are invalid
(counts zeroed, fat passes skipped) and must be discarded.

Inside a CUDA graph (a predicated ``core/choices.py`` recording, the CPD
loop's chunks) nothing is read: the route is a device code (0 K5, 1 K4),
and K5's two passes, K4's two passes over the whole clouds and K4's two
passes over the fat blocks are all launched, each predicated on the code
(``cpd_dense``'s predication), so the selected route writes the result
and the others return at once.  The fat subsets have a fixed capacity of
``fat_budget`` blocks, a device count of live rows, and go back by a
masked scatter.  The statistics are the host route's, bit for bit.  Each
call books its route to ``ROUTE_TRACE`` through ``core/choices.py``,
which a loop's chunk reads with its one read.

Dispatch of the kernels: tensors on the CPU take the plain versions;
CUDA tensors launch the kernels, or raise.  There is no other path.
"""

from __future__ import annotations

import math
from collections import deque
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from tpuslam_torch.core import choices
from tpuslam_torch.core.types import Sufficient, round_up
from tpuslam_torch.kernels.cpd_dense import (
    SENTINEL,
    TILE,
    _predicate,
    _ptr,
    _selected,
    cpd_estep_dense,
    cpd_geometry,
    cuda_ready,
    denom_pass_batch,
    device_scalar,
    denom_rows,
    estep_scalars,
    moment_weights,
    moments_pass_batch,
    moments_rows,
    pad_rows,
    sufficient_from,
)
from tpuslam_torch.ops.spatial import sq_norm_xla, sqrt_rn, tile_bounds

SLOTS = 8  # the table width's granule (the TPU kernel's slot count)
# the table holds at most this fraction of the blocks: above it the dense
# scan costs no more
BUDGET_NUM, BUDGET_DEN = 5, 8
# fat blocks served by K4's subset passes before the whole E-step routes
# to K4 (scaled with the block count, the JAX package's budget)
FAT_MAX = 8
# entries of the sub-tile bound matrix at most: sub-tiles of 128 rows up
# to ~1M rows a side, 256 at 1.3M (the JAX package's rule)
SUB_BOUND_MAX = 64 * 1024 * 1024
SEG_ROWS = 128  # rows of a segment: a bit of a table entry's mask
SEGS = TILE // SEG_ROWS

# kernel launches made by the wrappers below (CPU calls do not count)
DENOM_LAUNCHES = 0
MOMENTS_LAUNCHES = 0
PLAN_LAUNCHES = 0  # csrc/cpd_plan.cu's: three a plan
# the route of each recent cpd_estep_cand call, newest last: "k5", or
# "k4" where the whole E-step went to K4
ROUTE_TRACE: deque = deque(maxlen=4096)
ROUTES = ("k5", "k4")  # by route code


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
    """The admission of one E-step (``cpd_estep_cand``'s ``lb`` ..
    ``overflow``, with one block per slot), and the sub-tile admission
    it is pooled from."""

    lb: torch.Tensor  # f32[Tn, Tm] — lower bound on a pair's distance
    adm: torch.Tensor  # bool[Tn, Tm] — the pair may hold a nonzero term
    counts_n: torch.Tensor  # i32[Tn] — admitted moving blocks per target block
    counts_m: torch.Tensor  # i32[Tm] — admitted target blocks per moving block
    fat_n: torch.Tensor  # bool[Tn] — counts_n above width_m
    fat_m: torch.Tensor  # bool[Tm]
    overflow: torch.Tensor  # bool[] — more fat blocks than the budget
    width_m: int  # table width of the denominator pass (moving block ids)
    width_n: int  # table width of the moments pass (target block ids)
    sub_adm: torch.Tensor  # bool[Tn * f_sub, Tm * f_sub] — per sub-tile pair
    f_sub: int  # sub-tiles a block


def sub_factor(tn: int, tm: int) -> int:
    """Sub-tiles a block for ``tn`` x ``tm`` blocks: the finest of 8, 4, 2
    or 1 whose bound matrix holds at most ``SUB_BOUND_MAX`` entries."""
    return next(f for f in (8, 4, 2, 1) if (tn * f) * (tm * f) <= SUB_BOUND_MAX)


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
    an octant boundary spoils one sub-tile's sphere, not a block's.  A
    block pair is admitted where any of its sub-tile pairs is (the
    minimum of the bounds, as the JAX package pools them)."""
    n, m = target.shape[0], transformed.shape[0]
    tn, tm = n // TILE, m // TILE
    f_sub = sub_factor(tn, tm)
    sub = TILE // f_sub
    tb_n = tile_bounds(target, target_mask, sub)
    tb_m = tile_bounds(transformed, moving_mask, sub)
    diff = tb_n.centers[:, None, :] - tb_m.centers[None, :, :]
    cdist = sqrt_rn(sq_norm_xla(diff))
    lb_sub = torch.clamp_min(
        cdist - tb_n.radii[:, None] - tb_m.radii[None, :], 0.0
    ) * (1.0 - 1e-5)
    lb = torch.amin(lb_sub.reshape(tn, f_sub, tm, f_sub), dim=(1, 3))
    d2_cut = float(cut_factor(truncate)) * sigma2
    skip_none = torch.logical_not(trunc_active)
    adm = torch.logical_or(skip_none, (lb * lb) <= d2_cut)
    sub_adm = torch.logical_or(skip_none, (lb_sub * lb_sub) <= d2_cut)
    counts_n = torch.sum(adm, dim=1, dtype=torch.int32)
    counts_m = torch.sum(adm, dim=0, dtype=torch.int32)
    width_m, width_n = table_width(tm), table_width(tn)
    fat_n = counts_n > width_m
    fat_m = counts_m > width_n
    overflow = torch.logical_or(
        torch.sum(fat_n) > fat_budget(tn), torch.sum(fat_m) > fat_budget(tm))
    return Admission(lb, adm, counts_n, counts_m, fat_n, fat_m, overflow,
                     width_m, width_n, sub_adm, f_sub)


def _spread_lut(f_sub: int, device) -> torch.Tensor:
    """i32[2^f_sub]: a mask of ``f_sub`` sub-tile bits spread to ``SEGS``
    segment bits (each sub-tile bit covers ``SEGS / f_sub`` segments)."""
    e = SEGS // f_sub
    m = torch.arange(1 << f_sub, dtype=torch.int32, device=device)
    out = torch.zeros_like(m)
    for b in range(f_sub):
        out |= ((m >> b) & 1) * (((1 << e) - 1) << (b * e))
    return out


def segment_masks(sub_adm: torch.Tensor, f_sub: int, cta_rows: int) -> torch.Tensor:
    """i32[rows / cta_rows, other blocks]: for each CTA of ``cta_rows``
    output rows and each block of the other cloud, the mask of the
    block's 128-row segments that lie in a sub-tile admitted against
    the CTA's rows.  ``sub_adm`` bool[row sub-tiles, other sub-tiles]."""
    sub = TILE // f_sub
    if sub % cta_rows:
        raise ValueError(f"a CTA of {cta_rows} rows straddles sub-tiles of {sub}")
    per_cta = sub_adm.repeat_interleave(sub // cta_rows, dim=0)
    weights = (1 << torch.arange(f_sub, device=sub_adm.device)).to(torch.uint8)
    bits = torch.sum(per_cta.reshape(per_cta.shape[0], -1, f_sub).to(torch.uint8)
                     * weights, dim=2, dtype=torch.int64)
    return _spread_lut(f_sub, sub_adm.device)[bits]


def cta_tables(sub_adm: torch.Tensor, f_sub: int, cta_rows: int,
               serve: torch.Tensor, width: int):
    """K5's per-CTA tables, built on the device: ``(table, counts)`` with
    ``table`` i32[CTAs, width], each CTA's other-cloud blocks with a
    nonzero segment mask (``segment_masks``), ascending, packed as
    ``(block << 8) | mask``, compacted left (dead slots 0), and
    ``counts`` i32[CTAs].  CTAs of a row block whose ``serve`` bool[row
    blocks] is False (fat, or the call overflowed) get count 0.  A served
    block's CTAs list at most its admitted blocks, so ``width`` holds
    them."""
    masks = segment_masks(sub_adm, f_sub, cta_rows)
    n_cta, blocks = masks.shape
    live = (masks != 0) & serve.repeat_interleave(TILE // cta_rows)[:, None]
    counts = torch.sum(live, dim=1, dtype=torch.int32)
    slot = torch.cumsum(live.to(torch.int32), dim=1) - 1
    slot = torch.where(live & (slot < width), slot, torch.full_like(slot, width))
    ids = torch.arange(blocks, dtype=torch.int32, device=masks.device)
    vals = ((ids[None, :] << 8) | masks).to(torch.int32)
    table = torch.zeros((n_cta, width + 1), dtype=torch.int32, device=masks.device)
    table.scatter_(1, slot.long(), torch.where(live, vals, torch.zeros_like(vals)))
    return table[:, :width].contiguous(), counts


def segments_per_cta(table: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """i64[CTAs]: the 128-row segments each CTA folds under its table."""
    live = torch.arange(table.shape[1], device=table.device)[None, :] < counts[:, None]
    segs = sum(((table >> b) & 1) for b in range(SEGS))
    return torch.sum(torch.where(live, segs, torch.zeros_like(segs)), dim=1, dtype=torch.int64)


def visited_pairs(table: torch.Tensor, counts: torch.Tensor, cta_rows: int) -> int:
    """The (row, other row) pairs a K5 pass folds under these tables (read
    to the host)."""
    return int(segments_per_cta(table, counts).sum()) * cta_rows * SEG_ROWS


def _keep(table: torch.Tensor, counts: torch.Tensor, blocks: int) -> torch.Tensor:
    """bool[CTAs, blocks, SEGS]: the segments of each block of the other
    cloud that each CTA folds under its table (ids outside ``[0,
    blocks)`` dropped)."""
    n_cta, width = table.shape
    live = torch.arange(width, device=table.device)[None, :] < torch.clamp(
        counts, 0, width)[:, None]
    blk = table >> 8
    ok = live & (blk >= 0) & (blk < blocks)
    bits = ((table[..., None] >> torch.arange(SEGS, device=table.device)) & 1) * ok[..., None]
    keep = torch.zeros((n_cta, blocks + 1, SEGS), dtype=torch.int32, device=table.device)
    idx = torch.where(ok, blk, torch.full_like(blk, blocks)).long()
    keep.scatter_add_(1, idx[..., None].expand(-1, -1, SEGS), bits.to(torch.int32))
    return keep[:, :blocks] > 0


def _block_keeps(table, counts, blocks: int, rows: int):
    """Per row block of ``TILE`` output rows: {other block: bool[TILE,
    TILE] terms folded}, for the other blocks some CTA of it folds."""
    keep = _keep(table, counts, blocks)
    cta_rows = rows // table.shape[0]
    per = TILE // cta_rows
    out = []
    for i in range(rows // TILE):
        k = keep[i * per:(i + 1) * per]
        k = k.repeat_interleave(cta_rows, dim=0).repeat_interleave(SEG_ROWS, dim=2)
        out.append({j: k[:, j] for j in torch.nonzero(k.any(dim=(0, 2)))[:, 0].tolist()})
    return out


def denom_cand_ref(scalars: torch.Tensor, ty: torch.Tensor, target: torch.Tensor,
                   table: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The plain version of K5's phase 1 on any device: ``scalars`` f32[4],
    ``ty`` f32[M, 3], ``target`` f32[N, 3], per-CTA ``table`` i32[CTAs,
    W] (moving blocks and segment masks, ``cta_tables``) and ``counts``
    i32[CTAs] -> ``denom`` f32[N].  Built on ``cpd_dense.denom_rows``
    with the skipped terms zeroed, so it equals K4's plain version
    wherever they were zeros already."""
    out = torch.empty(target.shape[0], dtype=torch.float32, device=ty.device)
    keeps = _block_keeps(table, counts, ty.shape[0] // TILE, target.shape[0])
    for i, keep in enumerate(keeps):
        sl = slice(i * TILE, (i + 1) * TILE)
        out[sl] = denom_rows(scalars, ty, target[sl], sorted(keep), keep)
    return out


def moments_cand_ref(scalars: torch.Tensor, ty: torch.Tensor,
                     target: torch.Tensor, weights4: torch.Tensor,
                     table: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """The plain version of K5's phase 2: ``weights4`` f32[N, 4], per-CTA
    ``table`` i32[CTAs, W] (target blocks and segment masks), ``counts``
    i32[CTAs] -> ``acc`` f32[4, M]."""
    out = torch.empty((4, ty.shape[0]), dtype=torch.float32, device=ty.device)
    keeps = _block_keeps(table, counts, target.shape[0] // TILE, ty.shape[0])
    for j, keep in enumerate(keeps):
        sl = slice(j * TILE, (j + 1) * TILE)
        out[:, sl] = moments_rows(scalars, ty[sl], target, weights4, sorted(keep), keep)
    return out


def _check(scalars, ty, target, table, counts, out_rows, weights4=None) -> None:
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
    ctas = out_rows // cpd_geometry(out_rows).cta_rows
    if table.dim() != 2 or table.shape[0] != ctas or tuple(counts.shape) != (ctas,):
        raise ValueError(
            f"table must be [{ctas}, W] and counts [{ctas}] (one row a CTA of "
            f"cpd_geometry({out_rows})), got {tuple(table.shape)} and "
            f"{tuple(counts.shape)}")
    if table.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("table and counts must be int32")
    tensors = [t for t in (scalars, ty, target, weights4, table, counts)
               if t is not None]
    if len({t.device for t in tensors}) != 1:
        raise ValueError("K5's operands must share one device")


def denom_cand(scalars: torch.Tensor, ty: torch.Tensor, target: torch.Tensor,
               table: torch.Tensor, counts: torch.Tensor,
               pred: Optional[torch.Tensor] = None, pred_value: int = 0,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5's phase 1: ``denom`` f32[N] over each CTA's live table entries
    (``cta_tables``).  The CPU takes the plain version; CUDA launches the
    kernel on the current stream (counts and table stay on the device).
    ``pred`` (a device i32[1] route code) and ``pred_value``: the launch
    writes ``out`` only where they are equal (``cpd_dense``'s
    predication)."""
    global DENOM_LAUNCHES
    _check(scalars, ty, target, table, counts, target.shape[0])
    n, m = target.shape[0], ty.shape[0]
    denom = _predicate(pred, pred_value, None, out, (n,), ty.device)
    if ty.device.type == "cpu":
        if _selected(pred, pred_value):
            denom.copy_(denom_cand_ref(scalars, ty, target, table, counts))
        return denom
    cuda_ready("K5 denom", scalars, ty, target, table, counts)
    from tpuslam_torch.kernels import counted, tally_ptr
    from tpuslam_torch.kernels.build import launch

    geo = cpd_geometry(n)
    launch("tpuslam_cpd_denom_cand", ty.device, scalars.data_ptr(),
           ty.data_ptr(), target.data_ptr(), table.data_ptr(), counts.data_ptr(),
           n, m, table.shape[1], geo.threads, geo.rows_per_thread, _ptr(pred),
           pred_value, tally_ptr("K5_denom", ty.device), denom.data_ptr())
    if counted("cpd_cand", 1):
        DENOM_LAUNCHES += 1
    return denom


def moments_cand(scalars: torch.Tensor, ty: torch.Tensor, target: torch.Tensor,
                 weights4: torch.Tensor, table: torch.Tensor,
                 counts: torch.Tensor, pred: Optional[torch.Tensor] = None,
                 pred_value: int = 0, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K5's phase 2: ``acc`` f32[4, M] over each CTA's live table entries.
    Same dispatch and predication as ``denom_cand``."""
    global MOMENTS_LAUNCHES
    _check(scalars, ty, target, table, counts, ty.shape[0], weights4)
    n, m = target.shape[0], ty.shape[0]
    acc = _predicate(pred, pred_value, None, out, (4, m), ty.device)
    if ty.device.type == "cpu":
        if _selected(pred, pred_value):
            acc.copy_(moments_cand_ref(scalars, ty, target, weights4, table, counts))
        return acc
    cuda_ready("K5 moments", scalars, ty, target, weights4, table, counts)
    from tpuslam_torch.kernels import counted, tally_ptr
    from tpuslam_torch.kernels.build import launch

    geo = cpd_geometry(m)
    launch("tpuslam_cpd_moments_cand", ty.device, scalars.data_ptr(),
           ty.data_ptr(), target.data_ptr(), weights4.data_ptr(),
           table.data_ptr(), counts.data_ptr(), n, m, table.shape[1],
           geo.threads, geo.rows_per_thread, _ptr(pred), pred_value,
           tally_ptr("K5_moments", ty.device), acc.data_ptr())
    if counted("cpd_cand", 1):
        MOMENTS_LAUNCHES += 1
    return acc


def _block_rows(fat: torch.Tensor, count: int) -> torch.Tensor:
    """Row indices of the first ``count`` blocks in the order flagged blocks
    first, each group ascending (so every flagged block among them when
    ``count`` covers them all), without another read back."""
    ids = torch.argsort(torch.logical_not(fat).to(torch.uint8), stable=True)[:count]
    within = torch.arange(TILE, device=fat.device)
    return (ids[:, None] * TILE + within[None, :]).reshape(-1)


def _fat_subset(fat: torch.Tensor, blocks: int, dense: torch.Tensor):
    """One side's fat subset at its fixed capacity: ``(rows, live,
    valid)`` (``Plan``)."""
    cap = min(fat_budget(blocks), blocks)
    rows = _block_rows(fat, cap)
    n_fat = torch.clamp_max(torch.sum(fat, dtype=torch.int32), cap)
    live = (torch.where(dense, 0, n_fat) * TILE).to(torch.int32).reshape(1)
    valid = torch.arange(cap * TILE, device=fat.device) < live
    return rows, live, valid


class Plan(NamedTuple):
    """K5's plan of one E-step (``cand_plan``): its operands padded to
    ``TILE`` rows, its scalars, its route and what each pass reads."""

    ty: torch.Tensor  # f32[M, 3], padded moving rows at SENTINEL
    tgt: torch.Tensor  # f32[N, 3]
    mov_mask: torch.Tensor  # f32[M]
    tgt_mask: torch.Tensor  # f32[N]
    scalars: torch.Tensor  # f32[1, 4] (estep_scalars)
    route: torch.Tensor  # i32[1]: 1 K4 (overflow; unchecked, or no truncation), 0 K5
    table_m: torch.Tensor  # i32[N / cta_rows, width_m] (cta_tables; 0 rows where route 1)
    counts_n: torch.Tensor  # i32[N / cta_rows]
    table_n: torch.Tensor  # i32[M / cta_rows, width_n]
    counts_m: torch.Tensor  # i32[M / cta_rows]
    rows_n: torch.Tensor  # i64[cap_n * TILE]: fat target blocks' rows (_block_rows' order)
    live_n: torch.Tensor  # i32[1]: the rows of rows_n K4's subset pass serves (0 on route 1)
    valid_n: torch.Tensor  # bool[cap_n * TILE]: row < live_n
    rows_m: torch.Tensor  # i64[cap_m * TILE]
    live_m: torch.Tensor  # i32[1]
    valid_m: torch.Tensor  # bool[cap_m * TILE]
    read: torch.Tensor  # i64[3]: route, fat target blocks, fat moving blocks


def cand_plan_ref(transformed: torch.Tensor, moving_mask: torch.Tensor,
                  target: torch.Tensor, target_mask: torch.Tensor, sigma2: torch.Tensor,
                  constant: torch.Tensor, trunc_active: torch.Tensor,
                  truncate: float = 1e-3, checked: bool = False) -> Plan:
    """The plain version of the plan on any device: the torch composition
    of padding, ``estep_scalars``, ``block_admission``, both
    ``cta_tables`` and both fat subsets.  ``sigma2``, ``constant`` f32[]
    and ``trunc_active`` bool[] are tensors on the clouds' device.  The
    route is the overflow where ``checked``, else the overflow or a false
    truncation flag; CTAs of fat blocks, and all CTAs on route 1, get
    count 0."""
    m, n = round_up(transformed.shape[0], TILE), round_up(target.shape[0], TILE)
    mov = pad_rows(transformed[None], m)[0]
    mov_mask = pad_rows(moving_mask[None], m)[0]
    tgt = pad_rows(target[None], n)[0].contiguous()
    tgt_mask = pad_rows(target_mask[None], n)[0]
    a = block_admission(mov, mov_mask, tgt, tgt_mask, sigma2, trunc_active, truncate)
    dense = a.overflow if checked else a.overflow | ~trunc_active
    table_m, counts_n = cta_tables(a.sub_adm, a.f_sub, cpd_geometry(n).cta_rows,
                                   ~a.fat_n & ~dense, a.width_m)
    table_n, counts_m = cta_tables(a.sub_adm.T, a.f_sub, cpd_geometry(m).cta_rows,
                                   ~a.fat_m & ~dense, a.width_n)
    return Plan(
        torch.where(mov_mask[:, None] > 0, mov, torch.full_like(mov, SENTINEL)).contiguous(),
        tgt, mov_mask, tgt_mask,
        estep_scalars(sigma2.reshape(1), constant.reshape(1), trunc_active.reshape(1),
                      truncate),
        dense.to(torch.int32).reshape(1), table_m, counts_n, table_n, counts_m,
        *_fat_subset(a.fat_n, n // TILE, dense), *_fat_subset(a.fat_m, m // TILE, dense),
        torch.stack([dense.to(torch.int64), a.fat_n.sum(), a.fat_m.sum()]))


def _plan_check(transformed, moving_mask, target, target_mask, sigma2, constant,
                trunc_active) -> None:
    for name, t, shape in (("transformed", transformed, (3,)), ("target", target, (3,)),
                           ("moving_mask", moving_mask, ()), ("target_mask", target_mask, ())):
        if t.dim() != 1 + len(shape) or tuple(t.shape[1:]) != shape:
            raise ValueError(f"{name} must be [rows{', 3' if shape else ''}], "
                             f"got {tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    if moving_mask.shape[0] != transformed.shape[0] or target_mask.shape[0] != target.shape[0]:
        raise ValueError("a mask must have its cloud's rows")
    for name, t, dtype in (("sigma2", sigma2, torch.float32), ("constant", constant, torch.float32),
                           ("trunc_active", trunc_active, torch.bool)):
        if t.numel() != 1 or t.dtype != dtype:
            raise ValueError(f"{name} must be one {dtype}, got {t.dtype}{list(t.shape)}")
    tensors = (transformed, moving_mask, target, target_mask, sigma2, constant, trunc_active)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("the plan's operands must share one device")


def cand_plan(transformed: torch.Tensor, moving_mask: torch.Tensor, target: torch.Tensor,
              target_mask: torch.Tensor, sigma2: torch.Tensor, constant: torch.Tensor,
              trunc_active: torch.Tensor, truncate: float = 1e-3,
              checked: bool = False) -> Plan:
    """K5's plan of one E-step (``Plan``) for clouds of at least two blocks
    a side.  The CPU takes the plain version; CUDA launches
    ``csrc/cpd_plan.cu`` on the current stream (three launches, nothing
    read back), bit-equal to it, or raises."""
    global PLAN_LAUNCHES
    _plan_check(transformed, moving_mask, target, target_mask, sigma2, constant,
                trunc_active)
    m0, n0 = transformed.shape[0], target.shape[0]
    m, n = round_up(m0, TILE), round_up(n0, TILE)
    tn, tm = n // TILE, m // TILE
    if tn < 2 or tm < 2:
        raise ValueError(f"a plan needs two blocks a side, got {tn} and {tm}")
    if transformed.device.type == "cpu":
        return cand_plan_ref(transformed, moving_mask, target, target_mask, sigma2,
                             constant, trunc_active, truncate, checked)
    dev = transformed.device
    if dev.type != "cuda":
        raise RuntimeError(f"K5's plan runs on CPU or CUDA tensors, not {dev}")
    if 3 * max(m, n) >= 2**31:
        raise ValueError("K5's plan: sizes exceed the kernel's int indexing")
    # row-major operands; the scalars may be views (a pair of a batch)
    ops = [t.contiguous() for t in (transformed, moving_mask, target, target_mask)]
    from tpuslam_torch.kernels import counted, tally_ptr
    from tpuslam_torch.kernels.build import launch, load_library

    f_sub = sub_factor(tn, tm)
    cta_n, cta_m = cpd_geometry(n).cta_rows, cpd_geometry(m).cta_rows
    if (TILE // f_sub) % cta_n or (TILE // f_sub) % cta_m:
        raise ValueError(f"a CTA of {cta_n} or {cta_m} rows straddles sub-tiles of "
                         f"{TILE // f_sub}")
    cap_n, cap_m = min(fat_budget(tn), tn), min(fat_budget(tm), tm)
    width_m, width_n = table_width(tm), table_width(tn)
    work = torch.empty(load_library().tpuslam_cpd_plan_workspace(n, m, f_sub, cap_n, cap_m),
                       dtype=torch.uint8, device=dev)

    def empty(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    i32, i64 = torch.int32, torch.int64
    plan = Plan(empty((m, 3)), empty((n, 3)), empty(m), empty(n), empty((1, 4)), empty(1, i32),
                empty((n // cta_n, width_m), i32), empty(n // cta_n, i32),
                empty((m // cta_m, width_n), i32), empty(m // cta_m, i32),
                empty(cap_n * TILE, i64), empty(1, i32), empty(cap_n * TILE, torch.bool),
                empty(cap_m * TILE, i64), empty(1, i32), empty(cap_m * TILE, torch.bool),
                empty(3, i64))
    launch("tpuslam_cpd_plan", dev, *(t.data_ptr() for t in ops[:4]), m0, n0, m, n,
           sigma2.data_ptr(), constant.data_ptr(), trunc_active.data_ptr(),
           float(cut_factor(truncate)), float(np.float32(math.log(truncate))), int(checked),
           f_sub, cta_n, cta_m, width_m, width_n, fat_budget(tn), fat_budget(tm), cap_n, cap_m,
           work.data_ptr(), *(t.data_ptr() for t in plan), tally_ptr("K5_plan", dev))
    if counted("cpd_cand", 1):
        PLAN_LAUNCHES += 3
    return plan


def _finish(p: Plan, denom, pt1, acc, sigma2, m0: int, n0: int) -> Sufficient:
    out = sufficient_from(acc[None], denom[None], pt1, p.mov_mask[None], p.tgt_mask[None],
                          sigma2.reshape(1), m0, n0)
    return Sufficient(p1=out.p1[0], pt1=out.pt1[0], px=out.px[0], error=out.error[0])


def _estep_predicated(p: Plan, constant, sigma2, m0: int, n0: int) -> Sufficient:
    """The E-step with its route chosen on the device (module docstring):
    every pass launched, each predicated on the plan's route code."""
    n, m = p.tgt.shape[0], p.ty.shape[0]
    route, s0, dev = p.route, p.scalars[0], p.ty.device
    denom = torch.empty(n, dtype=torch.float32, device=dev)
    denom_cand(s0, p.ty, p.tgt, p.table_m, p.counts_n, pred=route, pred_value=0, out=denom)
    denom_pass_batch(p.scalars, p.ty[None], p.tgt[None], pred=route, pred_value=1,
                     out=denom.view(1, 1, n))
    # fat target blocks: K4's phase 1 on their rows, in the same moving-block
    # order, so bit-identical to the full K4 pass
    fat = torch.empty((1, 1, p.rows_n.shape[0]), dtype=torch.float32, device=dev)
    denom_pass_batch(p.scalars, p.ty[None], p.tgt.index_select(0, p.rows_n)[None].contiguous(),
                     pred=route, pred_value=0, live=p.live_n, out=fat)
    denom = denom.index_copy(0, p.rows_n, torch.where(p.valid_n, fat.reshape(-1),
                                                      denom.index_select(0, p.rows_n)))

    pt1, weights4 = moment_weights(denom[None], p.tgt[None], p.tgt_mask[None],
                                   constant.reshape(1))
    acc = torch.empty((4, m), dtype=torch.float32, device=dev)
    moments_cand(s0, p.ty, p.tgt, weights4[0], p.table_n, p.counts_m, pred=route,
                 pred_value=0, out=acc)
    moments_pass_batch(p.scalars, p.ty[None], p.tgt[None], weights4, pred=route,
                       pred_value=1, out=acc.view(1, 4, m))
    # fat moving blocks: K4's phase 2 on their rows
    fat = torch.empty((1, 4, p.rows_m.shape[0]), dtype=torch.float32, device=dev)
    moments_pass_batch(p.scalars, p.ty.index_select(0, p.rows_m)[None].contiguous(),
                       p.tgt[None], weights4, pred=route, pred_value=0, live=p.live_m, out=fat)
    acc = acc.index_copy(1, p.rows_m, torch.where(p.valid_m[None], fat[0],
                                                  acc.index_select(1, p.rows_m)))
    return _finish(p, denom, pt1, acc, sigma2, m0, n0)


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
    predicated: Optional[bool] = None,
) -> Union[Sufficient, Tuple[Sufficient, torch.Tensor]]:
    """Drop-in for ``cpd_dense.cpd_estep_dense`` (same contract, same
    bits) that skips the row segments proven to add exact zeros.  Most
    effective when both clouds are Morton-sorted; correct for any row
    order.  ``sigma2``, ``constant`` and ``trunc_active`` are scalars
    (tensors or Python numbers; a ``trunc_active`` that is not a tensor
    and is false runs K4 at once, with no admission and no read back).
    With ``checked=True`` returns ``(Sufficient, overflow bool[])`` and
    does not route to K4 on overflow (see the module docstring).
    ``predicated`` (None: the open ``core/choices.py`` recording's
    choice) chooses the route on the device, with no read back."""
    dev = transformed.device
    if predicated is None:
        predicated = choices.predicated()
    if predicated and checked:
        raise ValueError("checked=True reads the overflow back: it cannot be predicated")
    exact = not isinstance(trunc_active, torch.Tensor) and not trunc_active
    sigma2 = device_scalar(sigma2, torch.float32, dev)
    constant = device_scalar(constant, torch.float32, dev)
    trunc_active = device_scalar(trunc_active, torch.bool, dev)
    m0, n0 = transformed.shape[0], target.shape[0]
    m, n = round_up(m0, TILE), round_up(n0, TILE)
    tn, tm = n // TILE, m // TILE

    def dense():
        return cpd_estep_dense(transformed, moving_mask, target, target_mask,
                               sigma2, constant, trunc_active, truncate)

    if exact or tn < 2 or tm < 2:  # nothing to skip
        choices.book(ROUTE_TRACE, ROUTES, 1, dev)
        out = dense()
        return (out, torch.zeros((), dtype=torch.bool, device=dev)) if checked else out

    p = cand_plan(transformed, moving_mask, target, target_mask, sigma2, constant,
                  trunc_active, truncate, checked)
    if predicated:
        out = _estep_predicated(p, constant, sigma2, m0, n0)
        choices.book(ROUTE_TRACE, ROUTES, p.route)
        return out

    # the one read back of the call: route, and size the fat subsets (a
    # false truncation flag admits everything: K4's route)
    overflow, n_fat_n, n_fat_m = p.read.tolist()
    if overflow and not checked:
        choices.book(ROUTE_TRACE, ROUTES, 1, dev)
        return dense()
    choices.book(ROUTE_TRACE, ROUTES, 0, dev)

    # on overflow (checked only) every count is zeroed: the kernels become
    # count-gated no-ops and the caller discards the result
    ty, tgt, scalars = p.ty, p.tgt, p.scalars
    denom = denom_cand(scalars[0], ty, tgt, p.table_m, p.counts_n)
    if n_fat_n and not overflow:
        # fat target blocks: K4's phase 1 on their rows, in the same
        # moving-block order, so bit-identical to the full K4 pass
        rows = p.rows_n[:n_fat_n * TILE]
        sub = tgt.index_select(0, rows)[None].contiguous()
        denom = denom.index_copy(
            0, rows, denom_pass_batch(scalars, ty[None], sub).reshape(-1))

    pt1, weights4 = moment_weights(denom[None], tgt[None], p.tgt_mask[None],
                                   constant.reshape(1))
    acc = moments_cand(scalars[0], ty, tgt, weights4[0], p.table_n, p.counts_m)
    if n_fat_m and not overflow:
        # fat moving blocks: K4's phase 2 on their rows
        rows = p.rows_m[:n_fat_m * TILE]
        sub = ty.index_select(0, rows)[None].contiguous()
        acc = acc.index_copy(
            1, rows, moments_pass_batch(scalars, sub, tgt[None], weights4)[0])

    out = _finish(p, denom, pt1, acc, sigma2, m0, n0)
    if checked:
        return out, torch.tensor(bool(overflow), device=dev)
    return out
