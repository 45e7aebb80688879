"""Hierarchical exact nearest-neighbour search (port of
``tpuslam/ops/nn_hier.py``): per-source tile-centre bounds, a warm upper
bound from the previous query, and a count-gated candidate rescore.

Targets are Morton-sorted once per registration and cut into tiles of
``g`` rows, each with a bounding sphere (``prepare_hier_target``).  Each
query, for sources Morton-sorted once and moving rigidly:

1. the bound pass, kernel K2 (``kernels/bound.py``), admits for every
   group of ``gsrc`` sources the tiles that may hold a member's nearest
   neighbour: per-source upper bound from the tile centres (hi/lo bf16
   split operands with a rigorous error ``eps``), tightened from the
   second query on by the exact distance to the previous query's match;
2. when every group's admitted tiles fit the budget, the fine arm: a
   candidate table (``_build_cand_table``) and the rescore kernel K3
   (``kernels/nn_cand.py``) over tiles of ``g`` rows;
3. else, when the admission regrouped to coarse tiles of ``g2`` rows
   fits, the coarse arm: the same K3 over those;
4. else the dense arm, K1 on the target in its original order.

Every arm returns the dense oracle's result bit for bit (the fold is
lexicographic on distance and original index).

The JAX package picks the arm on the device with nested ``lax.cond``.
The overflow flags become an arm code on the device (``arm_code``: 0
fine, 1 coarse, 2 dense).  Inside an ICP loop captured as a CUDA graph
(a predicated ``core/choices.py`` recording) the port chooses without a
host read: both candidate tables are built, and K3 (fine), K3 (coarse)
and K1 are all launched, each predicated on the code, so exactly one of
them writes the result and the other two return at once.  Everywhere
else (the CPU, a loop that is not captured, a query on its own) the host
branch stays, as such a loop reads the host every iteration anyway: the
code is read and only the branch taken builds its table and runs.  Each
query books its code to ``ARM_TRACE`` through ``core/choices.py``: a
loop's chunk carries it to the host with its one read, and a query
outside such a loop appends its arm at once.

``nearest_neighbors_hier_batch`` is the batched form (the JAX package's
``nearest_neighbors_hier_batch``, which its custom-vmap rule lowers a
vmapped query to): every input gains a leading pair axis, K1, K2 and K3
run their batch forms, and the arm is chosen once for the whole batch,
dense while any pair overflows.  The solo ``nearest_neighbors_hier`` is
its batch of one.
"""

from __future__ import annotations

from collections import deque
from typing import NamedTuple, Optional, Tuple

import torch

from tpuslam_torch.core import choices
from tpuslam_torch.kernels.bound import INFLATE_ADD, INFLATE_MUL, bound_pass_batch
from tpuslam_torch.kernels.nn_cand import nearest_neighbors_cand_batch
from tpuslam_torch.kernels.nn_dense import nearest_neighbors_dense_batch
from tpuslam_torch.ops.spatial import morton_permutation, sqrt_rn, tile_bounds

BIG = 3.4e38
DEFAULT_G = 128  # target rows per candidate tile
DEFAULT_GSRC = 1024  # source rows per rescore group (see auto_tile_params)
DEFAULT_L = 192  # candidate-tile budget (slots, multiple of 8)
# hi/lo-split product error: dropped terms are <= ~4*2^-16*(|s||c|+|c|^2)
# plus f32 accumulation; 8e-5 over-covers the 6.1e-5 worst case
_EPS_REL = 8e-5
# packed target indices are float32: exact below 2**24 rows
MAX_ROWS = 2**24

# the arm of each recent query, newest last ("fine", "coarse", "dense")
ARM_TRACE: deque = deque(maxlen=4096)
# the arm codes (ARMS[code]) of the device's arm choice
ARMS = ("fine", "coarse", "dense")


def arm_code(overflow: torch.Tensor, overflow2: Optional[torch.Tensor]) -> torch.Tensor:
    """i32[1] arm code from the overflow flags (bool tensors; ``overflow2``
    None where there is no coarse arm), in the JAX ``lax.cond`` order:
    dense (2) while any group overflows the fine budget and the coarse arm
    overflows too (or does not exist), coarse (1) while only the fine arm
    overflows, else fine (0)."""
    beyond = torch.ones_like(overflow) if overflow2 is None else overflow2
    code = torch.where(overflow, torch.where(beyond, 2, 1), 0)
    return code.to(torch.int32).reshape(1)


class HierTarget(NamedTuple):
    """Per-registration target state; rigid motion of the sources never
    invalidates it."""

    packed: torch.Tensor  # f32[M, 4] — sorted (x, y, z, original index)
    original_points: torch.Tensor  # f32[M, 3] — pre-sort order (dense arm)
    count: torch.Tensor  # i32[]
    radii: torch.Tensor  # f32[C] — tile bounding spheres (inflated)
    caug: torch.Tensor  # bf16[12, C] — hi/lo split product operand
    center_ref: torch.Tensor  # f32[3] — centring offset for the split
    cmax: torch.Tensor  # f32[] — max |centre - center_ref| over valid tiles


class HierState(NamedTuple):
    """Carry from one query to the next (threaded through the ICP loop)."""

    # the previous query's matched target point, a real cloud point, so
    # the distance to it is a rigorous NN upper bound at any position
    prev_target: torch.Tensor  # f32[N, 3]
    warm: torch.Tensor  # bool[] — prev_target is valid
    sparse: torch.Tensor  # bool[] — the last query took a sparse arm


def table_width(m: int, g: int = DEFAULT_G, l_budget: int = DEFAULT_L) -> int:
    """Static candidate-table width: the budget, clamped to the tile count
    and rounded up to a multiple of 8 (the JAX kernel's slot granule,
    kept so the tables match)."""
    c = max(m // g, 1)
    return -(-min(l_budget, c) // 8) * 8


def auto_tile_params(m: int) -> Tuple[int, int, int]:
    """Size-scaled ``(g, gsrc, l_budget)``, as the JAX package chooses
    them: ``g`` doubles until the tile count C = m // g is at most 2,560;
    the budget is 192 up to C = 1,280 and 512 above; ``gsrc`` is 1,024
    up to g = 256 and 512 above.  These were swept on a TPU v5e; the
    port keeps them until a sweep on the card replaces them."""
    g = 128
    while m // g > 2560:
        g *= 2
    c = max(m // g, 1)
    l_budget = 192 if c <= 1280 else 512
    gsrc = 1024 if g <= 256 else 512
    return g, gsrc, l_budget


def hier_state_init(n: int, device=None, batch: Tuple[int, ...] = ()) -> HierState:
    """The cold state of ``n`` sources (of each of ``batch`` pairs)."""
    return HierState(
        prev_target=torch.zeros(batch + (n, 3), dtype=torch.float32, device=device),
        warm=torch.zeros(batch, dtype=torch.bool, device=device),
        sparse=torch.zeros(batch, dtype=torch.bool, device=device),
    )


def _split_hi_lo(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """bf16 (hi, lo) with ``x ≈ hi + lo``; both conversions round to
    nearest even, as XLA's do."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def prepare_hier_target(
    points: torch.Tensor,
    mask: torch.Tensor,
    count: torch.Tensor,
    g: int = DEFAULT_G,
    presorted: bool = False,
) -> HierTarget:
    """Morton-sort the target, cut it into tiles of ``g`` rows and build
    the bound and rescore operands.  Rows past ``count`` (sorted last)
    get far-sentinel coordinates (1e19) and index 3.4e38, so they never
    win a fold.  Raises for ``M`` not a multiple of ``g`` and for
    ``M >= 2**24`` rows, where float32 indices stop being exact.

    ``presorted=True`` skips the sort: the rows must already be in Morton
    order with invalid rows last (``ops/spatial.py::host_morton_order``,
    as the sequence drivers sort each scan once for both of its roles).
    The packed tie-break index is then the sorted row position, so the
    returned indices and ``original_points`` live in the sorted order."""
    m = points.shape[0]
    if m % g:
        raise ValueError(f"padded target length {m} must divide the tile size {g}")
    if m >= MAX_ROWS:
        raise ValueError(
            f"hierarchical NN packs target indices as float32: {m} rows "
            "exceeds the exactly representable 2^24 range (use the dense kernel)"
        )
    # python scalars meet float32 tensors as float32 values, as the JAX
    # package's jnp.float32 constants do
    if presorted:
        perm = torch.arange(m, dtype=torch.int32, device=points.device)
    else:
        perm = morton_permutation(points, mask)
    sorted_points = points[perm]
    bounds = tile_bounds(sorted_points, mask[perm], g)
    # conservative inflation, rounded as XLA contracts it on the CPU:
    # one fused multiply-add (emulated in float64, where r * c is exact)
    radii = (bounds.radii.double() * INFLATE_MUL + INFLATE_ADD).float()

    valid_tile = bounds.centers[:, 0] < 1e14
    lo = torch.amin(torch.where(valid_tile[:, None], bounds.centers, BIG), dim=0)
    hi = torch.amax(torch.where(valid_tile[:, None], bounds.centers, -BIG), dim=0)
    center_ref = torch.where(torch.any(valid_tile), (lo + hi) * 0.5, 0.0)

    c_rel = bounds.centers - center_ref  # sentinel tiles stay ~1e15
    c2 = (c_rel[:, 0] * c_rel[:, 0] + c_rel[:, 1] * c_rel[:, 1]
          + c_rel[:, 2] * c_rel[:, 2])
    c_hi, c_lo = _split_hi_lo(c_rel)
    c2_hi, c2_lo = _split_hi_lo(c2)
    caug = torch.cat(
        [
            c_hi.T, c_lo.T, c_hi.T,  # against -2 s_hi, -2 s_hi, -2 s_lo
            c2_hi[None, :], c2_lo[None, :],  # against 1, 1
            torch.zeros_like(c2_hi)[None, :],  # pad to K = 12
        ],
        dim=0,
    ).contiguous()
    cmax = sqrt_rn(torch.amax(torch.where(valid_tile, c2, 0.0)))
    row_invalid = torch.arange(m, device=points.device) >= count
    packed = torch.cat(
        [
            torch.where(row_invalid[:, None], 1e19, sorted_points),
            torch.where(row_invalid, BIG, perm.to(torch.float32))[:, None],
        ],
        dim=1,
    ).contiguous()
    return HierTarget(
        packed=packed,
        original_points=points,
        count=count,
        radii=radii,
        caug=caug,
        center_ref=center_ref,
        cmax=cmax,
    )


def bound_operands(
    transformed: torch.Tensor,
    src_mask: torch.Tensor,
    target: HierTarget,
    state: HierState,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2's source operands for one query: (``saug`` bf16[N, 12], ``aux``
    f32[N, 4] = (s2, warm upper bound, valid flag, 0), ``eps`` f32[]),
    the JAX package's expressions (``nn_hier.py:389-427``); with a leading
    pair axis on every input, per pair (``nn_hier.py:543-573``)."""
    dev = transformed.device
    s_rel = transformed - target.center_ref[..., None, :]
    s2 = (s_rel[..., 0] * s_rel[..., 0] + s_rel[..., 1] * s_rel[..., 1]
          + s_rel[..., 2] * s_rel[..., 2])
    s_hi, s_lo = _split_hi_lo(s_rel)
    # scaling by -2 is exact in bf16 (a power of two)
    neg2_hi = (-2.0 * s_hi.float()).to(torch.bfloat16)
    neg2_lo = (-2.0 * s_lo.float()).to(torch.bfloat16)
    ones = torch.ones(s2.shape + (1,), dtype=torch.bfloat16, device=dev)
    saug = torch.cat(
        [neg2_hi, neg2_hi, neg2_lo, ones, ones, torch.zeros_like(ones)], dim=-1
    )
    smax = sqrt_rn(torch.amax(s2, dim=-1))
    cmax = target.cmax
    eps = _EPS_REL * (smax * cmax + cmax * cmax + smax * smax) + 1e-6
    # the exact distance to the previous matched target point, inflated
    # to cover the norm's float32 error
    ub_warm = (
        torch.linalg.vector_norm(transformed - state.prev_target, dim=-1)
        * (1.0 + 1e-5) + 1e-6
    )
    aux = torch.stack(
        [s2, ub_warm, (src_mask > 0).to(torch.float32), torch.zeros_like(s2)],
        dim=-1,
    )
    return saug, aux, eps


def _coarse_tile_rows(g: int, gsrc: int) -> int:
    """Tile rows of the coarse middle arm (0 = no coarse arm), the JAX
    package's choice."""
    g2 = 512 if gsrc >= 1024 else 1024
    return g2 if g2 > g else 0


def coarse_admission(adm: torch.Tensor, g: int, g2: int) -> torch.Tensor:
    """bool[..., ts, C // f]: the fine admission regrouped to tiles of
    ``g2`` rows (a coarse tile is admitted when any of its fine tiles is)."""
    c = adm.shape[-1]
    return adm.reshape(adm.shape[:-1] + (c * g // g2, g2 // g)).any(dim=-1)


def _build_cand_table(
    adm: torch.Tensor, counts: torch.Tensor, width: int
) -> torch.Tensor:
    """i32[ts, width]: each group's admitted tile ids, ascending,
    compacted left; dead slots repeat the last live id and an empty
    group's row is 0 — the JAX package's table for the same ``adm``.

    Each admitted id goes to slot ``cumsum - 1`` by one scatter (ids past
    ``width`` are dropped, into a spare column), O(ts·C); the JAX
    package's rank count over every slot exists because the TPU's sort
    was slow."""
    ts, c = adm.shape
    slot = torch.cumsum(adm.to(torch.int32), dim=1) - 1
    keep = adm & (slot < width)
    slot = torch.where(keep, slot, torch.full_like(slot, width)).long()
    ids = torch.arange(c, dtype=torch.int32, device=adm.device).expand(ts, c)
    cand = torch.full((ts, width + 1), -1, dtype=torch.int32, device=adm.device)
    cand.scatter_(1, slot, ids)
    cand = cand[:, :width]
    live = torch.arange(width, device=adm.device)[None, :] < torch.clamp_max(
        counts, width)[:, None]
    cand = torch.where(live, cand, torch.full_like(cand, -1))
    return torch.clamp_min(torch.cummax(cand, dim=1).values, 0).contiguous()


def nearest_neighbors_hier(
    transformed: torch.Tensor,
    src_mask: torch.Tensor,
    target: HierTarget,
    state: HierState,
    l_budget: int = DEFAULT_L,
    g: int = DEFAULT_G,
    gsrc: int = DEFAULT_GSRC,
) -> Tuple[torch.Tensor, torch.Tensor, HierState]:
    """(original-target index i32[N], squared distance f32[N], updated
    state) for each sorted source row, bit-identical to the dense oracle
    for valid sources.  ``state`` from ``hier_state_init`` on the first
    query, then threaded through (positions of the same sorted source
    cloud, moving rigidly between queries).  Appends the arm taken to
    ``ARM_TRACE`` (inside a ``core/choices.py`` recording, the chunk's
    report does).
    The batch of one of ``nearest_neighbors_hier_batch``."""
    idx, dist, new = nearest_neighbors_hier_batch(
        transformed[None], src_mask[None],
        HierTarget(*(t[None] for t in target)),
        HierState(*(t[None] for t in state)),
        l_budget=l_budget, g=g, gsrc=gsrc,
    )
    return idx[0], dist[0], HierState(*(t[0] for t in new))


def nearest_neighbors_hier_batch(
    transformed: torch.Tensor,
    src_mask: torch.Tensor,
    target: HierTarget,
    state: HierState,
    l_budget: int = DEFAULT_L,
    g: int = DEFAULT_G,
    gsrc: int = DEFAULT_GSRC,
) -> Tuple[torch.Tensor, torch.Tensor, HierState]:
    """``nearest_neighbors_hier`` over a leading pair axis: ``transformed``
    f32[B, N, 3], ``src_mask`` f32[B, N], and every leaf of ``target`` and
    ``state`` with its pair axis (pairs prepared one by one and stacked)
    -> (i32[B, N], f32[B, N], batched state).

    The arm is chosen once for the batch, as in the JAX package
    (``nn_hier.py:579``, ``:599-627``): dense while any group of any pair
    overflows its budget, else coarse while any overflows the fine one,
    else fine (``arm_code``; on the device in a captured loop, else by one
    host read of the code).  Every arm is exact, so each pair's result
    equals its solo query's."""
    b, n = transformed.shape[0], transformed.shape[1]
    m = target.packed.shape[1]
    c = m // g
    if n < gsrc:  # small direct calls: one group is the whole cloud
        gsrc = n
    if n % gsrc:
        raise ValueError(f"N = {n} is not a multiple of gsrc = {gsrc}")
    ts = n // gsrc
    width = table_width(m, g, l_budget)
    l_eff = min(l_budget, c)  # overflow threshold (the true budget)

    saug, aux, eps = bound_operands(transformed, src_mask, target, state)
    adm = bound_pass_batch(saug, aux, target.caug, target.radii, eps, state.warm, gsrc)
    counts = torch.sum(adm, dim=2, dtype=torch.int32)  # [B, ts]
    flags = [torch.any(counts > l_eff)]

    # the coarse middle arm: admission regrouped to g2-row tiles, a
    # superset of the fine admission, taken only while it does at most
    # ~5/8 of the dense scan's row work
    g2 = _coarse_tile_rows(g, gsrc)
    c2 = m // g2 if g2 else 0
    coarse = bool(g2) and m % g2 == 0 and c2 >= 8
    if coarse:
        adm2 = coarse_admission(adm, g, g2)
        counts2 = torch.sum(adm2, dim=2, dtype=torch.int32)
        l_eff2 = min(l_budget, (5 * c2) // 8)
        width2 = -(-min(l_budget, c2) // 8) * 8
        flags.append(torch.any(counts2 > l_eff2))

    def table(a, cnt, w):
        return _build_cand_table(a.reshape(b * ts, -1), cnt.reshape(b * ts),
                                 w).reshape(b, ts, w)

    def fine(**kw):
        return nearest_neighbors_cand_batch(
            transformed, target.packed, table(adm, counts, width),
            torch.clamp_max(counts, l_eff), g=g, gsrc=gsrc, **kw)

    def coarse_arm(**kw):
        return nearest_neighbors_cand_batch(
            transformed, target.packed, table(adm2, counts2, width2),
            torch.clamp_max(counts2, l_eff2), g=g2, gsrc=gsrc, **kw)

    def dense(**kw):
        return nearest_neighbors_dense_batch(
            transformed, target.original_points, target.count, **kw)

    runs = (fine, coarse_arm if coarse else None, dense)  # by arm code
    code = arm_code(flags[0], flags[1] if coarse else None)
    dev = transformed.device
    if dev.type == "cuda" and choices.predicated():
        # every arm launched, each predicated on the device's code: no read
        idx = torch.empty((b, n), dtype=torch.int32, device=dev)
        dist = torch.empty((b, n), dtype=torch.float32, device=dev)
        for value, run in enumerate(runs):
            if run is not None:
                run(arm=code, arm_value=value, out=(idx, dist))
    else:
        # the host branch: one read of the code, only the branch taken
        taken = int(code)
        idx, dist = runs[taken]()
    # inside a recording the device's code, which the chunk's report reads
    choices.book(ARM_TRACE, ARMS, code if choices.is_recording() else taken)
    # both arms already give the oracle's (0, BIG) on no match; kept, as
    # in the JAX package, so idx stays in range whatever a kernel does
    idx = torch.where(dist >= BIG, torch.zeros_like(idx), idx)
    return idx, dist, HierState(
        prev_target=torch.take_along_dim(
            target.original_points, idx.long()[..., None], dim=1),
        warm=torch.ones((b,), dtype=torch.bool, device=dev),
        sparse=(code != 2).repeat(b),
    )
