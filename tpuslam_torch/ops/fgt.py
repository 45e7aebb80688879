"""Fast Gauss Transform, truncated Taylor form (port of
``tpuslam/ops/fgt.py``).

Approximates ``v_m = sum_n w_n exp(-|y_m - x_n|^2 / sigma^2)`` in
O(N + M) instead of O(N M), as the reference's CPU FGT (``fgt.cpp``):

* K-center clustering (``KCenter``, ``fgt.cpp:147-207``): farthest-point
  selection from row 1, an eager loop of ``k - 1`` argmax steps over
  device tensors (no host read), then centres as segment means;
* Taylor monomials ``dy^alpha`` in the reference's graded-lex order,
  from per-dimension power tables and a static multi-index table
  (``_alpha_table``, built on the host; ``fgt_tables`` puts it and the
  coefficients on each device once and keeps them, so that a call copies
  and reads nothing after the first, as a CUDA graph needs);
* source expansion ``A_k`` (``ComputeA_k``, ``fgt.cpp:262-303``): a
  segment sum over the cluster assignments, scaled by
  ``C_alpha = 2^|alpha| / alpha!``;
* prediction (``ComputeFGTPredict``, ``fgt.cpp:84-145``): dense
  (target x K centres) evaluation, the far-field cutoff as a mask.

The expansion and the prediction are ``kernels/fgt.py``'s: on CUDA the
hand-written kernels K7 and K6, which form the monomials in registers
and shared memory, on the CPU their plain versions, the torch
composition.  JAX's ``segment_sum`` becomes a sum in an order the data
fixes, on the CPU and the card alike: the rows are sorted by cluster once
per clustering (a stable sort, ``segment_order``) and each cluster's rows
are added in that order (``segment_sum``, ``torch.segment_reduce``, in
the plain version; K7's fixed order on the card).  No atomics, so the
same inputs give the same bits in every run; the tests hold the sums to
float64 and to the JAX package at a tolerance.  The squared distances of
the clustering are rounded as XLA rounds them on the CPU, so
``k_center``'s picks and assignments equal the JAX package's.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from tpuslam_torch.ops.spatial import sq_norm_xla

DIM = 3
# bytes of one [chunk, K, pd] float32 intermediate of the plain prediction
# on CUDA (kernels/fgt.py::predict_plain, which the card's tests and timings
# compare K6 with); a few such tensors are live at once.  At K = 128, p = 8
# (pd = 120, 61,440 bytes a row) this gives 4,352 targets per step, inside
# the fastest band of chunks timed on an H100 at 376k (3,072 to 6,144)
PREDICT_BYTES_CUDA = 256 << 20
# the JAX package's chunk, kept for the CPU
PREDICT_CHUNK_CPU = 256


def n_choose_k(n: int, k: int) -> int:
    return math.comb(n, k)


def pd_size(p: int) -> int:
    """Number of Taylor terms: C(p + d - 1, d) (``fgt.cpp:73``)."""
    return n_choose_k(p + DIM - 1, DIM)


def _alpha_table(p: int) -> np.ndarray:
    """Multi-index exponents in the reference's graded-lex emission order
    (the heads/tails recurrence of ``fgt.cpp:122-137``): per degree k, for
    each dimension i, the degree-(k-1) terms whose leading dimension is
    >= i, each multiplied by dy[i]."""
    terms = [np.zeros(DIM, dtype=np.int32)]
    heads = [0, 0, 0, 2**31]
    t, tail = 1, 1
    for _ in range(1, p):
        new_tail = tail
        for i in range(DIM):
            head = heads[i]
            heads[i] = t
            for j in range(head, new_tail):
                alpha = terms[j].copy()
                alpha[i] += 1
                terms.append(alpha)
                t += 1
        tail = t
    table = np.stack(terms)
    if len(table) != pd_size(p):
        raise AssertionError(f"alpha table has {len(table)} terms, not {pd_size(p)}")
    return table


def _c_coefficients(p: int) -> np.ndarray:
    """``C_alpha = 2^|alpha| / alpha!`` (``ComputeC_k``,
    ``fgt.cpp:209-240``)."""
    alpha = _alpha_table(p)
    total = alpha.sum(axis=1)
    fact = np.array(
        [math.factorial(a) for a in range(int(alpha.max()) + 1)],
        dtype=np.float64,
    )
    denom = fact[alpha[:, 0]] * fact[alpha[:, 1]] * fact[alpha[:, 2]]
    return (2.0 ** total / denom).astype(np.float32)


class SegmentOrder(NamedTuple):
    """A clustering's rows sorted by cluster: ``order`` i64[N] (a stable
    sort, so each cluster keeps its rows in their original order) and
    ``lengths`` i64[K], each cluster's row count."""

    order: torch.Tensor
    lengths: torch.Tensor


def segment_order(indx: torch.Tensor, k: int) -> SegmentOrder:
    """The ``SegmentOrder`` of assignments ``indx`` i32[N] in [0, k)."""
    return SegmentOrder(torch.argsort(indx, stable=True),
                        torch.bincount(indx, minlength=k))


def segment_sum(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Per-cluster sums of ``values`` [N, ...] whose rows are sorted by
    cluster (``SegmentOrder.order``): [K, ...], each cluster's rows added
    one after the other from 0 (an empty cluster gives 0).  ``unsafe``
    skips the argument checks, which read the lengths back to the host."""
    return torch.segment_reduce(values, "sum", lengths=lengths, unsafe=True)


class FGTModel(NamedTuple):
    """The reference's ``FGT_Model`` (``fgt_model.h:7-13``)."""

    centers: torch.Tensor  # f32[K, 3]
    ak: torch.Tensor  # f32[K, pd] (or [K, pd, W] for the multi-weight form)


def k_center(
    points: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    k_rt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Farthest-point clustering (``KCenter``, ``fgt.cpp:147-207``):
    (centers f32[k, 3], assignment i32[N]).  Invalid (padded) rows never
    become centres and are assigned cluster 0; callers give them zero
    weight.

    ``k_rt`` (optional, an int32 tensor <= k) is the reference's
    per-iteration adaptive centre count (``cpdutils.cpp:35``): selection
    steps past it change nothing, so clusters ``>= k_rt`` get no points."""
    centers, indx, _ = k_center_ordered(points, mask, k, k_rt)
    return centers, indx


def k_center_ordered(
    points: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    k_rt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, SegmentOrder]:
    """``k_center`` and the ``SegmentOrder`` its centres were summed in."""
    n = points.shape[0]
    first = points[1 % n]  # deterministic seed, fgt.cpp:160
    d0 = sq_norm_xla(points - first)
    dist_c = torch.where(mask > 0, d0, torch.full_like(d0, -1.0))
    indx = torch.zeros(n, dtype=torch.int32, device=points.device)
    for i in range(1, k):
        center = points.index_select(0, torch.argmax(dist_c).reshape(1))
        d = sq_norm_xla(points - center)
        better = d < dist_c
        if k_rt is not None:
            better = torch.logical_and(better, i < k_rt)
        dist_c = torch.where(better, d, dist_c)
        indx = torch.where(better, torch.full_like(indx, i), indx)
    seg = segment_order(indx, k)
    w = mask.to(torch.float32).index_select(0, seg.order)
    counts = segment_sum(w, seg.lengths)
    sums = segment_sum(points.index_select(0, seg.order) * w[:, None], seg.lengths)
    centers = sums / torch.clamp_min(counts, 1.0)[:, None]
    return centers, indx, seg


class FGTTables(NamedTuple):
    """The static tables of order ``p`` on a device: the multi-indices
    (``_alpha_table``) and ``C_alpha`` (``_c_coefficients``).  Their
    largest exponent is ``p - 1`` (``max_pow``)."""

    alpha: torch.Tensor  # i64[pd, 3]
    coeff: torch.Tensor  # f32[pd]


def max_pow(p: int) -> int:
    """The largest single exponent of ``_alpha_table(p)``: the degree
    ``p - 1`` of its last terms."""
    return max(p - 1, 0)


# FGTTables by (order, device), each made once (fgt_tables)
_TABLES: dict = {}


def fgt_tables(p: int, device) -> FGTTables:
    """``FGTTables`` of order ``p`` on ``device``: two host-to-device
    copies on the first call, kept for every later one.  A registration's
    set-up makes them (``algorithms/cpd.py``), so that no copy falls
    inside a captured E-step."""
    key = (p, str(torch.device(device)))
    tables = _TABLES.get(key)
    if tables is None:
        alpha = _alpha_table(p)
        if int(alpha.max(initial=0)) != max_pow(p):
            raise AssertionError(f"alpha table of order {p} tops at {int(alpha.max())}")
        tables = _TABLES[key] = FGTTables(
            torch.from_numpy(alpha.astype(np.int64)).to(device),
            torch.from_numpy(_c_coefficients(p)).to(device))
    return tables


def _monomials(dy: torch.Tensor, p: int) -> torch.Tensor:
    """``dy^alpha`` for every multi-index, in the reference's order, from
    ``dy`` f32[..., 3] (already divided by sigma) -> f32[..., pd]."""
    alpha = fgt_tables(p, dy.device).alpha
    d = torch.movedim(dy, -1, 0)  # [3, ...]: each coordinate contiguous
    pows = [torch.ones_like(d)]
    for _ in range(max_pow(p)):
        pows.append(pows[-1] * d)
    pow_stack = torch.stack(pows, dim=1)  # [3, max_pow + 1, ...]
    mx = torch.index_select(pow_stack[0], 0, alpha[:, 0])
    my = torch.index_select(pow_stack[1], 0, alpha[:, 1])
    mz = torch.index_select(pow_stack[2], 0, alpha[:, 2])
    return torch.movedim(mx * my * mz, 0, -1)


def compute_fgt_model(
    points: torch.Tensor,
    weights: torch.Tensor,
    sigma: torch.Tensor,
    k: int,
    p: int,
) -> FGTModel:
    """``ComputeFGTModel`` (``fgt.cpp:66-88``).  ``weights`` must be zero
    on padded rows (they then add nothing to any expansion)."""
    model = compute_fgt_model_multi(
        points, weights[:, None], (weights != 0).to(torch.float32), sigma, k, p)
    return FGTModel(centers=model.centers, ak=model.ak[..., 0])


def compute_fgt_model_multi(
    points: torch.Tensor,
    weights: torch.Tensor,
    mask: torch.Tensor,
    sigma: torch.Tensor,
    k: int,
    p: int,
    k_rt: Optional[torch.Tensor] = None,
    clustering: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    order: Optional[SegmentOrder] = None,
) -> FGTModel:
    """Batched-weights model: ``weights`` f32[N, W] -> ``ak`` f32[K, pd, W].
    One clustering serves every weight vector (the reference rebuilds it
    per vector, ``cpdutils.cpp:41-66``).  ``clustering`` = precomputed
    ``(centers f32[k, 3], indx i32[N])`` skips the selection: the CPD loop
    clusters each cloud once and moves the moving cloud's centres with
    it (see ``algorithms/cpd.py``); ``order``, its ``SegmentOrder``, skips
    the sort too.  The expansions are ``kernels/fgt.py::expand``: K7 on
    CUDA, the torch composition (the [N, pd, W] summands formed in that
    order and summed per cluster) on the CPU."""
    if clustering is None:
        centers, indx, order = k_center_ordered(points, mask, k, k_rt)
    else:
        centers, indx = clustering
        if order is None:
            order = segment_order(indx, k)
    from tpuslam_torch.kernels import fgt as fgt_kernels

    return FGTModel(centers=centers,
                    ak=fgt_kernels.expand(points, weights, mask, sigma, centers, indx, order, p))


def predict_chunk(device: torch.device, k: int, p: int) -> int:
    """Targets per prediction step: on CUDA as many as keep one
    [chunk, K, pd] float32 intermediate within ``PREDICT_BYTES_CUDA``
    (a multiple of 256); on the CPU the JAX package's 256."""
    if torch.device(device).type != "cuda":
        return PREDICT_CHUNK_CPU
    per_row = k * pd_size(p) * 4
    return max(256, (PREDICT_BYTES_CUDA // per_row) // 256 * 256)


def fgt_predict(
    targets: torch.Tensor,
    model: FGTModel,
    sigma: torch.Tensor,
    e_param: float,
    p: int,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """``ComputeFGTPredict`` (``fgt.cpp:90-145``): f32[M] approximate
    Gauss-transform values; clusters beyond the far-field radius
    (``|dy|^2 > e_param``) contribute zero."""
    multi = FGTModel(centers=model.centers, ak=model.ak[..., None])
    return fgt_predict_multi(targets, multi, sigma, e_param, p, chunk)[:, 0]


def fgt_predict_multi(
    targets: torch.Tensor,
    model: FGTModel,
    sigma: torch.Tensor,
    e_param: float,
    p: int,
    chunk: Optional[int] = None,
) -> torch.Tensor:
    """Batched-weights prediction: ``ak`` f32[K, pd, W] -> f32[M, W]
    (``kernels/fgt.py::predict``): K6 in one launch on CUDA; on the CPU
    the torch composition in chunks of ``chunk`` targets
    (``predict_chunk`` when None), one float32 matrix product each."""
    from tpuslam_torch.kernels import fgt as fgt_kernels

    return fgt_kernels.predict(targets, model.centers, model.ak, sigma, e_param, p, chunk)
