"""The launch geometry of kernel K1 (``csrc/nn_dense.cu``) and a
plain-torch model of how it folds, on the CPU.

K1 runs only on the card (``test_torch_cuda.py``); what decides its shape
is Python and is tested here: sources a thread, splits of the target
range and the ring for the shapes the main path gives it.  The model
computes what the kernel computes, step for step, and must equal the
plain version bit for bit:

* within a segment of ``SEGMENT`` targets each source keeps only its
  running minimum (``fminf``, which drops a NaN); a strict '<' after the
  segment records the segment's first row; the first row of the recorded
  segment whose distance equals the minimum is the answer;
* the target range ``[0, count)`` is cut into ``splits`` contiguous
  ranges, each folded alone, and the partial (minimum, segment row) pairs
  are combined lexicographically in any order.
"""

import numpy as np
import pytest
import torch

from tpuslam_torch.kernels import nn_dense
from tpuslam_torch.kernels.nn_dense import BIG, fma_sq_dist


def _ranges(valid, splits):
    """The kernel's split ranges [valid * s / S, valid * (s + 1) / S)."""
    return [(valid * s // splits, valid * (s + 1) // splits) for s in range(splits)]


def _k1_model(src, tgt, count, splits, seg=nn_dense.SEGMENT):
    """K1 on one pair (``src`` f32[N, 3], ``tgt`` f32[M, 3], ``count``
    an int): minimum then locate in each split's range, the partials
    combined in reverse split order."""
    n = src.shape[0]
    valid = min(max(int(count), 0), tgt.shape[0])
    if valid == 0:
        return torch.zeros(n, dtype=torch.int32), torch.full((n,), BIG)
    d = fma_sq_dist(src, tgt[:valid])
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    parts = []
    for r0, r1 in _ranges(valid, splits):
        best = torch.full((n,), BIG)
        row = torch.zeros(n, dtype=torch.long)
        for q in range(r0, r1, seg):
            low = torch.minimum(best, d[:, q:min(q + seg, r1)].amin(1))
            row = torch.where(low < best, torch.full_like(row, q), row)
            best = low
        parts.append((best, row))
    best = torch.full((n,), BIG)
    row = torch.full((n,), 2**31 - 1, dtype=torch.long)
    for pd, pr in reversed(parts):
        better = (pd < best) | ((pd == best) & (pr < row))
        best, row = torch.where(better, pd, best), torch.where(better, pr, row)
    cols = row[:, None] + torch.arange(seg)
    match = (cols < valid) & (d.gather(1, cols.clamp(max=valid - 1)) == best[:, None])
    found = best < BIG
    idx = torch.where(found, row + torch.argmax(match.int(), dim=1), 0)
    return idx.to(torch.int32), torch.where(found, best, torch.full_like(best, BIG))


def _model_batch(src, tgt, count, splits):
    outs = [_k1_model(src[p], tgt[p], count[p], splits) for p in range(src.shape[0])]
    return torch.stack([i for i, _ in outs]), torch.stack([d for _, d in outs])


@pytest.mark.parametrize("batch,n,m,want", [
    (1, 102_400, 102_400, (4, 8)),  # the dense arm at 100k: 1,600 blocks
    (1, 8192, 8192, (2, 8)),  # the v5e gate: 32 source blocks x 8 splits
    (16, 2048, 2048, (4, 8)),  # the batched row
    (1, 1_048_576, 102_400, (4, 1)),  # 1M sources fill the card alone
])
def test_dense_geometry(batch, n, m, want):
    geo = nn_dense.dense_geometry(batch, n, m)
    assert (geo.rows_per_thread, geo.splits) == want
    assert geo.threads == nn_dense.THREADS == 128  # kThreads of csrc/nn_dense.cu
    blocks = batch * -(-n // (geo.threads * geo.rows_per_thread))
    assert blocks * geo.splits >= nn_dense.FILL_BLOCKS  # two blocks on each SM
    assert 1 <= geo.splits <= nn_dense.MAX_SPLITS
    assert geo.stage_rows % nn_dense.SEGMENT == 0 and 2 <= geo.depth <= 3
    assert geo.smem_bytes == 12 * geo.depth * geo.stage_rows + 8 * geo.threads * geo.rows_per_thread
    assert geo.smem_bytes <= 48 * 1024  # no opt-in needed
    ranges = _ranges(m, geo.splits)
    assert all(r1 > r0 for r0, r1 in ranges)  # every split holds targets
    assert [j for r0, r1 in ranges for j in range(r0, r1)] == list(range(m))


@pytest.mark.parametrize("batch,n,m", [(1, 1000, 777), (2, 300, 1000), (1, 10, 0),
                                       (1, 5, 300), (3, 70_000, 2048)])
def test_dense_geometry_small_and_ragged(batch, n, m):
    """No split is smaller than ``MIN_SPLIT_ROWS``, the ring no larger than
    a split's share (rounded up to a segment), the small grids take two
    sources a thread."""
    geo = nn_dense.dense_geometry(batch, n, m)
    assert geo.splits == 1 or m // geo.splits >= nn_dense.MIN_SPLIT_ROWS
    assert geo.stage_rows <= max(nn_dense.SEGMENT, -(-m // geo.splits) + nn_dense.SEGMENT - 1)
    if batch * -(-n // 512) * nn_dense.MAX_SPLITS < nn_dense.FILL_BLOCKS:
        assert geo.rows_per_thread == 2


def _nan_inf_problem(rng, n=300, m=1000, count=900):
    src = (rng.random((n, 3)) * 10).astype(np.float32)
    src[3] = np.nan
    src[7, 1] = np.nan
    src[11] = np.inf
    src[13, 2] = -np.inf
    src[17] = 1e30  # every distance overflows to +inf
    tgt = (rng.random((m, 3)) * 10).astype(np.float32)
    tgt[5] = np.inf
    tgt[9, 0] = np.nan
    tgt[400:420] = np.nan
    tgt[count:] = np.nan  # past the count: never read
    return torch.from_numpy(src), torch.from_numpy(tgt), count


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_model_equals_plain_with_ties_across_splits(rng, splits):
    """Every target point three times, one copy in each third of the
    range, so that equal targets sit in different splits: the first copy
    must win."""
    lattice = (rng.integers(-8, 8, size=(700, 3)) * 4).astype(np.float32)
    tgt = torch.from_numpy(np.concatenate([lattice + [1, 0, 0], lattice - [1, 0, 0],
                                           lattice + [1, 0, 0]]).astype(np.float32))
    src = torch.from_numpy(lattice[rng.permutation(700)])
    got = _k1_model(src, tgt, len(tgt), splits)
    want = nn_dense.nearest_neighbors_dense_ref(src[None], tgt[None],
                                                torch.tensor([len(tgt)], dtype=torch.int32))
    assert torch.equal(got[0], want[0][0]) and torch.equal(got[1], want[1][0])
    assert bool((got[0] < 700).all()) and bool((got[1] == 1.0).all())


@pytest.mark.parametrize("splits", [1, 2, 8])
def test_model_equals_plain_under_contract_on_nan_and_inf_rows(rng, splits):
    src, tgt, count = _nan_inf_problem(rng)
    got = _k1_model(src, tgt, count, splits)
    want = nn_dense.plain_under_contract(src[None], tgt[None],
                                         torch.tensor([count], dtype=torch.int32))
    assert torch.equal(got[0], want[0][0]) and torch.equal(got[1], want[1][0])
    # NaN and inf sources, and the overflowing one, report no match
    for i in (3, 7, 11, 13, 17):
        assert int(got[0][i]) == 0 and bool(got[1][i] == BIG)
    # a NaN target never wins; the finite sources find finite neighbours
    bad = torch.isnan(tgt).any(1) | torch.isinf(tgt).any(1)
    finite = torch.isfinite(src).all(1) & (src.abs() < 1e20).all(1)
    assert not bool(bad[got[0][finite].long()].any())


def test_plain_under_contract_is_the_plain_version_on_finite_rows(rng):
    """On the finite rows of the NaN/inf problem the contract changes
    nothing; NaN or inf sources and valid NaN targets are what it maps."""
    src, tgt, count = _nan_inf_problem(rng)
    cnt = torch.tensor([count], dtype=torch.int32)
    plain = nn_dense.nearest_neighbors_dense_ref(src[None], tgt[None], cnt)
    mapped = nn_dense.plain_under_contract(src[None], tgt[None], cnt)
    clean = tgt.clone()
    clean[:count][torch.isnan(tgt[:count]).any(1)] = float("inf")
    plain_clean = nn_dense.nearest_neighbors_dense_ref(src[None], clean[None], cnt)
    finite = torch.isfinite(src).all(1) & (src.abs() < 1e20).all(1)
    assert torch.equal(mapped[0][0][finite], plain_clean[0][0][finite])
    assert torch.equal(mapped[1][0][finite], plain_clean[1][0][finite])
    # the plain version's argmin takes the valid NaN rows where the contract does not
    assert bool(torch.isnan(plain[1][0][finite]).all())
    assert not bool(torch.isnan(mapped[1]).any())


@pytest.mark.parametrize("count", [0, 1, 31, 33, 257, 999])
@pytest.mark.parametrize("splits", [1, 4])
def test_model_equals_plain_on_counts_inside_a_segment_and_a_stage(rng, count, splits):
    src = torch.from_numpy((rng.random((200, 3)) * 10).astype(np.float32))
    tgt = torch.from_numpy((rng.random((1000, 3)) * 10).astype(np.float32))
    got = _k1_model(src, tgt, count, splits)
    want = nn_dense.nearest_neighbors_dense_ref(src[None], tgt[None],
                                                torch.tensor([count], dtype=torch.int32))
    assert torch.equal(got[0], want[0][0]) and torch.equal(got[1], want[1][0])
    if count == 0:
        assert bool((got[0] == 0).all()) and bool((got[1] == BIG).all())


def test_model_equals_plain_on_a_ragged_batch(rng):
    """16 pairs of 2,048 (as 16 x 256 here) with ragged counts, each
    folded with the splits its geometry gives."""
    src = torch.from_numpy((rng.random((16, 256, 3)) * 10).astype(np.float32))
    tgt = torch.from_numpy((rng.random((16, 256, 3)) * 10).astype(np.float32))
    count = torch.tensor([256, 255, 200, 1, 0, 33, 64, 65, 128, 100, 256, 7, 250, 31, 32, 129],
                         dtype=torch.int32)
    splits = nn_dense.dense_geometry(16, 2048, 2048).splits
    got = _model_batch(src, tgt, count, splits)
    want = nn_dense.nearest_neighbors_dense_ref(src, tgt, count)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_model_on_sorted_targets(rng):
    """Targets in ascending x: many segments lower the running minimum
    one after the other; the locate still finds the first row."""
    tgt = np.sort((rng.random((2000, 3)) * 10).astype(np.float32), axis=0)
    tgt = torch.from_numpy(np.concatenate([tgt, tgt]))  # every row twice
    src = torch.from_numpy((rng.random((100, 3)) * 10).astype(np.float32))
    got = _k1_model(src, tgt, len(tgt), 3)
    want = nn_dense.nearest_neighbors_dense_ref(src[None], tgt[None],
                                                torch.tensor([len(tgt)], dtype=torch.int32))
    assert torch.equal(got[0], want[0][0]) and torch.equal(got[1], want[1][0])
    assert bool((got[0] < 2000).all())
