"""The launch geometry of kernels K2 (``csrc/bound.cu``), K3
(``csrc/nn_cand.cu``), K4 and K5 (``csrc/cpd_dense.cu``,
``csrc/cpd_cand.cu``), and plain-torch models of how K2 and K3 cut a
group's work across the blocks of a cluster and how K4 cuts the other
cloud's blocks across CTAs.

The kernels run only on the card (``test_torch_cuda.py``); what decides
their shape is Python and is tested here: sources per thread, splits per
group, ring depth and shared-memory bytes for the shapes the main path
gives them, and the two facts the split rests on:

* K3 folds each block's share of a group's live rows lexicographically on
  (distance, original index) and combines the blocks' partial pairs in
  any order: the result equals the plain version bit for bit, ties
  across blocks included;
* K2 marks in its first pass every tile a valid source would admit under
  its running bound; every running bound is at least the final one, so
  the marks cover the admitted tiles, which the second pass re-tests.
"""

import numpy as np
import pytest
import torch

from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.kernels import bound, nn_cand
from tpuslam_torch.kernels.nn_dense import BIG, fma_sq_dist
from tpuslam_torch.ops import nn_hier
from tpuslam_torch.ops.nn import nearest_neighbors_ref
from tpuslam_torch.ops.spatial import morton_permutation, sqrt_rn


@pytest.mark.parametrize("batch,ts,width,gsrc,want", [
    (1, 100, 192, 1024, (2, 8)),  # 100k, fine table
    (1, 100, 64, 1024, (2, 8)),  # 100k, coarse table (g2 = 512)
    (2, 100, 192, 1024, (2, 8)),  # a pair of 100k clouds
    (8, 100, 192, 1024, (2, 2)),  # eight of them
    (1, 2048, 512, 512, (1, 2)),  # 1M: 2,048 groups, two blocks a group
    (2, 2048, 512, 512, (1, 1)),  # a pair at 1M fills the card alone
    (1, 1, 24, 700, (2, 8)),  # one ragged group
    (1, 4, 3, 1024, (2, 4)),  # no more splits than slots
    (1, 4, 0, 1024, (2, 1)),  # an empty table
])
def test_cand_geometry(batch, ts, width, gsrc, want):
    geo = nn_cand.cand_geometry(batch, ts, width, gsrc)
    assert (geo.chunks, geo.splits) == want
    assert geo.chunks * nn_cand.CHUNK >= gsrc > (geo.chunks - 1) * nn_cand.CHUNK
    assert nn_cand.CHUNK == 128 * 4  # kThreads x kR of csrc/nn_cand.cu
    assert geo.splits & (geo.splits - 1) == 0 and geo.splits <= nn_cand.MAX_SPLITS
    assert geo.stage_rows % 4 == 0 and 2 <= geo.depth <= 4
    assert geo.smem_bytes == 16 * geo.depth * geo.stage_rows + 8 * nn_cand.CHUNK + 4 * width
    # the ring is the same for every tile size, 24 KiB, under the 48 KiB
    # a block may take without opting in
    assert geo.smem_bytes <= 48 * 1024
    assert nn_cand.CHUNK % geo.splits == 0  # each block finishes an equal share


@pytest.mark.parametrize("batch,n,c,gsrc,want", [
    (1, 102_400, 800, 1024, (2, 4, 200, 200)),  # 100k
    (2, 102_400, 800, 1024, (2, 4, 200, 200)),  # a pair of them
    (1, 1_048_576, 2048, 512, (1, 8, 256, 256)),  # 1M
    (1, 4096, 64, 1024, (2, 2, 32, 32)),  # small: split for the grid
    (1, 4096, 64, 256, (1, 2, 32, 32)),
    (1, 3000, 64, 3000, (6, 1, 64, 64)),  # one ragged group of 6 chunks
    (1, 4096, 321, 1024, (2, 4, 81, 81)),  # C = 321
    (1, 4096, 321, 4096, (8, 1, 321, 256)),  # a full cluster: two stages
    (1, 8192, 5, 1024, (2, 1, 5, 5)),  # fewer tiles than a split's minimum
])
def test_bound_geometry(batch, n, c, gsrc, want):
    geo = bound.bound_geometry(batch, n, c, gsrc)
    assert (geo.chunks, geo.splits, geo.span, geo.stage) == want
    assert bound.CHUNK == 128 * 4  # kThreads x kR of csrc/bound.cu
    assert geo.chunks * bound.CHUNK >= gsrc > (geo.chunks - 1) * bound.CHUNK
    assert geo.chunks * geo.splits <= bound.MAX_CLUSTER
    assert geo.span * geo.splits >= c > geo.span * (geo.splits - 1)
    assert geo.smem_bytes == 4 * geo.stage * 13 + 4 * bound.CHUNK + 4 * geo.span
    assert geo.smem_bytes <= bound.SMEM_LIMIT


def test_bound_geometry_rejects_what_one_cluster_cannot_serve():
    with pytest.raises(ValueError, match="cluster"):
        bound.bound_geometry(1, 8192, 64, 8192)
    with pytest.raises(ValueError, match="shared memory"):
        bound.bound_geometry(1, 4096, 60_000, 4096)


@pytest.mark.parametrize("live,splits", [(0, 8), (3, 8), (87, 4), (192, 8), (50, 1)])
def test_cand_split_ranges_cover_the_live_slots(live, splits):
    """The kernel's ranges [live * s / S, live * (s + 1) / S) partition the
    live slots; the combine's shares partition a block's sources."""
    ranges = [(live * s // splits, live * (s + 1) // splits) for s in range(splits)]
    assert [i for a, b in ranges for i in range(a, b)] == list(range(live))
    share = nn_cand.CHUNK // splits
    assert sorted(j for s in range(splits) for j in range(s * share, (s + 1) * share)) \
        == list(range(nn_cand.CHUNK))


@pytest.mark.parametrize("chunks,span,length", [(2, 200, 200), (1, 256, 256), (8, 321, 321),
                                                (6, 64, 64), (2, 81, 78)])
def test_bound_store_covers_each_tile_once(chunks, span, length):
    """Block (chunk, split) stores tiles k = chunk * 128 + t, stepping
    chunks * 128: each tile of the range exactly once."""
    stored = [k for ch in range(chunks) for t in range(128)
              for k in range(ch * 128 + t, length, chunks * 128)]
    assert sorted(stored) == list(range(length))


def _lex_fold(d, w):
    """Lexicographic minimum of (d, w) along dim 1, from (3.4e38, 3.4e38),
    a NaN distance never winning: the kernel's fold."""
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    d = torch.cat([d, torch.full_like(d[:, :1], BIG)], 1)
    w = torch.cat([w.expand(d.shape[0], -1), torch.full_like(d[:, :1], BIG)], 1)
    best = torch.amin(d, dim=1)
    return best, torch.amin(torch.where(d == best[:, None], w, float("inf")), dim=1)


def _split_fold(src, packed, cand, counts, g, gsrc, splits):
    """K3 as the kernel cuts it: each group's live slots in ``splits``
    contiguous ranges, each range folded alone from (3.4e38, 3.4e38) with
    +inf rows for ids out of range, the partial pairs combined in reverse
    split order."""
    n = src.shape[0]
    tiles = packed.shape[0] // g
    idx = torch.zeros(n, dtype=torch.int32)
    dist = torch.full((n,), BIG)
    inf_row = torch.tensor([float("inf")] * 3 + [BIG])
    for grp in range(cand.shape[0]):
        live = int(counts[grp].clamp(0, cand.shape[1]))
        s = src[grp * gsrc:(grp + 1) * gsrc]
        parts = []
        for p in range(splits):
            ids = cand[grp, live * p // splits:live * (p + 1) // splits].tolist()
            rows = torch.cat([packed[t * g:(t + 1) * g] if 0 <= t < tiles
                              else inf_row.expand(g, 4) for t in ids] + [inf_row[None]])
            parts.append(_lex_fold(fma_sq_dist(s, rows[:, :3]), rows[None, :, 3]))
        d = torch.stack([pd for pd, _ in reversed(parts)], 1)
        w = torch.stack([pw for _, pw in reversed(parts)], 1)
        best, best_w = _lex_fold(d, w)
        none = best >= nn_cand.NO_MATCH
        dist[grp * gsrc:(grp + 1) * gsrc] = torch.where(none, torch.tensor(BIG), best)
        idx[grp * gsrc:(grp + 1) * gsrc] = torch.where(
            none, torch.zeros_like(best_w), best_w).to(torch.int32)
    return idx, dist


@pytest.mark.parametrize("splits", [1, 2, 8])
def test_split_fold_equals_plain_with_ties_across_splits(rng, splits):
    """Every target point twice, the lower original index in the later
    tiles; sentinel rows, an out-of-range id and an empty group."""
    g, m, gsrc = 32, 1024, 128
    pts = (rng.integers(-10, 10, size=(m // 2, 3)) * 4).astype(np.float32)
    low = rng.permutation(m // 2).astype(np.float32)
    rows = np.concatenate([np.concatenate([pts, (low + m // 2)[:, None]], 1),
                           np.concatenate([pts, low[:, None]], 1)]).astype(np.float32)
    rows[-40:, :3], rows[-40:, 3] = 1e19, BIG
    packed = torch.from_numpy(rows)
    # sources near points whose second copy is not a sentinel row
    src = torch.from_numpy(pts[rng.integers(0, m // 2 - 40, size=3 * gsrc)] + 1.0)
    tiles = m // g
    cand = torch.stack([torch.randperm(tiles, generator=torch.Generator().manual_seed(s))
                        for s in range(3)]).to(torch.int32)
    cand[1, 3] = tiles + 2
    counts = torch.tensor([tiles, 20, 0], dtype=torch.int32)
    got = _split_fold(src, packed, cand, counts, g, gsrc, splits)
    want = nn_cand.nearest_neighbors_cand_ref(src[None], packed[None], cand[None],
                                              counts[None], g, gsrc)
    assert torch.equal(got[0], want[0][0]) and torch.equal(got[1], want[1][0])
    assert bool((got[0][:gsrc] < m // 2).all())  # the lower copy wins the tie
    assert bool((got[1][2 * gsrc:] == BIG).all())


@pytest.mark.parametrize("warm,splits", [(False, 1), (True, 1), (True, 4), (False, 8)])
def test_running_bound_marks_cover_the_admitted_tiles(rng, warm, splits):
    """K2's pass-1 marks, modelled in torch: per split, the running bound
    after each tile (a running minimum, from the warm bound when warm),
    inflated, and the admission test under it.  The marks must hold every
    tile the plain version admits."""
    n, m, gsrc = 1024, 4096, 256
    src = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32))
    src = src[morton_permutation(src, torch.ones(n)).long()].contiguous()
    cloud = pad_cloud((rng.random((3900, 3)) * 10).astype(np.float32), multiple=m)
    target = nn_hier.prepare_hier_target(cloud.points, cloud.mask(), cloud.count)
    idx, _ = nearest_neighbors_ref(src, cloud.points, cloud.count)
    state = nn_hier.HierState(cloud.points[idx.long()], torch.tensor(warm), torch.tensor(False))
    moved = src + torch.from_numpy((rng.standard_normal(src.shape) * 0.05).astype(np.float32))
    mask = torch.ones(n)
    mask[-30:] = 0
    saug, aux, eps = nn_hier.bound_operands(moved, mask, target, state)
    adm = bound.bound_pass_ref(saug[None], aux[None], target.caug[None], target.radii[None],
                               eps[None], state.warm[None], gsrc)[0]
    c = target.radii.shape[0]
    dc2 = bound.center_dist2(saug.float(), target.caug.float(), aux[:, 0])
    u = sqrt_rn(torch.clamp_min(dc2, 0.0) + eps) + target.radii
    start = torch.minimum(torch.full((n,), float("inf")), aux[:, 1]) if warm \
        else torch.full((n,), float("inf"))
    span = -(-c // splits)
    marks = torch.zeros((n // gsrc, c), dtype=torch.bool)
    for p in range(splits):
        cols = slice(p * span, min(c, (p + 1) * span))
        running = torch.minimum(torch.cummin(u[:, cols], dim=1).values, start[:, None])
        ubi = running * bound.INFLATE_MUL + bound.INFLATE_ADD
        t = ubi + target.radii[cols]
        hit = (dc2[:, cols] <= t * t + eps) & (aux[:, 2:3] > 0)
        marks[:, cols] = hit.reshape(n // gsrc, gsrc, -1).any(dim=1)
    assert bool(adm.any())
    assert not bool((adm & ~marks).any())
    if warm:
        assert int(marks.sum()) < marks.numel()  # pass 2 skips tiles


@pytest.mark.parametrize("rows,batch,other,want", [
    (20_480, 1, 20, (1, 7)),  # the JAX records' E-step row: 320 CTAs x 7 splits
    (20_480, 2, 20, (1, 4)),
    (40_960, 2, 40, (2, 1)),  # a pair of them fills the card
    (376_832, 1, 368, (2, 1)),  # 376,401 padded: 2,944 CTAs of 128 rows
    (3072, 1, 368, (1, 44)),  # K5's three fat blocks at 376k
    (2048, 1, 2, (1, 2)),  # no more splits than blocks
    (1_300_480, 1, 1270, (2, 1)),  # 1.3M
])
def test_cpd_geometry(rows, batch, other, want):
    """K4's and K5's launch geometry: 64 threads a CTA (the kernels' only
    block size), two rows a thread wherever the grid keeps 8 warps on
    each SM, else one and the other cloud's blocks split over CTAs; a
    CTA's rows divide a block and the sub-tile K5 masks by."""
    from tpuslam_torch.kernels import cpd_cand, cpd_dense

    geo = cpd_dense.cpd_geometry(rows, batch, other)
    assert (geo.threads, geo.rows_per_thread, geo.splits) == (64, *want)
    assert geo.cta_rows == 64 * geo.rows_per_thread and cpd_dense.TILE % geo.cta_rows == 0
    ctas = rows // geo.cta_rows
    assert ctas * geo.cta_rows == rows
    if geo.rows_per_thread == 2:
        assert batch * ctas * geo.threads >= cpd_dense.FILL_THREADS
    assert 1 <= geo.splits <= other
    # K5 takes the same rows a CTA and never splits
    assert cpd_dense.cpd_geometry(rows, batch).cta_rows == geo.cta_rows
    assert cpd_dense.cpd_geometry(rows, batch).splits == 1
    blocks = rows // cpd_dense.TILE
    f_sub = cpd_cand.sub_factor(blocks, blocks)
    assert f_sub == (4 if rows > 1_000_000 else 8)
    sub = cpd_dense.TILE // f_sub
    assert sub % geo.cta_rows == 0  # a CTA never straddles two sub-tiles
    assert cpd_cand.SEGS % f_sub == 0  # a sub-tile bit covers whole segments
    assert cpd_cand.table_width(blocks) <= 8192  # kMaxWidth of csrc/cpd_cand.cu


@pytest.mark.parametrize("splits", [1, 3, 7, 20])
def test_cpd_split_ranges_partition_the_blocks(splits):
    """Split z walks blocks [z B / S, (z + 1) B / S): every block of the
    other cloud exactly once, in ascending order across the splits, so the
    combine's ordered sum of the stored partials is the unsplit total."""
    blocks = 20
    walked = [j for z in range(splits)
              for j in range(z * blocks // splits, (z + 1) * blocks // splits)]
    assert walked == list(range(blocks))
