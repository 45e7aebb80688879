"""Kernels K1 to K5, the ICP slice and the CPD slice of the PyTorch port
on a CUDA card.

Every test here needs a card and nvcc; without them each one skips (the
``cuda`` fixture decides, at run time).  The file imports neither JAX
nor ``tpuslam``, so it runs where JAX is not installed, without the
JAX-loading ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

On the card, K1 and K3 must be bit-identical (idx and dist) to their
plain versions (K3 at every tile size, whatever the order of a group's
slots, with ties planted across the blocks that split a group), K2 must
admit exactly what its plain version admits at every group size, the
hierarchical search must be bit-identical to K1, and a registration must
agree with the CPU run within 1e-4 in R and t (cuSOLVER against LAPACK,
sums in another order).  K4 must agree with its plain version within
1e-5 relative (the sums inside a block run in another order; the
Gaussian's distance and truncation are the same), and K5 must equal K4
bit for bit; K5's plan kernel must equal its plain version bit for bit.
"""

import numpy as np
import pytest
import torch

import tpuslam_torch
from tpuslam_torch import kernels
from tpuslam_torch.data.synthesis import (
    get_random_rotation_matrix,
    get_random_translation_vector,
)
from tpuslam_torch.algorithms.icp import icp_register
from tpuslam_torch.core.types import pad_cloud
from tpuslam_torch.algorithms.cpd import cpd_register
from tpuslam_torch.config.configuration import ApproximationType
from tpuslam_torch.kernels import bound, cpd_cand, cpd_dense, nn_cand, nn_dense
from tpuslam_torch.ops import nn_hier
from tpuslam_torch.ops.nn import nearest_neighbors, nearest_neighbors_ref
from tpuslam_torch.ops.spatial import morton_permutation

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.Generator(np.random.PCG64(666))


@pytest.mark.parametrize("b,n,m,counts", [
    (1, 1000, 777, [500]),  # ragged count, sizes not multiples of 128
    (2, 300, 1000, [1000, 0]),  # a batch of two, one without targets
    (1, 4096, 8192, [8192]),
])
def test_kernel_bit_identical_to_plain(rng, cuda, b, n, m, counts):
    src = torch.from_numpy((rng.random((b, n, 3)) * 10).astype(np.float32))
    tgt = torch.from_numpy((rng.random((b, m, 3)) * 10).astype(np.float32))
    count = torch.tensor(counts, dtype=torch.int32)
    src, tgt, count = src.to(cuda), tgt.to(cuda), count.to(cuda)
    before = nn_dense.LAUNCHES
    idx, dist = nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
    torch.cuda.synchronize()
    assert nn_dense.LAUNCHES == before + 1
    ref_idx, ref_dist = nn_dense.nearest_neighbors_dense_ref(src, tgt, count)
    assert torch.equal(idx, ref_idx)
    assert torch.equal(dist, ref_dist)
    for p, c in enumerate(counts):
        if c == 0:
            assert torch.all(idx[p] == 0)
            assert torch.all(dist[p] == nn_dense.BIG)


def test_kernel_planted_ties(rng, cuda):
    src = (rng.integers(-20, 20, size=(200, 3)) * 4).astype(np.float32)
    tgt = np.concatenate([src - [1, 0, 0], src + [1, 0, 0]]).astype(np.float32)
    s, t = torch.from_numpy(src).to(cuda), torch.from_numpy(tgt).to(cuda)
    count = torch.tensor(len(tgt), dtype=torch.int32, device=cuda)
    idx, dist = nearest_neighbors(s, t, count)
    ref_idx, ref_dist = nearest_neighbors_ref(s, t, count)
    assert torch.equal(idx, ref_idx)
    assert torch.equal(dist, ref_dist)
    assert torch.all(idx < 200) and torch.all(dist == 1.0)


def test_kernel_rejects_non_contiguous(cuda):
    src = torch.zeros((1, 8, 6), device=cuda)[..., ::2]
    count = torch.tensor([8], dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        nn_dense.nearest_neighbors_dense_batch(src, src.contiguous(), count)


def _k1_case(rng, name):
    """The inputs of one of ``chip_smoke.py``'s phase-3 cases of K1, and
    whether it is held to the plain version under K1's contract."""
    def box(*shape):
        return torch.from_numpy((rng.random(shape) * 10).astype(np.float32))

    if name == "8192^2":
        return box(1, 8192, 3), box(1, 8192, 3), [8192], False
    if name == "16 x 2048 ragged":
        return box(16, 2048, 3), box(16, 2048, 3), [
            2048, 2047, 1500, 1, 0, 33, 257, 1024, 2000, 999, 2048, 7, 1800, 31, 32, 1283], False
    if name == "count inside a split and a stage":
        return box(1, 20_000, 3), box(1, 102_400, 3), [50_001], False
    if name == "ties across splits":
        lattice = (rng.integers(-40, 40, size=(8192, 3)) * 4).astype(np.float32)
        ties = np.concatenate([lattice + [1, 0, 0], lattice - [1, 0, 0],
                               lattice + [1, 0, 0]]).astype(np.float32)
        return torch.from_numpy(lattice)[None], torch.from_numpy(ties)[None], [len(ties)], False
    src = (rng.random((4096, 3)) * 10).astype(np.float32)
    src[3], src[7, 1], src[11], src[13, 2], src[17] = np.nan, np.nan, np.inf, -np.inf, 1e30
    tgt = (rng.random((8192, 3)) * 10).astype(np.float32)
    tgt[5], tgt[9, 0], tgt[4000:4040], tgt[8000:] = np.inf, np.nan, np.nan, np.nan
    return torch.from_numpy(src)[None], torch.from_numpy(tgt)[None], [8000], True


@pytest.mark.parametrize("name", ["8192^2", "16 x 2048 ragged", "count inside a split and a stage",
                                  "ties across splits", "NaN and inf rows"])
def test_kernel_phase3_cases_bit_identical_to_plain(rng, cuda, name):
    """Tolerance 0 on every split geometry phase 3 reaches; NaN and inf
    rows against the plain version under K1's contract (argmin would take
    a NaN)."""
    src, tgt, counts, contract = _k1_case(rng, name)
    count = torch.tensor(counts, dtype=torch.int32, device=cuda)
    src, tgt = src.to(cuda), tgt.to(cuda)
    before = nn_dense.LAUNCHES
    idx, dist = nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
    torch.cuda.synchronize()
    assert nn_dense.LAUNCHES == before + 1
    plain = nn_dense.plain_under_contract if contract else nn_dense.nearest_neighbors_dense_ref
    ref_idx, ref_dist = plain(src, tgt, count)
    assert torch.equal(idx, ref_idx) and torch.equal(dist, ref_dist)
    if name == "ties across splits":
        assert nn_dense.dense_geometry(1, 8192, tgt.shape[1]).splits > 1
        assert bool((idx < 8192).all()) and bool((dist == 1.0).all())


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8])
@pytest.mark.parametrize("stage", [32, 256])
def test_kernel_every_split_and_stage(rng, cuda, monkeypatch, splits, stage):
    """K1 bit-identical to its plain version whatever the geometry: every
    number of splits, a ring of one segment a stage, four and two
    sources a thread, a count inside a segment."""
    monkeypatch.setattr(nn_dense, "MIN_SPLIT_ROWS", 32)
    monkeypatch.setattr(nn_dense, "STAGE_ROWS", stage)
    for n, m, c in ((4096, 8192, 8192), (1000, 3000, 2999), (70_000, 4096, 4001)):
        rpt = nn_dense.dense_geometry(1, n, m).rows_per_thread
        monkeypatch.setattr(nn_dense, "BLOCKS_TARGET", splits * -(-n // (128 * rpt)))
        geo = nn_dense.dense_geometry(1, n, m)
        src = torch.from_numpy((rng.random((1, n, 3)) * 10).astype(np.float32)).to(cuda)
        tgt = torch.from_numpy((rng.random((1, m, 3)) * 10).astype(np.float32)).to(cuda)
        count = torch.tensor([c], dtype=torch.int32, device=cuda)
        idx, dist = nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
        ref_idx, ref_dist = nn_dense.nearest_neighbors_dense_ref(src, tgt, count)
        assert geo.splits == splits and geo.stage_rows == stage
        assert torch.equal(idx, ref_idx) and torch.equal(dist, ref_dist)


@pytest.mark.parametrize("bad", [dict(smem_bytes=1), dict(rows_per_thread=3), dict(splits=9),
                                 dict(stage_rows=48), dict(threads=256), dict(depth=4)])
def test_kernel_refused_geometry_raises(cuda, monkeypatch, bad):
    """A geometry the C entry point does not take is refused there, and
    the wrapper raises; nothing counts as launched."""
    real = nn_dense.dense_geometry
    monkeypatch.setattr(nn_dense, "dense_geometry", lambda *a: real(*a)._replace(**bad))
    src = torch.zeros((1, 64, 3), device=cuda)
    count = torch.tensor([64], dtype=torch.int32, device=cuda)
    before = nn_dense.LAUNCHES
    with pytest.raises(RuntimeError, match="launch failed"):
        nn_dense.nearest_neighbors_dense_batch(src, src, count)
    assert nn_dense.LAUNCHES == before


def test_fgt_expansions_bit_equal_across_calls(rng, cuda):
    """The FGT's segment sums add in an order the data fixes: two calls on
    the same inputs give the same bits (expansions and E-step)."""
    from tpuslam_torch.algorithms.cpd import cpd_estep_fgt
    from tpuslam_torch.ops import fgt

    n = 60_000
    pts = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(cuda)
    other = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(cuda)
    mask = torch.ones(n, device=cuda)
    w = torch.from_numpy(rng.random((n, 4)).astype(np.float32)).to(cuda)
    sigma = torch.tensor(2.0, device=cuda)
    a = fgt.compute_fgt_model_multi(pts, w, mask, sigma, 128, 8)
    b = fgt.compute_fgt_model_multi(pts, w, mask, sigma, 128, 8)
    assert torch.equal(a.ak, b.ak) and torch.equal(a.centers, b.centers)
    cnt = torch.sum(mask)
    s2 = torch.tensor(3.0, device=cuda)
    e1, e2 = (cpd_estep_fgt(pts, mask, other, mask, s2, torch.tensor(0.1, device=cuda), cnt,
                            cnt, 128, 8, 10.0, sigma2_init=s2) for _ in range(2))
    for f in ("p1", "pt1", "px", "error"):
        assert torch.equal(getattr(e1, f), getattr(e2, f)), f


def test_register_on_card_launches_k1_and_matches_cpu(rng, cuda):
    n = 8000  # padded to 8,064 target rows: below the hierarchical gate
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.2)
    t = get_random_translation_vector(rng, 1.0)
    after = (before @ r.T + t).astype(np.float32)[rng.permutation(n)]
    kw = dict(max_iterations=50, max_distance_squared=1e4,
              convergence_epsilon=1e-5)
    launches = nn_dense.LAUNCHES
    on_card = tpuslam_torch.register(before, after, device=cuda, **kw)
    assert nn_dense.LAUNCHES > launches
    on_cpu = tpuslam_torch.register(before, after, device="cpu", **kw)
    assert on_card[2] == on_cpu[2]
    np.testing.assert_allclose(on_card[0], on_cpu[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card[1], on_cpu[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card[0], r, atol=1e-3)


def _hier_problem(rng, device, n=4096, m=8192, count=8000, noise=0.02):
    """Sorted sources moved a little from a warm state, the prepared
    target and the bound operands, on ``device``."""
    src = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32))
    mask = torch.ones(n)
    mask[-100:] = 0.0
    src = src[morton_permutation(src, torch.ones(n)).long()].contiguous()
    cloud = pad_cloud((rng.random((count, 3)) * 10).astype(np.float32), multiple=m,
                      device="cpu")
    target = nn_hier.prepare_hier_target(cloud.points, cloud.mask(), cloud.count)
    idx, _ = nearest_neighbors_ref(src, cloud.points, cloud.count)
    state = nn_hier.HierState(cloud.points[idx.long()], torch.tensor(True),
                              torch.tensor(False))
    moved = src + torch.from_numpy(
        (rng.standard_normal(src.shape) * noise).astype(np.float32))
    to = lambda x: x.to(device)  # noqa: E731
    target = nn_hier.HierTarget(*map(to, target))
    state = nn_hier.HierState(*map(to, state))
    cloud = cloud._replace(points=to(cloud.points), count=to(cloud.count))
    return to(moved), to(mask), target, state, cloud


@pytest.mark.parametrize("warm,gsrc", [(False, 1024), (True, 1024), (True, 256)])
def test_bound_kernel_admits_as_plain(rng, cuda, warm, gsrc):
    moved, mask, target, state, _ = _hier_problem(rng, cuda)
    state = state._replace(warm=torch.tensor(warm, device=cuda))
    saug, aux, eps = nn_hier.bound_operands(moved, mask, target, state)
    before = bound.LAUNCHES
    adm = bound.bound_pass(saug, aux, target.caug, target.radii, eps, state.warm, gsrc)
    torch.cuda.synchronize()
    assert bound.LAUNCHES == before + 1
    ref = bound.bound_pass_ref(saug[None], aux[None], target.caug[None],
                               target.radii[None], eps[None], state.warm[None], gsrc)[0]
    assert torch.equal(adm, ref)
    # a batch of two: the same pair and the same pair cold
    pair = lambda x: torch.stack([x, x])  # noqa: E731
    warm2 = torch.tensor([warm, False], device=cuda)
    adm2 = bound.bound_pass_batch(pair(saug), pair(aux), pair(target.caug),
                                  pair(target.radii), pair(eps), warm2, gsrc)
    ref2 = bound.bound_pass_ref(pair(saug), pair(aux), pair(target.caug),
                                pair(target.radii), pair(eps), warm2, gsrc)
    assert torch.equal(adm2, ref2) and torch.equal(adm2[0], adm)


@pytest.mark.parametrize("arm", ["fine", "coarse"])
def test_cand_kernel_bit_identical_to_plain(rng, cuda, arm):
    moved, mask, target, state, _ = _hier_problem(rng, cuda)
    saug, aux, eps = nn_hier.bound_operands(moved, mask, target, state)
    adm = bound.bound_pass(saug, aux, target.caug, target.radii, eps, state.warm, 1024)
    g = 128 if arm == "fine" else 512
    if arm == "coarse":
        adm = nn_hier.coarse_admission(adm, 128, g)
    counts = adm.sum(1, dtype=torch.int32)
    width = nn_hier.table_width(8192, g, 8192)
    cand = nn_hier._build_cand_table(adm, counts, width)
    ragged = counts.clone()
    ragged[0] = 0  # one group with no live slot
    ragged[1] = counts[1] // 2
    before = nn_cand.LAUNCHES
    for c in (counts, ragged):
        idx, dist = nn_cand.nearest_neighbors_cand(
            moved, target.packed, cand, c, g=g, gsrc=1024)
        ref_idx, ref_dist = nn_cand.nearest_neighbors_cand_ref(
            moved[None], target.packed[None], cand[None], c[None], g, 1024)
        torch.cuda.synchronize()
        assert torch.equal(idx, ref_idx[0]) and torch.equal(dist, ref_dist[0])
    assert nn_cand.LAUNCHES == before + 2
    assert bool((dist[:1024] == nn_cand.BIG).all())
    pair = lambda x: torch.stack([x, x])  # noqa: E731
    b_idx, b_dist = nn_cand.nearest_neighbors_cand_batch(
        pair(moved), pair(target.packed), pair(cand),
        torch.stack([counts, ragged]), g, 1024)
    r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(
        pair(moved), pair(target.packed), pair(cand),
        torch.stack([counts, ragged]), g, 1024)
    assert torch.equal(b_idx, r_idx) and torch.equal(b_dist, r_dist)


def _bound_problem(rng, cuda, n, m, count, warm):
    """K2's operands on the card for ``n`` sorted sources against a
    prepared target of ``m`` rows (``count`` valid), cold or warm, and
    the sorted-target tile of each valid source's true nearest
    neighbour."""
    src = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32))
    src = src[morton_permutation(src, torch.ones(n)).long()].contiguous()
    mask = torch.ones(n)
    mask[-(n // 50):] = 0.0
    cloud = pad_cloud((rng.random((count, 3)) * 10).astype(np.float32), multiple=m,
                      device="cpu")
    target = nn_hier.prepare_hier_target(cloud.points, cloud.mask(), cloud.count)
    idx, _ = nearest_neighbors_ref(src, cloud.points, cloud.count)
    state = nn_hier.HierState(cloud.points[idx.long()], torch.tensor(warm),
                              torch.tensor(False))
    moved = src + torch.from_numpy((rng.standard_normal(src.shape) * 0.02).astype(np.float32))
    t_idx, _ = nearest_neighbors_ref(moved, cloud.points, cloud.count)
    inv = torch.empty(m, dtype=torch.long)
    real = target.packed[:, 3] < 1e30
    inv[target.packed[real, 3].long()] = torch.arange(m)[real]
    true_tile = inv[t_idx.long()] // 128
    to = lambda x: x.to(cuda)  # noqa: E731
    target = nn_hier.HierTarget(*map(to, target))
    state = nn_hier.HierState(*map(to, state))
    return to(moved), to(mask), target, state, to(true_tile)


@pytest.mark.parametrize("n,gsrc,m,count", [
    (4096, 256, 8192, 8000),
    (4096, 512, 8192, 8000),
    (4096, 1024, 8192, 8000),
    (3000, 3000, 8192, 8000),  # one ragged group (n < the default gsrc)
    (4096, 1024, 41_088, 40_000),  # C = 321 tiles: no multiple of a stage
    (4096, 4096, 41_088, 40_000),  # one cluster of 8 chunks: two stages
])
@pytest.mark.parametrize("warm", [False, True])
def test_bound_kernel_group_sizes(rng, cuda, n, gsrc, m, count, warm):
    """K2 admits exactly what its plain version admits, and every valid
    source's true tile, at every group size and tile count."""
    moved, mask, target, state, true_tile = _bound_problem(rng, cuda, n, m, count, warm)
    saug, aux, eps = nn_hier.bound_operands(moved, mask, target, state)
    adm = bound.bound_pass(saug, aux, target.caug, target.radii, eps, state.warm, gsrc)
    ref = bound.bound_pass_ref(saug[None], aux[None], target.caug[None],
                               target.radii[None], eps[None], state.warm[None], gsrc)[0]
    torch.cuda.synchronize()
    assert torch.equal(adm, ref)
    valid = mask > 0
    groups = torch.arange(n, device=cuda) // gsrc
    assert bool(adm[groups[valid], true_tile[valid]].all())
    if warm:
        assert int(adm.sum(1).max()) < m // 128  # the warm bound prunes


def _cand_case(rng, cuda, g, n=4096, gsrc=1024, m=8192):
    """A packed target of ``m`` random rows (the last 200 sentinels) and a
    table of random tile ids per group, with ragged counts (one group
    empty) and one id out of range."""
    pts = (rng.random((m, 3)) * 10).astype(np.float32)
    w = rng.permutation(m).astype(np.float32)
    pts[-200:], w[-200:] = 1e19, nn_cand.BIG
    packed = torch.from_numpy(np.concatenate([pts, w[:, None]], 1)).to(cuda)
    src = torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(cuda)
    ts, tiles = n // gsrc, m // g
    width = min(tiles, 24)
    cand = torch.from_numpy(np.stack([rng.permutation(tiles)[:width] for _ in range(ts)])
                            .astype(np.int32)).to(cuda)
    cand[-1, 0] = tiles + 5  # skipped
    counts = torch.from_numpy(rng.integers(1, width + 1, size=ts).astype(np.int32)).to(cuda)
    counts[0] = 0
    return src, packed, cand, counts


@pytest.mark.parametrize("g", [128, 256, 512, 1024])
def test_cand_kernel_tile_sizes_and_slot_order(rng, cuda, g):
    """K3 bit-identical to its plain version at every tile size; a group's
    live slots permuted give the same bits; an empty group gives
    (0, 3.4e38); a batch of two equals its pairs."""
    src, packed, cand, counts = _cand_case(rng, cuda, g)
    idx, dist = nn_cand.nearest_neighbors_cand(src, packed, cand, counts, g=g, gsrc=1024)
    r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(
        src[None], packed[None], cand[None], counts[None], g, 1024)
    torch.cuda.synchronize()
    assert torch.equal(idx, r_idx[0]) and torch.equal(dist, r_dist[0])
    assert bool((idx[:1024] == 0).all()) and bool((dist[:1024] == nn_cand.BIG).all())
    perm = cand.clone()
    for grp, c in enumerate(counts.tolist()):
        perm[grp, :c] = cand[grp, torch.randperm(c, device=cuda)]
    p_idx, p_dist = nn_cand.nearest_neighbors_cand(src, packed, perm, counts, g=g, gsrc=1024)
    torch.cuda.synchronize()
    assert torch.equal(p_idx, idx) and torch.equal(p_dist, dist)
    pair = lambda x, y: torch.stack([x, y])  # noqa: E731
    b_idx, b_dist = nn_cand.nearest_neighbors_cand_batch(
        pair(src, src), pair(packed, packed), pair(cand, perm),
        pair(counts, counts.flip(0)), g, 1024)
    r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(
        pair(src, src), pair(packed, packed), pair(cand, perm),
        pair(counts, counts.flip(0)), g, 1024)
    assert torch.equal(b_idx, r_idx) and torch.equal(b_dist, r_dist)
    assert torch.equal(b_idx[0], idx) and torch.equal(b_dist[0], dist)


def test_cand_kernel_planted_ties_across_blocks(rng, cuda):
    """Every target point twice, once in the first half of the tiles with
    the higher original index and once in the second half with the lower:
    the split hands the two copies to different blocks of the cluster, and
    the lower index must win."""
    g, m, n = 128, 8192, 2048
    pts = (rng.integers(-40, 40, size=(m // 2, 3)) * 4).astype(np.float32)
    low = rng.permutation(m // 2).astype(np.float32)
    rows = np.concatenate([np.concatenate([pts, (low + m // 2)[:, None]], 1),
                           np.concatenate([pts, low[:, None]], 1)])
    packed = torch.from_numpy(rows.astype(np.float32)).to(cuda)
    src = torch.from_numpy(pts[rng.integers(0, m // 2, size=n)] + 1.0).to(cuda)
    tiles = m // g
    cand = torch.arange(tiles, dtype=torch.int32, device=cuda).repeat(2, 1)
    counts = torch.full((2,), tiles, dtype=torch.int32, device=cuda)
    assert nn_cand.cand_geometry(1, 2, tiles, 1024).splits > 1
    idx, dist = nn_cand.nearest_neighbors_cand(src, packed, cand, counts, g=g, gsrc=1024)
    r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(
        src[None], packed[None], cand[None], counts[None], g, 1024)
    torch.cuda.synchronize()
    assert torch.equal(idx, r_idx[0]) and torch.equal(dist, r_dist[0])
    assert bool((idx < m // 2).all())


@pytest.mark.parametrize("n", [700, 1500])
def test_cand_kernel_ragged_group(rng, cuda, n):
    """One group of ``n`` sources (n < 1,024, and past one block of 512)."""
    src, packed, cand, counts = _cand_case(rng, cuda, 128, n=n, gsrc=n)
    counts[0] = 17
    idx, dist = nn_cand.nearest_neighbors_cand(src, packed, cand, counts, g=128, gsrc=n)
    r_idx, r_dist = nn_cand.nearest_neighbors_cand_ref(
        src[None], packed[None], cand[None], counts[None], 128, n)
    torch.cuda.synchronize()
    assert torch.equal(idx, r_idx[0]) and torch.equal(dist, r_dist[0])


def test_hier_search_bit_identical_to_k1(rng, cuda):
    moved, mask, target, state, cloud = _hier_problem(rng, cuda)
    k = (bound.LAUNCHES, nn_cand.LAUNCHES)
    idx, dist, new_state = nn_hier.nearest_neighbors_hier(
        moved, mask, target, state)
    k1_idx, k1_dist = nearest_neighbors(moved, cloud.points, cloud.count)
    torch.cuda.synchronize()
    assert nn_hier.ARM_TRACE[-1] == "fine" and bool(new_state.sparse)
    assert (bound.LAUNCHES, nn_cand.LAUNCHES) == (k[0] + 1, k[1] + 1)
    valid = mask > 0
    assert torch.equal(idx[valid], k1_idx[valid])
    assert torch.equal(dist[valid], k1_dist[valid])


def test_register_on_card_launches_hier_kernels_and_matches_cpu(rng, cuda):
    n = 12_000  # above the hierarchical gate on CUDA
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.2)
    t = get_random_translation_vector(rng, 1.0)
    after = (before @ r.T + t).astype(np.float32)[rng.permutation(n)]
    kw = dict(max_iterations=50, max_distance_squared=1e4, eps=1e-5)
    k = (bound.LAUNCHES, nn_cand.LAUNCHES)
    on_card = icp_register(pad_cloud(before, device=cuda),
                           pad_cloud(after, device=cuda), **kw)
    assert bound.LAUNCHES > k[0] and nn_cand.LAUNCHES > k[1]
    on_cpu = icp_register(pad_cloud(before, device="cpu"), pad_cloud(after, device="cpu"),
                          use_spatial=True, **kw)
    assert on_card.iterations == on_cpu.iterations
    for a, b in ((on_card.transform.rotation, on_cpu.transform.rotation),
                 (on_card.transform.translation, on_cpu.transform.translation)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card.transform.rotation.cpu().numpy(), r, atol=1e-3)


def _sorted_cloud(rng, n, device, spread=10.0):
    p = torch.from_numpy((rng.random((n, 3)) * spread).astype(np.float32))
    return p[morton_permutation(p, torch.ones(n)).long()].contiguous().to(device)


def test_cpd_dense_kernel_matches_plain(rng, cuda):
    """K4's two passes against their plain versions: a batch of two with
    ragged masks, one pair truncated."""
    mov = torch.stack([_sorted_cloud(rng, 3072, cuda) for _ in range(2)])
    tgt = torch.stack([_sorted_cloud(rng, 2048, cuda) for _ in range(2)])
    mm = torch.ones(2, 3072, device=cuda)
    mm[1, 2500:] = 0
    tm = torch.ones(2, 2048, device=cuda)
    tm[0, 1700:] = 0
    ty = torch.where(mm[:, :, None] > 0, mov, cpd_dense.SENTINEL).contiguous()
    scalars = cpd_dense.estep_scalars(torch.tensor([0.5, 0.05], device=cuda),
                                      torch.tensor([0.3, 0.01], device=cuda),
                                      torch.tensor([False, True], device=cuda), 1e-3)
    k = (cpd_dense.DENOM_LAUNCHES, cpd_dense.MOMENTS_LAUNCHES)
    denom = cpd_dense.denom_pass_batch(scalars, ty, tgt)
    ref = cpd_dense.denom_pass_ref(scalars, ty, tgt)
    torch.testing.assert_close(denom, ref, rtol=1e-5, atol=0)
    _, w4 = cpd_dense.moment_weights(ref[:, 0], tgt, tm, scalars[:, 1])
    acc = cpd_dense.moments_pass_batch(scalars, ty, tgt, w4)
    acc_ref = cpd_dense.moments_pass_ref(scalars, ty, tgt, w4)
    torch.cuda.synchronize()
    assert (cpd_dense.DENOM_LAUNCHES, cpd_dense.MOMENTS_LAUNCHES) == (k[0] + 1, k[1] + 1)
    torch.testing.assert_close(acc, acc_ref, rtol=1e-5, atol=1e-6)
    assert torch.all(acc[1, :, 2500:] == 0)  # sentinel rows gather nothing


def _cluster_cloud(rng, device):
    centers = np.array([[0, 0, 0], [100, 0, 0], [0, 100, 0], [0, 0, 100]], np.float32)
    pts = np.concatenate([(rng.random((1024, 3)) * 3).astype(np.float32) + c
                          for c in centers])
    p = torch.from_numpy(pts)
    return p[morton_permutation(p, torch.ones(4096)).long()].contiguous().to(device)


@pytest.mark.parametrize("fixture,s2,trunc", [
    ("uniform", 4.0, False),  # wide: full admission (the table still fits)
    ("uniform", 0.05, True),  # the Hybrid window
    ("clusters", 0.05, True),  # tight: only each cluster's own block
    ("clusters", 0.05, False),  # exact mode
])
def test_cpd_cand_kernel_bit_identical_to_dense(rng, cuda, fixture, s2, trunc):
    if fixture == "uniform":
        mov, tgt = _sorted_cloud(rng, 4096, cuda), _sorted_cloud(rng, 4096, cuda)
    else:
        mov = _cluster_cloud(rng, cuda)
        tgt = (mov + 0.01)[torch.randperm(4096, device=cuda)]
        tgt = tgt[morton_permutation(tgt, torch.ones(4096, device=cuda)).long()].contiguous()
    ones = torch.ones(4096, device=cuda)
    args = (mov, ones, tgt, ones, s2, 0.3)
    k = cpd_cand.DENOM_LAUNCHES
    cand, ovf = cpd_cand.cpd_estep_cand(*args, torch.tensor(trunc, device=cuda),
                                        checked=True)
    dense = cpd_dense.cpd_estep_dense(*args, trunc)
    torch.cuda.synchronize()
    assert not bool(ovf) and cpd_cand.DENOM_LAUNCHES == k + 1
    for f in ("p1", "pt1", "px", "error"):
        assert torch.equal(getattr(cand, f), getattr(dense, f)), f


def test_cpd_wrappers_reject_mixed_devices(cuda):
    ty = torch.zeros(1, 1024, 3, device=cuda)
    with pytest.raises(ValueError, match="one device"):
        cpd_dense.denom_pass_batch(torch.zeros(1, 4), ty, ty)
    ctas = 1024 // cpd_dense.cpd_geometry(1024).cta_rows
    table = torch.zeros(ctas, 8, dtype=torch.int32, device=cuda)
    counts = torch.zeros(ctas, dtype=torch.int32)
    with pytest.raises(ValueError, match="one device"):
        cpd_cand.denom_cand(torch.zeros(4, device=cuda), ty[0], ty[0], table, counts)


def _k5_against_k4(mov, tgt, s2, trunc, c=0.3):
    """K5's E-step (checked, must not overflow) against K4's, bit for bit;
    returns the admission and the share of pairs K5's passes visit."""
    dev = mov.device
    ones_m = torch.ones(len(mov), device=dev)
    ones_t = torch.ones(len(tgt), device=dev)
    args = (mov, ones_m, tgt, ones_t, s2, c)
    cand, ovf = cpd_cand.cpd_estep_cand(*args, torch.tensor(trunc, device=dev), checked=True)
    dense = cpd_dense.cpd_estep_dense(*args, trunc)
    torch.cuda.synchronize()
    assert not bool(ovf)
    for f in ("p1", "pt1", "px", "error"):
        assert torch.equal(getattr(cand, f), getattr(dense, f)), f
    adm = cpd_cand.block_admission(mov, ones_m, tgt, ones_t, torch.tensor(s2, device=dev),
                                   torch.tensor(trunc, device=dev))
    geo = cpd_dense.cpd_geometry(len(tgt))
    table, counts = cpd_cand.cta_tables(adm.sub_adm, adm.f_sub, geo.cta_rows, ~adm.fat_n,
                                        adm.width_m)
    visited = cpd_cand.visited_pairs(table, counts, geo.cta_rows) / (len(mov) * len(tgt))
    return adm, visited


@pytest.mark.parametrize("rows_per_thread", [1, 2])
@pytest.mark.parametrize("s2,trunc", [(1.0, True), (0.05, True), (0.01, True), (0.002, True)])
def test_cpd_cand_segments_bit_identical_to_dense(rng, cuda, monkeypatch, s2, trunc,
                                                  rows_per_thread):
    """Uniform boxes of 8 blocks a side at four sigma^2: K5 skipping 128-row
    segments inside admitted blocks equals K4 bit for bit, at either
    number of rows a thread; at the tight settings it visits fewer pairs
    than it admits block pairs."""
    if rows_per_thread == 2:
        monkeypatch.setattr(cpd_dense, "FILL_THREADS", 0)
    assert cpd_dense.cpd_geometry(8192).rows_per_thread == rows_per_thread
    mov, tgt = _sorted_cloud(rng, 8192, cuda), _sorted_cloud(rng, 8192, cuda)
    adm, visited = _k5_against_k4(mov, tgt, s2, trunc)
    if s2 <= 0.01:
        assert visited < float(adm.adm.float().mean())


def test_cpd_cand_segments_clusters_with_fat_blocks(rng, cuda, monkeypatch):
    """20 clusters of 1,024 points 100 apart, one a block, with one block a
    side refilled from every cluster: fat blocks served by K4's passes,
    everything else by K5's segment walk."""
    monkeypatch.setattr(cpd_cand, "SLOTS", 1)
    grid = np.array([[i, j, k] for i in range(3) for j in range(3) for k in range(3)][:20],
                    np.float32) * 100.0
    pts = np.concatenate([(rng.random((1024, 3)) * 3).astype(np.float32) + g for g in grid])
    mov, tgt = pts.copy(), (pts + 0.01).astype(np.float32)
    mov[3 * 1024:4 * 1024] = pts[rng.permutation(len(pts))[:1024]]
    tgt[7 * 1024:8 * 1024] = tgt[rng.permutation(len(pts))[:1024]]
    adm, _ = _k5_against_k4(torch.from_numpy(mov).to(cuda), torch.from_numpy(tgt).to(cuda),
                            0.05, True)
    assert bool(adm.fat_n.any()) and bool(adm.fat_m.any())


@pytest.mark.parametrize("s2", [0.05, 0.002])
def test_cpd_cand_segments_planted_at_the_cutoff(rng, cuda, s2):
    """Pairs planted just inside and just outside the truncation distance
    across segment boundaries: the admission margins keep every kept term,
    and K5 equals K4 bit for bit."""
    mov = _sorted_cloud(rng, 8192, cuda)
    cut = float(np.sqrt(-2.0 * np.log(1e-3) * s2))
    tgt = mov.clone()
    step = torch.zeros(3, device=cuda)
    step[0] = 1.0
    # every 37th target point sits at the cutoff distance from its moving
    # twin, alternately 1e-6 inside and outside it; the rest 0.3 of it away
    idx = torch.arange(0, 8192, 37, device=cuda)
    sign = (torch.arange(len(idx), device=cuda) % 2) * 2 - 1
    tgt = tgt + 0.3 * cut
    tgt[idx] = mov[idx] + step * (cut * (1 + 1e-6 * sign))[:, None]
    tgt = tgt[morton_permutation(tgt, torch.ones(8192, device=cuda)).long()].contiguous()
    _k5_against_k4(mov, tgt, s2, True)


@pytest.mark.parametrize("rows_per_thread", [1, 2])
def test_cpd_dense_register_tiled_matches_plain(rng, cuda, monkeypatch, rows_per_thread):
    """K4 at 1 and 2 rows a thread against its plain version: a batch of
    two with ragged masks, one pair truncated and one not; both geometries
    give the same bits (the order does not depend on them)."""
    mov = torch.stack([_sorted_cloud(rng, 4096, cuda) for _ in range(2)])
    tgt = torch.stack([_sorted_cloud(rng, 5120, cuda) for _ in range(2)])
    mm = torch.ones(2, 4096, device=cuda)
    mm[1, 3000:] = 0
    tm = torch.ones(2, 5120, device=cuda)
    tm[0, 4500:] = 0
    ty = torch.where(mm[:, :, None] > 0, mov, cpd_dense.SENTINEL).contiguous()
    scalars = cpd_dense.estep_scalars(torch.tensor([0.3, 0.02], device=cuda),
                                      torch.tensor([0.3, 0.01], device=cuda),
                                      torch.tensor([False, True], device=cuda), 1e-3)
    denom1 = cpd_dense.denom_pass_batch(scalars, ty, tgt)
    ref = cpd_dense.denom_pass_ref(scalars, ty, tgt)
    _, w4 = cpd_dense.moment_weights(ref[:, 0], tgt, tm, scalars[:, 1])
    acc1 = cpd_dense.moments_pass_batch(scalars, ty, tgt, w4)
    if rows_per_thread == 2:
        monkeypatch.setattr(cpd_dense, "FILL_THREADS", 0)
    assert cpd_dense.cpd_geometry(4096, 2).rows_per_thread == rows_per_thread
    denom = cpd_dense.denom_pass_batch(scalars, ty, tgt)
    acc = cpd_dense.moments_pass_batch(scalars, ty, tgt, w4)
    acc_ref = cpd_dense.moments_pass_ref(scalars, ty, tgt, w4)
    torch.cuda.synchronize()
    torch.testing.assert_close(denom, ref, rtol=1e-5, atol=0)
    torch.testing.assert_close(acc, acc_ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(denom, denom1) and torch.equal(acc, acc1)
    assert torch.all(acc[1, :, 3000:] == 0)  # sentinel rows gather nothing


@pytest.mark.parametrize("c,shift", [(1e-20, 7.5), (0.0, 9.0)])
def test_cpd_dense_all_underflow_row(cuda, c, shift):
    """A target row whose every term underflows: at distance 7.5 (sigma^2
    = 0.3) every exponent lies in (-103, -87), where expf gives a
    subnormal and the kernel's ex2.approx.ftz gives +0: with c = 1e-20 the
    denominators agree (both c); at 9.0 every term is below e^-104 and
    zero on both sides, so with c = 0 both denominators are exactly 0."""
    rng = np.random.default_rng(5)
    mov = torch.from_numpy((rng.random((1024, 3)) * 0.01).astype(np.float32)).to(cuda)
    tgt = torch.from_numpy((rng.random((1024, 3)) * 0.01).astype(np.float32)).to(cuda)
    tgt[100:200, 0] += shift  # the far rows
    scalars = cpd_dense.estep_scalars(torch.tensor([0.3], device=cuda),
                                      torch.tensor([c], device=cuda),
                                      torch.tensor([False], device=cuda), 1e-3)
    denom = cpd_dense.denom_pass_batch(scalars, mov[None], tgt[None])[0, 0]
    ref = cpd_dense.denom_pass_ref(scalars, mov[None], tgt[None])[0, 0]
    torch.cuda.synchronize()
    far = slice(100, 200)
    assert bool((denom[far] == c).all())
    if c == 0.0:
        assert bool((ref[far] == 0).all())
    else:
        torch.testing.assert_close(denom[far], ref[far], rtol=1e-5, atol=0)
    torch.testing.assert_close(denom[:100], ref[:100], rtol=1e-5, atol=0)


@pytest.mark.parametrize("mode", [ApproximationType.NONE, ApproximationType.Hybrid])
def test_cpd_register_on_card_matches_cpu(rng, cuda, mode):
    n = 3000
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.1)
    t = get_random_translation_vector(rng, 0.5)
    after = (before @ r.T + t).astype(np.float32)[rng.permutation(n)]
    kw = dict(weight=0.1, max_iterations=100, tolerance=1e-5, use_fgt=False,
              approximation_type=mode, use_kernels=True)
    k = cpd_dense.DENOM_LAUNCHES + cpd_cand.DENOM_LAUNCHES
    on_card = cpd_register(pad_cloud(before, device=cuda), pad_cloud(after, device=cuda), **kw)
    assert cpd_dense.DENOM_LAUNCHES + cpd_cand.DENOM_LAUNCHES > k
    on_cpu = cpd_register(pad_cloud(before, device="cpu"), pad_cloud(after, device="cpu"), **kw)
    assert on_card.iterations == on_cpu.iterations
    for a, b in ((on_card.transform.rotation, on_cpu.transform.rotation),
                 (on_card.transform.translation, on_cpu.transform.translation)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card.transform.rotation.cpu().numpy(), r, atol=1e-3)


# --- NICP, prealigned ICP and batching (slice 7) ------------------------------

@pytest.mark.parametrize("rows,m", [(8 * 1024, 1_048_576), (248 * 1024, 102_400)])
def test_kernel_at_nicp_rescore_shapes(rng, cuda, rows, m):
    """K1 at NICP's rescore shapes (8 candidates, and 248 when both axes
    are widened, x 1,024 subcloud rows) bit for bit with its plain
    version."""
    src = torch.from_numpy((rng.random((1, rows, 3)) * 10).astype(np.float32)).to(cuda)
    tgt = torch.from_numpy((rng.random((1, m, 3)) * 10).astype(np.float32)).to(cuda)
    count = torch.tensor([m], dtype=torch.int32, device=cuda)
    idx, dist = nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
    r_idx, r_dist = nn_dense.nearest_neighbors_dense_ref(src, tgt, count, chunk=256)
    torch.cuda.synchronize()
    assert torch.equal(idx, r_idx) and torch.equal(dist, r_dist)


def _stacked_hier_problem(rng, cuda, b, n, far=None):
    """``b`` pairs of ``n`` sorted sources near a warm state against their
    own prepared targets of ``n`` rows; pair ``far`` (if any) moved far
    enough to overflow every budget."""
    targets, states, moved, masks = [], [], [], []
    for k in range(b):
        cloud = pad_cloud((rng.random((n - 50, 3)) * 10).astype(np.float32), multiple=n,
                          device=cuda)
        target = nn_hier.prepare_hier_target(cloud.points, cloud.mask(), cloud.count)
        src = _sorted_cloud(rng, n, cuda)
        idx, _ = nearest_neighbors(src, cloud.points, cloud.count)
        states.append(nn_hier.HierState(cloud.points[idx.long()],
                                        torch.tensor(True, device=cuda),
                                        torch.tensor(False, device=cuda)))
        step = 3.0 if k == far else 0.02
        moved.append(src + torch.from_numpy(
            (rng.standard_normal((n, 3)) * step).astype(np.float32)).to(cuda))
        masks.append((torch.arange(n, device=cuda) < n - 31 * k).float())
        targets.append(target)
    stack = lambda xs: type(xs[0])(*(torch.stack(f) for f in zip(*xs)))  # noqa: E731
    return torch.stack(moved), torch.stack(masks), stack(targets), stack(states)


@pytest.mark.parametrize("far,arm", [(None, "fine"), (5, "dense")])
def test_hier_batch_bit_identical_to_k1_batch(rng, cuda, far, arm):
    """The batched hierarchical search at 16 x 16,384 against K1's batch
    form, tolerance 0; with one pair far from its warm state the whole
    batch takes the dense arm.  Groups of 256 sources and a budget of 96
    of the 128 tiles: a group near its warm state admits at most ~60, the
    far pair's all 128 (and all 16 coarse tiles, over their budget 10)."""
    moved, masks, target, state = _stacked_hier_problem(rng, cuda, 16, 16_384, far)
    k = (bound.BATCH_LAUNCHES[16], nn_cand.BATCH_LAUNCHES[16])
    idx, dist, new = nn_hier.nearest_neighbors_hier_batch(moved, masks, target, state,
                                                         l_budget=96, gsrc=256)
    k1_idx, k1_dist = nn_dense.nearest_neighbors_dense_batch(
        moved, target.original_points, target.count)
    torch.cuda.synchronize()
    assert nn_hier.ARM_TRACE[-1] == arm
    assert bound.BATCH_LAUNCHES[16] == k[0] + 1
    assert nn_cand.BATCH_LAUNCHES[16] == k[1] + (arm != "dense")
    valid = masks > 0
    assert torch.equal(idx[valid], k1_idx[valid]) and torch.equal(dist[valid], k1_dist[valid])
    assert new.sparse.tolist() == [arm != "dense"] * 16


@pytest.mark.parametrize("mode", [ApproximationType.NONE, ApproximationType.Full])
def test_nicp_on_card_matches_cpu(rng, cuda, mode):
    from tpuslam_torch.algorithms.nicp import nicp_register

    n = 20_000
    before = (rng.random((n, 3)) * np.array([40.0, 20.0, 10.0])).astype(np.float32)
    r = get_random_rotation_matrix(rng, 1.0)
    t = get_random_translation_vector(rng, 10.0)
    after = (before @ r.T + t).astype(np.float32)
    if mode == ApproximationType.NONE:
        after = after[rng.permutation(n)]
    k = nn_dense.LAUNCHES
    on_card = nicp_register(pad_cloud(before, device=cuda), pad_cloud(after, device=cuda),
                            approximation_type=mode, seed=1)
    assert nn_dense.LAUNCHES == k + 1  # one rescore call
    on_cpu = nicp_register(pad_cloud(before, device="cpu"), pad_cloud(after, device="cpu"),
                           approximation_type=mode, seed=1)
    assert on_card.iterations == on_cpu.iterations == 4
    np.testing.assert_allclose(on_card.transform.rotation.cpu().numpy(),
                               on_cpu.transform.rotation.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card.transform.translation.cpu().numpy(),
                               on_cpu.transform.translation.numpy(), rtol=0, atol=1e-4 * 40)
    np.testing.assert_allclose(on_card.transform.rotation.cpu().numpy(), r, atol=1e-3)


@pytest.mark.parametrize("use_spatial", [False, True])
def test_batched_icp_with_frozen_pairs_matches_solo(rng, cuda, use_spatial):
    """The batched ICP lowering on the card, with pairs that stop at once
    (identity, no correspondence) beside pairs that run: each pair equals
    its solo run bit for bit (the batched step sums each pair's rows by
    the solo call)."""
    from tpuslam_torch.algorithms.batch import icp_register_batch, stack_clouds
    from tpuslam_torch.core.types import Cloud

    n = 16_384
    scale = np.array([10.0, 5.0, 2.5], np.float32)
    moving = (rng.random((n, 3)) * scale).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.2)
    t = get_random_translation_vector(rng, 1.0)
    other = (rng.random((n, 3)) * scale).astype(np.float32)
    befores = [moving, moving, moving, other]
    afters = [(moving @ r.T + t).astype(np.float32), moving.copy(), moving + 1000.0,
              (other @ r.T + t).astype(np.float32)]
    bb, ba = stack_clouds(befores, device=cuda), stack_clouds(afters, device=cuda)
    kw = dict(eps=1e-5, max_distance_squared=50.0, max_iterations=40, use_spatial=use_spatial)
    k = nn_dense.BATCH_LAUNCHES[4] + bound.BATCH_LAUNCHES[4]
    out = icp_register_batch(bb, ba, unroll=False, **kw)
    assert nn_dense.BATCH_LAUNCHES[4] + bound.BATCH_LAUNCHES[4] > k
    iters = out.iterations.tolist()
    assert iters[1] == 0 and iters[2] == 0 and max(iters) > 2
    for p in range(4):
        solo = icp_register(Cloud(bb.points[p], bb.count[p]), Cloud(ba.points[p], ba.count[p]),
                            **kw)
        assert iters[p] == solo.iterations
        assert torch.equal(out.transform.rotation[p], solo.transform.rotation)
        assert torch.equal(out.transform.translation[p], solo.transform.translation)
        assert torch.equal(out.error[p], solo.error)


def test_register_pairs_and_prealign_on_card(rng, cuda):
    """``register_pairs`` (ICP, 16 x 2,048) launches K1's batch form with
    B = 16; prealigned ICP on the card lands within 1e-4 of the CPU run."""
    befores = [(rng.random((2048, 3)) * 10).astype(np.float32) for _ in range(16)]
    afters = []
    for b in befores:
        r = get_random_rotation_matrix(rng, 0.2)
        afters.append((b @ r.T + get_random_translation_vector(rng, 1.0)).astype(np.float32))
    k = nn_dense.BATCH_LAUNCHES[16]
    rots, _, iters, _ = tpuslam_torch.register_pairs(befores, afters, device=cuda)
    assert nn_dense.BATCH_LAUNCHES[16] > k and iters.shape == (16,)
    before = (rng.random((6000, 3)) * np.array([40.0, 20.0, 10.0])).astype(np.float32)
    r = get_random_rotation_matrix(rng, 2.0)
    after = (before @ r.T + get_random_translation_vector(rng, 30.0)).astype(np.float32)
    kw = dict(icp_prealign=True, max_iterations=60, max_distance_squared=1e9,
              convergence_epsilon=1e-6, random_seed=1)
    on_card = tpuslam_torch.register(before, after, device=cuda, **kw)
    on_cpu = tpuslam_torch.register(before, after, device="cpu", **kw)
    assert on_card[2] == on_cpu[2]
    np.testing.assert_allclose(on_card[0], on_cpu[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(on_card[0], r, atol=1e-3)


@pytest.mark.parametrize("rows", [2048, 16_384])
def test_cpd_dense_batch_pairs_equal_their_solo_calls(rng, cuda, rows):
    """K4's batch form at B = 1, 2 and 16 gives each pair the bits of its
    B = 1 call, passes and statistics alike, though the launch geometry
    (rows a thread, splits of the other cloud) changes with B x rows: the
    pair-axis CPD loop builds on it."""
    b_max = 16
    sort = lambda p: p[morton_permutation(p, torch.ones(len(p), device=cuda)).long()]
    mov = torch.stack([sort(torch.from_numpy((rng.random((rows, 3)) * 10).astype(
        np.float32)).to(cuda)) for _ in range(b_max)]).contiguous()
    tgt = torch.stack([sort(torch.from_numpy((rng.random((rows, 3)) * 10).astype(
        np.float32)).to(cuda)) for _ in range(b_max)]).contiguous()
    m_mask = torch.ones((b_max, rows), device=cuda)
    t_mask = m_mask.clone()
    t_mask[1, rows - 700:] = 0.0  # a ragged target
    s2 = torch.from_numpy(rng.uniform(0.05, 20.0, b_max).astype(np.float32)).to(cuda)
    c = torch.from_numpy(rng.uniform(0.0, 0.5, b_max).astype(np.float32)).to(cuda)
    trunc = torch.from_numpy(np.arange(b_max) % 2 == 1).to(cuda)
    args = (mov, m_mask, tgt, t_mask, s2, c, trunc)
    solo = [cpd_dense.cpd_estep_dense_batch(*(a[p:p + 1] for a in args)) for p in range(b_max)]
    geometries = set()
    for b in (1, 2, 16):
        k = cpd_dense.BATCH_LAUNCHES[b]
        out = cpd_dense.cpd_estep_dense_batch(*(a[:b] for a in args))
        torch.cuda.synchronize()
        assert cpd_dense.BATCH_LAUNCHES[b] == k + 2
        geometries.add(cpd_dense.cpd_geometry(rows, b, rows // cpd_dense.TILE))
        for p in range(b):
            for f in ("p1", "pt1", "px", "error"):
                assert torch.equal(getattr(out, f)[p], getattr(solo[p], f)[0]), (b, p, f)
    assert len(geometries) > 1 or rows == 2048


@pytest.mark.parametrize("mode", [ApproximationType.NONE, ApproximationType.Hybrid])
def test_cpd_pair_axis_on_card_equals_solo(rng, cuda, mode):
    """``cpd_register_batch`` on 4 x 2,048 pairs: one K4 batch call per
    iteration with B = 4 while all pairs step, each pair equal to its solo
    run (K5 in its slow phase) bit for bit."""
    from tpuslam_torch.algorithms.batch import cpd_register_batch, stack_clouds
    from tpuslam_torch.core.types import Cloud

    befores, afters = [], []
    for _ in range(4):
        b = (rng.random((2048, 3)) * 10).astype(np.float32)
        r = get_random_rotation_matrix(rng, 0.1)
        befores.append(b)
        afters.append((b @ r.T + get_random_translation_vector(rng, 0.5)).astype(np.float32))
    bb, ba = stack_clouds(befores, device=cuda), stack_clouds(afters, device=cuda)
    kw = dict(weight=0.1, const_scale=True, max_iterations=40, tolerance=1e-5,
              approximation_type=mode, use_fgt=False)
    k = cpd_dense.BATCH_LAUNCHES[4]
    out = cpd_register_batch(bb, ba, **kw)
    assert cpd_dense.BATCH_LAUNCHES[4] > k
    for p in range(4):
        solo = cpd_register(Cloud(bb.points[p], bb.count[p]), Cloud(ba.points[p], ba.count[p]),
                            **kw)
        assert int(out.iterations[p]) == solo.iterations
        assert torch.equal(out.transform.rotation[p], solo.transform.rotation)
        assert torch.equal(out.transform.translation[p], solo.transform.translation)
        assert torch.equal(out.error[p], solo.error)


def test_cpd_pair_axis_on_card_truncated_pairs_take_k5(rng, cuda, monkeypatch):
    """Above ``CAND_MIN_ROWS`` (lowered here to 2,048 rows) the batched
    loop's truncated E-steps launch K5 pair by pair; exact ones stay in
    K4's batch form, and each pair equals its solo run bit for bit."""
    from tpuslam_torch.algorithms import batch as batch_mod
    from tpuslam_torch.algorithms.batch import cpd_register_batch, stack_clouds
    from tpuslam_torch.core.types import Cloud

    monkeypatch.setattr(batch_mod, "CAND_MIN_ROWS", 2048)
    befores, afters = [], []
    for _ in range(4):
        b = (rng.random((2048, 3)) * 10).astype(np.float32)
        r = get_random_rotation_matrix(rng, 0.1)
        befores.append(b)
        afters.append((b @ r.T + get_random_translation_vector(rng, 0.5)).astype(np.float32))
    bb, ba = stack_clouds(befores, device=cuda), stack_clouds(afters, device=cuda)
    kw = dict(weight=0.1, const_scale=True, max_iterations=40, tolerance=0.0,
              approximation_type=ApproximationType.Hybrid, use_fgt=False)
    k4, k5 = cpd_dense.BATCH_LAUNCHES[4], cpd_cand.DENOM_LAUNCHES
    out = cpd_register_batch(bb, ba, **kw)
    assert cpd_dense.BATCH_LAUNCHES[4] > k4 and cpd_cand.DENOM_LAUNCHES > k5
    for p in range(4):
        solo = cpd_register(Cloud(bb.points[p], bb.count[p]), Cloud(ba.points[p], ba.count[p]),
                            **kw)
        assert int(out.iterations[p]) == solo.iterations
        assert torch.equal(out.transform.rotation[p], solo.transform.rotation)
        assert torch.equal(out.transform.translation[p], solo.transform.translation)
        assert torch.equal(out.error[p], solo.error)


def test_chunked_icp_and_cpd_on_card_equal_whole(rng, cuda):
    """Chunked ICP on the hierarchical arm at 102,400 points (the warm state
    crosses each boundary on the card) and chunked CPD (sorted once) equal
    their whole runs bit for bit."""
    from tpuslam_torch.algorithms.cpd import cpd_register_chunked
    from tpuslam_torch.algorithms.icp import icp_register_chunked

    n = 102_400
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.1)
    after = (before @ r.T + get_random_translation_vector(rng, 0.5)).astype(np.float32)
    b, a = pad_cloud(before, device=cuda), pad_cloud(after[rng.permutation(n)], device=cuda)
    kw = dict(eps=0.0, max_distance_squared=1e4, max_iterations=12, use_spatial=True)
    whole = icp_register(b, a, **kw)
    parts = icp_register_chunked(b, a, chunk=5, **kw)
    assert parts.iterations == whole.iterations == 12
    assert torch.equal(parts.transform.rotation, whole.transform.rotation)
    assert torch.equal(parts.transform.translation, whole.transform.translation)
    assert torch.equal(parts.error, whole.error)
    small = 8192
    b, a = pad_cloud(before[:small], device=cuda), pad_cloud(after[:small], device=cuda)
    kw = dict(weight=0.1, const_scale=True, max_iterations=30, tolerance=0.0,
              approximation_type=ApproximationType.Hybrid, use_fgt=False)
    whole = cpd_register(b, a, **kw)
    parts = cpd_register_chunked(b, a, chunk=4, **kw)
    assert parts.iterations == whole.iterations
    assert torch.equal(parts.transform.rotation, whole.transform.rotation)
    assert torch.equal(parts.transform.translation, whole.transform.translation)
    assert torch.equal(parts.error, whole.error)


@pytest.mark.parametrize("lowering", [dict(), dict(scan=False), dict(batch=True)])
def test_sequence_on_card_follows_the_truth(rng, cuda, lowering):
    """Five scans of 16,384 points on the card (the hierarchical arm from
    8,192 rows): every absolute pose within 1 degree and 0.15 of the truth;
    the stream equals the scan lowering."""
    from tpuslam_torch.data.synthesis import get_random_rotation_matrix as rot

    n, scene = 16_384, (rng.random((16_384, 3)) * 10.0).astype(np.float32)
    poses = [(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))]
    for _ in range(4):
        dr, dt = rot(rng, 0.08), get_random_translation_vector(rng, 0.4)
        r_prev, t_prev = poses[-1]
        poses.append(((r_prev @ dr).astype(np.float32), (r_prev @ dt + t_prev).astype(np.float32)))
    scans = [((scene - t) @ r)[rng.permutation(n)].astype(np.float32) for r, t in poses]
    kw = dict(max_iterations=60, max_distance_squared=1e6)
    out = tpuslam_torch.register_sequence(scans, device=cuda, **lowering, **kw)
    for k, (r, t) in enumerate(poses):
        est = out.absolute[k]
        cos = (np.trace(est.rotation.astype(np.float64) @ r.T.astype(np.float64)) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 1.0, k
        assert np.linalg.norm(est.translation - t) < 0.15, k
    if not lowering:
        stream = tpuslam_torch.sequence_stream(scans[0], device=cuda, **kw)
        for s in scans[1:]:
            stream.push(s)
        for p, q in zip(stream.absolute, out.absolute):
            np.testing.assert_array_equal(p.rotation, q.rotation)


def _front_request(method, n, **extra):
    return {"method": method, "before-path": f"synthetic://{n}",
            "after-path": f"synthetic://{n}", "cloud-spread": 10.0, "random-seed": 19,
            "rotation-range": 0.2, "translation-range": 1.0, "max-iterations": 50, **extra}


def test_cli_one_shot_on_card_saves_the_in_process_result(tmp_path, cuda):
    """``python -m tpuslam_torch cfg.json`` takes the card by default; the
    cloud it saves equals ``transform_cloud(before, R, t)`` of the same
    registration run in this process on the card, bit for bit."""
    import contextlib
    import io
    import json
    import os
    import subprocess
    import sys

    from tpuslam_torch.algorithms.registry import run_with_configuration
    from tpuslam_torch.config.parser import ConfigParser
    from tpuslam_torch.data.loader import load_cloud
    from tpuslam_torch.data.synthesis import get_clouds_from_config, transform_cloud

    out = tmp_path / "out.obj"
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps(_front_request("icp", 16_384, **{"save-output-path": str(out)})))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "tpuslam_torch", str(cfg)], cwd=root,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "Results for the icp method:" in proc.stdout
    assert f"device: cuda:0 ({torch.cuda.get_device_name(0)})" in proc.stderr
    with contextlib.redirect_stdout(io.StringIO()):
        config = ConfigParser([str(cfg)]).get_configuration()
    before, after, _ = get_clouds_from_config(config)
    rot, trans, _, _ = run_with_configuration(before, after, config, device=cuda)
    np.testing.assert_array_equal(load_cloud(str(out)), transform_cloud(before, rot, trans))


def test_serve_on_card_launches_the_kernels(cuda):
    """``--serve`` on the card at 16,384 points: ICP launches K2 and K3 (the
    hierarchical arm; at this size the cold query need not overflow to K1),
    ICP at 4,096 points K1 (the dense arm below 8,192 rows), NICP K1, CPD
    K4 or K5; bad lines answer ``{"ok": false}`` and the loop goes on;
    each answer equals ``run_with_configuration`` on the same config bit
    for bit."""
    import contextlib
    import io
    import json

    from tpuslam_torch.algorithms.registry import run_with_configuration
    from tpuslam_torch.config.parser import ConfigParser
    from tpuslam_torch.data.synthesis import get_clouds_from_config
    from tpuslam_torch.harness import cli

    n = 16_384
    good = [_front_request("icp", n), _front_request("icp", 4096), _front_request("nicp", n),
            _front_request("cpd", n, **{"approximation-type": "hybrid", "cpd-weight": 0.1,
                                        "cpd-const-scale": True})]
    lines = [json.dumps(r) for r in good] + ["not json {",
                                             json.dumps({**good[0], "method": "supericp"})]
    launches = []

    def counts():  # K1, K2, K3, K4, K5
        return [nn_dense.LAUNCHES, bound.LAUNCHES, nn_cand.LAUNCHES,
                cpd_dense.DENOM_LAUNCHES + cpd_dense.MOMENTS_LAUNCHES,
                cpd_cand.DENOM_LAUNCHES + cpd_cand.MOMENTS_LAUNCHES]

    def stream():
        for line in lines:
            launches.append(counts())
            yield line + "\n"
        launches.append(counts())

    out = io.StringIO()
    assert cli.run_serve(stream(), out, device="cuda") == 0
    answers = [json.loads(ln) for ln in out.getvalue().splitlines()]
    assert [a["ok"] for a in answers] == [True, True, True, True, False, False]
    per = [[b - a for a, b in zip(launches[i], launches[i + 1])] for i in range(len(lines))]
    assert per[0][1] > 0 and per[0][2] > 0  # ICP at 16,384: K2, K3
    assert per[1][0] > 0 and per[1][1] == per[1][2] == 0  # ICP at 4,096: K1 alone
    assert per[2][0] > 0  # NICP: K1
    assert per[3][3] + per[3][4] > 0  # CPD: K4 or K5
    for request, answer in zip(good, answers):
        with contextlib.redirect_stdout(io.StringIO()):
            config = ConfigParser.from_dict(request).get_configuration()
        before, after, _ = get_clouds_from_config(config)
        rot, trans, iters, err = run_with_configuration(before, after, config, device=cuda)
        np.testing.assert_array_equal(np.asarray(answer["rotation"], np.float32), rot)
        np.testing.assert_array_equal(np.asarray(answer["translation"], np.float32), trans)
        assert answer["iterations"] == iters and answer["error"] == err


# -- the sharded layer (tpuslam_torch.parallel) on the card ----------------------


def _sharded_inputs(rng, n=20_000):
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.1)
    after = (before @ r.T + get_random_translation_vector(rng, 0.5)).astype(np.float32)
    return before, after[rng.permutation(n)]


@pytest.mark.parametrize("world,backend", [(1, "nccl"), (2, "gloo")])
def test_sharded_dense_icp_equals_solo_on_the_card(cuda, rng, world, backend):
    """A one-rank NCCL world and a two-rank gloo world sharing the card:
    sharded dense ICP (K1 on each rank's block) equals solo dense ICP bit
    for bit, on every rank, with 20 bytes a source row an iteration."""
    from tpuslam_torch.parallel.comm_model import icp_comm_bytes
    from tpuslam_torch.parallel.launch import run_cases, run_world

    before, after = _sharded_inputs(rng)
    kw = dict(eps=0.0, max_distance_squared=1e18, max_iterations=10, divergence_guard=False)
    rank0, ranks = run_world(run_cases, world, backend,
                             None if backend == "nccl" else "cuda:0", 120.0,
                             [("icp", dict(before=before, after=after, **kw))])
    solo = icp_register(pad_cloud(before, device=cuda), pad_cloud(after, device=cuda),
                        use_spatial=False, **kw)
    got = rank0[0]["result"]
    np.testing.assert_array_equal(got["rotation"], solo.transform.rotation.cpu().numpy())
    np.testing.assert_array_equal(got["translation"], solo.transform.translation.cpu().numpy())
    np.testing.assert_array_equal(got["error"], solo.error.cpu().numpy())
    assert int(got["iterations"]) == int(solo.iterations) == 10
    for rec in ranks:
        np.testing.assert_array_equal(rec[0]["result"]["rotation"], got["rotation"])
        assert rec[0]["launches"]["K1"] == 10
    logged = sum(c.nbytes for c in rank0[0]["collectives"])
    assert logged == 10 * icp_comm_bytes(len(pad_cloud(before, device="cpu").points))["total"]


def test_sharded_cpd_estep_matches_solo_on_the_card(cuda, rng):
    """Two gloo ranks on the card: the sharded exact E-step (K4 per block)
    reduces to the solo E-step's statistics within 1e-5."""
    from tpuslam_torch.algorithms.cpd import cpd_estep_auto
    from tpuslam_torch.parallel.launch import run_cases, run_world

    moving = (rng.random((8192, 3)) * 10).astype(np.float32)
    target = (rng.random((12_000, 3)) * 10).astype(np.float32)
    rank0, _ = run_world(run_cases, 2, "gloo", "cuda:0", 120.0,
                         [("estep", dict(moving=moving, target=target, sigma2=0.5,
                                         constant=0.3, trunc=False))])
    got = rank0[0]["result"]
    assert rank0[0]["launches"]["K4_denom"] > 0
    tgt = pad_cloud(target, device=cuda)
    mov = torch.from_numpy(moving).to(cuda)
    solo = cpd_estep_auto(mov, torch.ones(8192, device=cuda), tgt.points, tgt.mask(), 0.5, 0.3,
                          False)
    for k, want in (("p1", solo.p1), ("px", solo.px), ("error", solo.error)):
        want = want.cpu().numpy()
        assert np.abs(got[k] - want).max() <= 1e-5 * np.abs(want).max(), k


def _svd_cases(rng, case, b):
    """f32[b, 3, 3] cross-covariances of one kind: random, rank 2, a
    repeated singular value, a reflection (det < 0), zero, non-finite."""
    hs = []
    for _ in range(b):
        u, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        v, _ = np.linalg.qr(rng.standard_normal((3, 3)))
        s = {"random": [5.0, 2.0, 0.5], "rank2": [4.0, 1.5, 0.0],
             "repeated": [3.0, 3.0, 1.0], "reflection": [6.0, 2.5, 1.0],
             "zero": [0.0, 0.0, 0.0], "nonfinite": [2.0, 1.0, 0.5]}[case]
        h = u @ np.diag(s) @ v.T
        if case == "reflection" and np.linalg.det(h) > 0:
            h[:, 0] *= -1
        elif case != "reflection" and np.linalg.det(u @ v.T) < 0:
            h = -h if case != "zero" else h
        if case == "nonfinite":
            h[1, 2] = np.nan if len(hs) % 2 else np.inf
        hs.append(h)
    return torch.from_numpy(np.stack(hs).astype(np.float32))


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("case", ["random", "rank2", "repeated", "reflection", "zero",
                                  "nonfinite"])
def test_procrustes_svd_entry_against_plain(rng, cuda, case, b):
    """P's SVD entry against its plain version (``torch.linalg.svd``) run in
    float64 on the same inputs: R within 1e-6 where the rotation is unique
    (R is not for a zero H), s non-negative, descending and within 1e-6
    of the largest, det equal where the third singular value is well
    separated from 0, NaN everywhere for a non-finite H.  A pair of the
    batch equals its solo call bit for bit."""
    from tpuslam_torch.kernels import procrustes

    h = _svd_cases(rng, case, b).to(cuda)
    r, s, det = procrustes.svd_rotation_det_batch(h)
    ref = [procrustes.svd_rotation_det_ref(h[p].double()) for p in range(b)]
    torch.cuda.synchronize()
    for p in range(b):
        if case == "nonfinite":
            assert torch.isnan(r[p]).all() and torch.isnan(s[p]).all() and torch.isnan(det[p])
            continue
        assert (s[p] >= 0).all() and s[p][0] >= s[p][1] >= s[p][2]
        r_ref, s_ref, det_ref = (x.float() for x in ref[p])
        assert torch.allclose(s[p], s_ref, rtol=0, atol=1e-6 * max(float(s_ref[0]), 1.0))
        if case != "zero":
            assert torch.allclose(r[p], r_ref, rtol=0, atol=1e-6), (case, r[p], r_ref)
        if float(s_ref[2]) > 1e-3 * float(s_ref[0]):
            assert float(det[p]) == float(torch.sign(det_ref))
        r64 = r[p].double()
        assert torch.allclose(r64 @ r64.T, torch.eye(3, dtype=torch.float64, device=cuda),
                              atol=1e-6)
    for p in range(b):
        one = procrustes.svd_rotation_det_batch(h[p:p + 1])
        assert all(torch.equal(x[p:p + 1], y) for x, y in zip((r, s, det), one)
                   if case != "nonfinite")


@pytest.mark.parametrize("b", [1, 16])
@pytest.mark.parametrize("case", ["rotation", "reflection", "masked", "empty"])
def test_procrustes_kernel_against_plain(rng, cuda, case, b):
    """P against its plain version in float64 on the same inputs (the
    float32 plain version's own sums err by about 1e-6 here): R and t
    within 1e-6 (clouds centred near 0, singular values well apart), the
    error entry within 1e-6 relative; each pair of the batch equals its
    solo call bit for bit."""
    from tpuslam_torch.kernels import procrustes

    n = 4096
    befores, afters, ws = [], [], []
    for _ in range(b):
        before = (rng.random((n, 3)) - 0.5) * np.array([4.0, 2.0, 1.0])
        r, t = get_random_rotation_matrix(rng, 0.5), get_random_translation_vector(rng, 0.3)
        after = before @ r.T + t + rng.normal(0, 0.01, (n, 3))
        w = np.ones(n)
        if case == "reflection":
            after = after * np.array([-1.0, 1.0, 1.0])
        elif case == "masked":
            w = (rng.random(n) > 0.4).astype(np.float64)
            after[w == 0] += 100.0
        elif case == "empty":
            w = np.zeros(n)
        befores.append(before), afters.append(after), ws.append(w)
    f32 = lambda x: torch.from_numpy(np.stack(x).astype(np.float32)).to(cuda)  # noqa: E731
    before, after, w = f32(befores), f32(afters), f32(ws)
    r, t = procrustes.weighted_procrustes_batch(before, after, w)
    diff = after - before
    n_corr = w.sum(1)
    err = procrustes.mean_sq_error_batch(diff, w, n_corr)
    torch.cuda.synchronize()
    for p in range(b):
        r_ref, t_ref = procrustes.weighted_procrustes_ref(
            before[p].double(), after[p].double(), w[p].double())
        if case != "empty":  # no correspondence: H = 0 and R is not unique
            assert torch.allclose(r[p].double(), r_ref, rtol=0, atol=1e-6), (case, r[p], r_ref)
        assert torch.allclose(t[p].double(), t_ref, rtol=0, atol=1e-6), (case, t[p], t_ref)
        e_ref = procrustes.mean_sq_error_ref(diff[p].double(), w[p].double(),
                                             n_corr[p].double())
        assert abs(float(err[p]) - float(e_ref)) <= 1e-6 * max(abs(float(e_ref)), 1e-30)
        assert abs(float(torch.linalg.det(r[p].double())) - 1.0) < 1e-6
        r1, t1 = procrustes.weighted_procrustes_batch(before[p:p + 1], after[p:p + 1],
                                                      w[p:p + 1])
        e1 = procrustes.mean_sq_error_batch(diff[p:p + 1], w[p:p + 1], n_corr[p:p + 1])
        assert torch.equal(r1[0], r[p]) and torch.equal(t1[0], t[p]) and torch.equal(e1[0], err[p])


def test_predicated_k1_and_k3_write_only_when_selected(rng, cuda):
    """K1 and K3 with an arm code: a launch whose value is not the code
    returns at once (the output keeps its sentinel), the selected one
    writes what the unpredicated launch writes; each launch is counted by
    its wrapper, and the unselected one as skipped by the device."""
    n = 4096
    src = torch.from_numpy((rng.random((1, n, 3)) * 10).astype(np.float32)).to(cuda)
    tgt = torch.from_numpy((rng.random((1, 8192, 3)) * 10).astype(np.float32)).to(cuda)
    count = torch.tensor([8192], dtype=torch.int32, device=cuda)
    want = nn_dense.nearest_neighbors_dense_batch(src, tgt, count)
    packed = torch.cat([tgt, torch.arange(8192, device=cuda, dtype=torch.float32)[None, :, None]],
                       dim=2).contiguous()
    cand = torch.arange(64, dtype=torch.int32, device=cuda).repeat(1, n // 1024, 1).contiguous()
    counts = torch.full((1, n // 1024), 64, dtype=torch.int32, device=cuda)
    want3 = nn_cand.nearest_neighbors_cand_batch(src, packed, cand, counts, g=128, gsrc=1024)
    for code in (0, 1, 2):
        arm = torch.tensor([code], dtype=torch.int32, device=cuda)
        launches = (nn_dense.LAUNCHES, nn_cand.LAUNCHES)
        before = kernels.launch_counts()
        for run, value, ref in (
            (lambda out: nn_dense.nearest_neighbors_dense_batch(
                src, tgt, count, arm=arm, arm_value=2, out=out), 2, want),
            (lambda out: nn_cand.nearest_neighbors_cand_batch(
                src, packed, cand, counts, g=128, gsrc=1024, arm=arm, arm_value=0, out=out),
             0, want3),
        ):
            out = (torch.full((1, n), -7, dtype=torch.int32, device=cuda),
                   torch.full((1, n), -1.0, device=cuda))
            run(out)
            torch.cuda.synchronize()
            if code == value:
                assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
            else:
                assert bool((out[0] == -7).all()) and bool((out[1] == -1.0).all())
        assert (nn_dense.LAUNCHES, nn_cand.LAUNCHES) == (launches[0] + 1, launches[1] + 1)
        now = kernels.launch_counts()
        assert now["K1 skipped"] - before["K1 skipped"] == int(code != 2)
        assert now["K3 skipped"] - before["K3 skipped"] == int(code != 0)


@pytest.mark.parametrize("use_spatial", [False, True])
def test_device_loop_graph_equals_eager_one_iteration_loop(rng, cuda, use_spatial):
    """The captured, replayed chunk against the eager loop of one
    iteration a read, bit for bit (R, t, error, iterations, arms); the
    second registration of a ``graph_scope`` replays the graph the first
    captured; a warm registration makes no synchronising call in
    ``procrustes.py`` or ``nn_hier.py`` and at most one a chunk plus the
    set-up's."""
    from tpuslam_torch.algorithms import icp
    from tpuslam_torch.harness.benchkit import count_syncs

    n = 16_384
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r_true = get_random_rotation_matrix(rng, 0.15)
    after = (before @ r_true.T + get_random_translation_vector(rng, 0.5)).astype(np.float32)
    b, a = pad_cloud(before, device=cuda), pad_cloud(after, device=cuda)
    kw = dict(eps=1e-7, max_distance_squared=1e4, max_iterations=30, use_spatial=use_spatial)
    nn_hier.ARM_TRACE.clear()
    icp.CUDA_GRAPHS = False  # the eager reference: one iteration a read, no graph
    try:
        want = icp_register(b, a, **kw)
    finally:
        icp.CUDA_GRAPHS = True
    want_arms = list(nn_hier.ARM_TRACE)
    saved = icp.LOOP_CHUNK
    try:
        for k in (1, 4, 8):
            icp.LOOP_CHUNK = k
            with icp.graph_scope({}) as graphs:
                for _ in range(2):  # capture, then replay the scope's graph
                    nn_hier.ARM_TRACE.clear()
                    got = icp_register(b, a, **kw)
                    assert got.iterations == want.iterations
                    assert torch.equal(got.transform.rotation, want.transform.rotation)
                    assert torch.equal(got.transform.translation, want.transform.translation)
                    assert torch.equal(got.error, want.error)
                    assert list(nn_hier.ARM_TRACE) == want_arms
                    assert len(graphs) == 1
        icp.LOOP_CHUNK = 4
        with icp.graph_scope({}):
            icp_register(b, a, **kw)
            got, syncs, sites = count_syncs(lambda: icp_register(b, a, **kw))
    finally:
        icp.LOOP_CHUNK = saved
    assert not any("procrustes.py" in s or "nn_hier.py" in s for s in sites), sites
    # one read a chunk (the stopping step is a step too), the set-up none
    assert syncs <= -(-(got.iterations + 1) // 4), sites


@pytest.mark.parametrize("use_spatial", [False, True])
def test_replayed_graph_books_the_launches_the_device_counted(rng, cuda, use_spatial):
    """After registrations that capture and replay the loop's graph, each
    wrapper's count (its eager launches plus the replays' launches, booked
    from the device) equals the launches the kernels counted on the
    device; on the hierarchical arm the unselected arms' launches are
    counted as skipped, none on the dense arm."""
    from tpuslam_torch.algorithms import icp

    n = 16_384
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    after = (before @ get_random_rotation_matrix(rng, 0.15).T + 0.3).astype(np.float32)
    b, a = pad_cloud(before, device=cuda), pad_cloud(after, device=cuda)
    kernels.reset_launch_counts()
    with icp.graph_scope({}):
        for _ in range(3):
            icp_register(b, a, eps=0.0, max_distance_squared=1e18, max_iterations=20,
                         divergence_guard=False, use_spatial=use_spatial)
    counts = kernels.launch_counts()
    on_device = kernels.tally(cuda)[:, 0].tolist()
    assert [counts[k] for k in kernels.TALLIED] == on_device
    assert counts["P"] == 2 * 3 * 20  # Procrustes and the error, every iteration
    if use_spatial:
        assert counts["K2"] == 3 * 20 and counts["K3"] > counts["K3 skipped"]
        assert counts["K1 skipped"] + counts["K3 skipped"] == 2 * 3 * 20
    else:
        assert counts["K1"] == 3 * 20 and counts["K1 skipped"] == counts["K3 skipped"] == 0


def test_spans_mark_one_capture_and_add_no_sync(rng, cuda):
    """Two registrations of one shape through ``tpuslam_torch.register``
    inside one ``graph_scope``, under the profiler: the first captures the
    loop's graph (one ``tpuslam.loop.capture`` span, inside its
    ``tpuslam.register`` span), the second replays it (none); a warm
    registration makes as many synchronising calls with the spans live as
    without."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpuslam_torch.algorithms import icp
    from tpuslam_torch.harness.benchkit import count_syncs

    n = 16_384
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r_true = get_random_rotation_matrix(rng, 0.15)
    after = (before @ r_true.T + get_random_translation_vector(rng, 0.5)).astype(np.float32)
    kw = dict(convergence_epsilon=1e-7, max_distance_squared=1e4, max_iterations=30)

    def one():
        return tpuslam_torch.register(before, after, device=cuda, **kw)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with icp.graph_scope({}) as graphs:
        with profile(activities=acts) as prof:
            first, second = one(), one()
            torch.cuda.synchronize()
        _, off, _ = count_syncs(one)
        with profile(activities=acts):
            _, on, sites = count_syncs(one)
    assert len(graphs) == 1 and first[2] == second[2] > icp.LOOP_CHUNK
    ours = sorted((e for e in prof.events()
                   if e.name.startswith("tpuslam.") and e.device_type == DeviceType.CPU),
                  key=lambda e: e.time_range.start)
    regs = [e.time_range for e in ours if e.name == "tpuslam.register"]
    captures = [e.time_range for e in ours if e.name == "tpuslam.loop.capture"]
    assert len(regs) == 2 and len(captures) == 1
    assert regs[0].start <= captures[0].start <= captures[0].end <= regs[0].end
    assert on == off, sites


def test_fgt_spans_mark_the_setup_and_each_phase_chunk(rng, cuda):
    """Hybrid CPD forced onto the FGT, twice through ``tpuslam_torch.register``
    inside one ``graph_scope``, under the profiler: each registration's
    ``tpuslam.entry.fgt`` lies inside its ``tpuslam.entry.prepare``; its
    chunks are ``tpuslam.loop.fgt`` spans, then ``tpuslam.loop.trunc``
    ones, inside its ``tpuslam.loop``, the first registration's captures
    (one a phase that runs past one chunk) inside them; the result is the
    same bit for bit without the profiler, with as many synchronising
    calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpuslam_torch.algorithms import cpd, icp
    from tpuslam_torch.harness.benchkit import count_syncs

    n = 8192
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r_true = get_random_rotation_matrix(rng, 0.1)
    after = (before @ r_true.T + get_random_translation_vector(rng, 0.5)).astype(np.float32)
    after = after[rng.permutation(n)]
    kw = dict(computation_method=tpuslam_torch.ComputationMethod.Cpd,
              approximation_type=ApproximationType.Hybrid, cpd_weight=0.1,
              cpd_const_scale=True, cpd_tolerance=1e-6, max_iterations=60,
              cpd_use_fgt=True)

    def one():
        return tpuslam_torch.register(before, after, device=cuda, **kw)

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with icp.graph_scope({}) as graphs:
        cpd.PHASE_TRACE.clear()
        want = one()
        ran = list(cpd.PHASE_TRACE)
    assert "fgt" in ran and "trunc" in ran
    with icp.graph_scope({}) as graphs:
        with profile(activities=acts) as prof:
            first, second = one(), one()
            torch.cuda.synchronize()
        _, off, _ = count_syncs(one)
        with profile(activities=acts):
            _, on, sites = count_syncs(one)
    assert len(graphs) in (1, 2) and on == off, sites
    for got in (first, second):
        assert got[2] == want[2] and got[3] == want[3]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    ours = sorted((e for e in prof.events()
                   if e.name.startswith("tpuslam.") and e.device_type == DeviceType.CPU),
                  key=lambda e: e.time_range.start)

    def inside(inner, outer):
        return outer.start <= inner.start <= inner.end <= outer.end

    regs = [e.time_range for e in ours if e.name == "tpuslam.register"]
    assert len(regs) == 2
    k = cpd.LOOP_CHUNK
    want_names = (["tpuslam.loop.fgt"] * -(-ran.count("fgt") // k)
                  + ["tpuslam.loop.trunc"] * -(-ran.count("trunc") // k))
    for i, reg in enumerate(regs):
        mine = [e for e in ours if inside(e.time_range, reg)]
        prepare = [e.time_range for e in mine if e.name == "tpuslam.entry.prepare"]
        setup = [e.time_range for e in mine if e.name == "tpuslam.entry.fgt"]
        assert len(prepare) == len(setup) == 1 and inside(setup[0], prepare[0])
        chunks = [e for e in mine if e.name in ("tpuslam.loop.fgt", "tpuslam.loop.trunc")]
        assert [e.name for e in chunks] == want_names
        captures = [e.time_range for e in mine if e.name == "tpuslam.loop.capture"]
        assert len(captures) == (len(graphs) if i == 0 else 0)
        for c in captures:
            assert any(inside(c, e.time_range) for e in chunks)


def _cpd_pair(rng, n, cuda):
    before = (rng.random((n, 3)) * 10).astype(np.float32)
    r = get_random_rotation_matrix(rng, 0.1)
    after = (before @ r.T + get_random_translation_vector(rng, 0.5)).astype(np.float32)
    return pad_cloud(before, device=cuda), pad_cloud(after[rng.permutation(n)], device=cuda)


_CPD_MODES = {
    "exact": dict(approximation_type=ApproximationType.NONE, weight=0.1, tolerance=1e-5,
                  max_iterations=60),
    "hybrid_fgt": dict(approximation_type=ApproximationType.Hybrid, use_fgt=True, weight=0.1,
                       tolerance=0.0, const_scale=True, max_iterations=40),
    "hybrid_exact": dict(approximation_type=ApproximationType.Hybrid, use_fgt=False,
                         weight=0.1, tolerance=0.0, const_scale=True, max_iterations=40),
}


@pytest.mark.parametrize("mode", list(_CPD_MODES))
def test_cpd_device_loop_graph_equals_eager_one_iteration_loop(rng, cuda, mode):
    """The CPD loop's captured, replayed chunks (one graph a Hybrid phase
    with the FGT) against the eager loop of one iteration a read, bit for
    bit (R, t, scale, sigma^2, iterations, E-steps, K5 routes) at k = 1,
    2, 3 and 5; a warm registration reads the host only at its chunks."""
    from tpuslam_torch.algorithms import cpd, icp
    from tpuslam_torch.harness.benchkit import count_syncs

    b, a = _cpd_pair(rng, 8192, cuda)
    kw = _CPD_MODES[mode]

    def run():
        cpd.PHASE_TRACE.clear()
        cpd_cand.ROUTE_TRACE.clear()
        res = cpd_register(b, a, **kw)
        return res, list(cpd.PHASE_TRACE), list(cpd_cand.ROUTE_TRACE)

    icp.CUDA_GRAPHS = False
    try:
        want, want_phases, want_routes = run()
    finally:
        icp.CUDA_GRAPHS = True
    if mode != "exact":
        assert "trunc" in want_phases
    saved = cpd.LOOP_CHUNK
    try:
        for k in (1, 2, 3, 5):
            cpd.LOOP_CHUNK = k
            with icp.graph_scope({}):
                for _ in range(2):  # capture, then replay the scope's graphs
                    got, phases, routes = run()
                    assert got.iterations == want.iterations
                    for f in ("rotation", "translation", "scale"):
                        assert torch.equal(getattr(got.transform, f),
                                           getattr(want.transform, f))
                    assert torch.equal(got.error, want.error)
                    assert phases == want_phases and routes == want_routes
        cpd.LOOP_CHUNK = 2
        with icp.graph_scope({}):
            run()
            _, _, sites = count_syncs(lambda: cpd_register(b, a, **kw))
            _, _, setup = count_syncs(lambda: cpd._EM(
                b, a, 1e-3, kw["weight"], kw["tolerance"], kw["approximation_type"], 10.0, 8,
                kw.get("use_fgt"), 128, None, False, False).initial(None))
    finally:
        cpd.LOOP_CHUNK = saved
    loop = [s for s, v in sites.items() if v > setup.get(s, 0)]
    assert all(s.startswith(("device_loop.py", "cpd.py")) for s in loop), (sites, setup)


def test_cpd_pair_axis_graph_gives_each_pair_its_solo_bits(rng, cuda):
    """The pair-axis loop on the card: graph against eager, and each pair
    against its solo run, bit for bit, with pairs that switch phase and
    stop at different iterations."""
    from tpuslam_torch.algorithms import cpd, icp
    from tpuslam_torch.algorithms.batch import cpd_register_batch, stack_clouds
    from tpuslam_torch.core.types import Cloud

    befores, afters = [], []
    for i in range(6):
        x = (rng.random((2048, 3)) * 6).astype(np.float32)
        r = get_random_rotation_matrix(rng, 0.05 + 0.03 * i)
        befores.append(x)
        afters.append((x @ r.T + 0.1 * i).astype(np.float32)[rng.permutation(2048)])
    bb, ba = stack_clouds(befores, device=cuda), stack_clouds(afters, device=cuda)
    kw = dict(approximation_type=ApproximationType.Hybrid, weight=0.1, tolerance=1e-5,
              max_iterations=60)
    icp.CUDA_GRAPHS = False
    try:
        want = cpd_register_batch(bb, ba, **kw)
    finally:
        icp.CUDA_GRAPHS = True
    with icp.graph_scope({}):
        cpd_register_batch(bb, ba, **kw)
        got = cpd_register_batch(bb, ba, **kw)
    assert len(set(got.iterations.tolist())) > 1
    assert torch.equal(got.iterations, want.iterations)
    for f in ("rotation", "translation", "scale"):
        assert torch.equal(getattr(got.transform, f), getattr(want.transform, f))
    assert torch.equal(got.error, want.error)
    for p in range(6):
        solo = cpd.cpd_register(Cloud(bb.points[p], bb.count[p]),
                                Cloud(ba.points[p], ba.count[p]), **kw)
        assert int(got.iterations[p]) == solo.iterations
        assert torch.equal(got.transform.rotation[p], solo.transform.rotation)
        assert torch.equal(got.error[p], solo.error)


@pytest.mark.parametrize("route", ["fgt", "k5"])
def test_cpd_pair_axis_graph_runs_pair_by_pair_only_its_phase(rng, cuda, monkeypatch, route):
    """Where the pair-axis E-step runs pair by pair (the FGT's fast phase;
    K5's slow phase from ``CAND_MIN_ROWS``, lowered here to 2,048 rows), a
    chunk runs only the pairs running in its phase when it began, and its
    graph is kept under that set of pairs (a chunk that ends the loop the
    first time its set comes is not captured): graph against eager, and each
    pair against its solo run, bit for bit, with pairs that switch phase
    and stop at different iterations (clouds of 2,048, 1,200 and 400
    points, padded alike)."""
    from tpuslam_torch.algorithms import batch as batch_mod
    from tpuslam_torch.algorithms import cpd, icp
    from tpuslam_torch.algorithms.batch import cpd_register_batch, stack_clouds
    from tpuslam_torch.core.types import Cloud

    if route == "k5":
        monkeypatch.setattr(batch_mod, "CAND_MIN_ROWS", 2048)
    befores, afters = [], []
    for i, n in enumerate((2048, 1200, 400)):
        x = (rng.random((n, 3)) * 6).astype(np.float32)
        r = get_random_rotation_matrix(rng, 0.05 + 0.1 * i)
        befores.append(x)
        afters.append((x @ r.T + 0.2 * i).astype(np.float32)[rng.permutation(n)])
    bb, ba = stack_clouds(befores, device=cuda), stack_clouds(afters, device=cuda)
    kw = dict(approximation_type=ApproximationType.Hybrid, weight=0.1, tolerance=1e-5,
              max_iterations=60, use_fgt=route == "fgt", fgt_k=16)
    icp.CUDA_GRAPHS = False
    try:
        want = cpd_register_batch(bb, ba, **kw)
    finally:
        icp.CUDA_GRAPHS = True
    sets, real_chunk = [], cpd._em_chunk

    def chunk(cfg, k, phase, eligible, *args):
        sets.append(eligible)  # eager and captured chunks; a replay runs no Python
        return real_chunk(cfg, k, phase, eligible, *args)

    monkeypatch.setattr(cpd, "_em_chunk", chunk)
    with icp.graph_scope({}) as graphs:
        cpd_register_batch(bb, ba, **kw)
        got = cpd_register_batch(bb, ba, **kw)
    by_pairs = [e for e in sets if e is not None]
    assert by_pairs and any(len(pairs) < 3 for pairs in by_pairs), sets
    assert {key[-1] for key in graphs} <= set(sets), list(graphs)
    assert len(set(got.iterations.tolist())) > 1
    assert torch.equal(got.iterations, want.iterations)
    for f in ("rotation", "translation", "scale"):
        assert torch.equal(getattr(got.transform, f), getattr(want.transform, f))
    assert torch.equal(got.error, want.error)
    for p in range(3):
        solo = cpd.cpd_register(Cloud(bb.points[p], bb.count[p]),
                                Cloud(ba.points[p], ba.count[p]), **kw)
        assert int(got.iterations[p]) == solo.iterations
        assert torch.equal(got.transform.rotation[p], solo.transform.rotation)
        assert torch.equal(got.error[p], solo.error)


@pytest.mark.parametrize("scale", [1.0, 0.015, 0.002])
def test_predicated_cpd_estep_equals_the_host_route_on_the_card(rng, cuda, scale):
    """K5's E-step with its route chosen on the device (K5's and K4's
    passes all launched, each predicated; the fat subsets at a fixed
    capacity) gives the host route's statistics bit for bit, at the
    exact mode's sigma^2 (K4's route) and at the Hybrid window's."""
    n = 20_480
    m, t = (torch.from_numpy((rng.random((n, 3)) * 10).astype(np.float32)).to(cuda)
            for _ in range(2))
    m = m[morton_permutation(m, torch.ones(n, device=cuda)).long()].contiguous()
    t = t[morton_permutation(t, torch.ones(n, device=cuda)).long()].contiguous()
    ones = torch.ones(n, device=cuda)
    from tpuslam_torch.algorithms.cpd import sigma_squared_init

    s2 = sigma_squared_init(m, ones, t, ones) * scale
    args = (m, ones, t, ones, s2, torch.tensor(0.01, device=cuda),
            torch.tensor(scale < 1.0, device=cuda))
    host = cpd_cand.cpd_estep_cand(*args)
    dev = cpd_cand.cpd_estep_cand(*args, predicated=True)
    for f in ("p1", "pt1", "px", "error"):
        assert torch.equal(getattr(dev, f), getattr(host, f)), f


# -- K5's plan (csrc/cpd_plan.cu) ---------------------------------------------------


def _plan_operands(rng, cuda, n, ragged=False, scale=0.015):
    """Morton-sorted boxes of ``n`` rows (``ragged``: 4,321 more target
    rows, every 97th moving and every 89th target row left out), their
    masks and a sigma^2 ``scale`` times the initial one (0.015: the Hybrid
    window)."""
    from tpuslam_torch.algorithms.cpd import sigma_squared_init

    n_tgt = n + 4321 if ragged else n
    mov, tgt = _sorted_cloud(rng, n, cuda), _sorted_cloud(rng, n_tgt, cuda)
    mm, tm = torch.ones(n, device=cuda), torch.ones(n_tgt, device=cuda)
    if ragged:
        mm[::97] = 0
        tm[::89] = 0
    return mov, mm, tgt, tm, (sigma_squared_init(mov, mm, tgt, tm) * scale).reshape(())


def _plan_equal(args, checked=False):
    """The plan kernel against its plain version, every output bit for
    bit; returns the kernel's plan."""
    before = cpd_cand.PLAN_LAUNCHES
    got = cpd_cand.cand_plan(*args, 1e-3, checked)
    want = cpd_cand.cand_plan_ref(*args, 1e-3, checked)
    torch.cuda.synchronize()
    assert cpd_cand.PLAN_LAUNCHES == before + 3
    for f in cpd_cand.Plan._fields:
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a, b), f
    return got


@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("trunc", [True, False])
@pytest.mark.parametrize("n,f_sub,scale", [
    (4096, 8, 0.015), (12_000, 8, 0.015), (20_480, 8, 0.015), (20_480, 8, 0.002),
    (20_480, 1, 0.015), (102_400, 8, 0.015), (102_400, 2, 0.015), (376_401, 8, 0.015),
    (376_401, 4, 0.002),
])
def test_plan_kernel_equals_its_plain_version(rng, cuda, monkeypatch, n, f_sub, scale, trunc,
                                             checked):
    """K5's plan (route, tables, counts, fat rows, live, valid, scalars,
    padded operands, read-back values) bit for bit against the torch
    composition on the card, at the benchmark's sizes and 102,400 and
    376,401 rows (12,000 against 16,321 target rows: both padded, with
    masked rows), at the
    sub-tile factor the rule gives and coarser ones, with truncation on
    and off, in the checked and the unchecked (eager and predicated)
    forms."""
    blocks = -(-n // 1024)
    if cpd_cand.sub_factor(blocks, blocks) != f_sub:
        monkeypatch.setattr(cpd_cand, "SUB_BOUND_MAX", (blocks * f_sub) ** 2)
    assert cpd_cand.sub_factor(blocks, blocks) == f_sub
    mov, mm, tgt, tm, s2 = _plan_operands(rng, cuda, n, ragged=n == 12_000, scale=scale)
    args = (mov, mm, tgt, tm, s2, torch.tensor(0.01, device=cuda),
            torch.tensor(trunc, device=cuda))
    plan = _plan_equal(args, checked)
    if not trunc and not checked:
        assert int(plan.route) == 1 and int(plan.counts_n.max()) == 0


@pytest.mark.parametrize("checked", [False, True])
@pytest.mark.parametrize("case", ["fat", "overflow"])
def test_plan_kernel_fat_and_overflow_routes(rng, cuda, monkeypatch, case, checked):
    """``SLOTS`` 1: 20 clusters with one scrambled block a side have fat
    blocks within the budget (served by K4's subset passes); a uniform box
    of 4 blocks with ``FAT_MAX`` 1 overflows it (route 1, or every count
    zeroed where checked).  Every output bit for bit."""
    monkeypatch.setattr(cpd_cand, "SLOTS", 1)
    if case == "fat":
        grid = np.array([[i, j, k] for i in range(3) for j in range(3) for k in range(3)][:20],
                        np.float32) * 100.0
        pts = np.concatenate([(rng.random((1024, 3)) * 3).astype(np.float32) + g
                              for g in grid])
        mov, tgt = pts.copy(), (pts + 0.01).astype(np.float32)
        mov[3 * 1024:4 * 1024] = pts[rng.permutation(len(pts))[:1024]]
        tgt[7 * 1024:8 * 1024] = tgt[rng.permutation(len(pts))[:1024]]
        mov, tgt = torch.from_numpy(mov).to(cuda), torch.from_numpy(tgt).to(cuda)
        ones = torch.ones(len(pts), device=cuda)
        mm, tm, s2 = ones, ones, torch.tensor(0.05, device=cuda)
    else:
        monkeypatch.setattr(cpd_cand, "FAT_MAX", 1)
        mov, mm, tgt, tm, s2 = _plan_operands(rng, cuda, 4096)
    args = (mov, mm, tgt, tm, s2, torch.tensor(0.01, device=cuda),
            torch.tensor(True, device=cuda))
    plan = _plan_equal(args, checked)
    route, fat_n, fat_m = plan.read.tolist()
    if case == "fat":
        assert route == 0 and fat_n >= 1 and fat_m >= 1 and int(plan.live_n) == fat_n * 1024
    else:
        assert route == 1 and int(plan.counts_n.max()) == int(plan.counts_m.max()) == 0


def test_hybrid_registration_bit_identical_with_the_plain_plan(rng, cuda, monkeypatch):
    """A Hybrid registration at 20,000 points on the CPD loop's graphs
    (captured, then replayed) with the plan kernel and with the plain plan
    patched in: pose, sigma^2, iterations, E-step phases and K5 routes
    bit-identical, and as many synchronising calls in a warm registration.
    The replays book three plan launches a K5 call, counted on the
    device.  ``FAT_MAX`` 32 keeps the uniform box's slow phase off K4's
    route (its fat blocks exceed the budget of 8 otherwise), so K5's
    passes and the fat subsets run."""
    from tpuslam_torch.algorithms import cpd, icp
    from tpuslam_torch.harness.benchkit import count_syncs

    monkeypatch.setattr(cpd_cand, "FAT_MAX", 32)
    b, a = _cpd_pair(rng, 20_000, cuda)
    kw = _CPD_MODES["hybrid_exact"]

    def run():
        with icp.graph_scope({}):
            cpd_register(b, a, **kw)  # captures the chunk graphs
            cpd.PHASE_TRACE.clear()
            cpd_cand.ROUTE_TRACE.clear()
            before = kernels.launch_counts()
            res = cpd_register(b, a, **kw)  # replays them
            delta = kernels.launch_delta(before)
            trace = (list(cpd.PHASE_TRACE), list(cpd_cand.ROUTE_TRACE))
            _, syncs, _ = count_syncs(lambda: cpd_register(b, a, **kw))
        return res, trace, delta, syncs

    got, got_trace, got_delta, got_syncs = run()
    monkeypatch.setattr(cpd_cand, "cand_plan", cpd_cand.cand_plan_ref)
    want, want_trace, want_delta, want_syncs = run()
    assert got.iterations == want.iterations
    for f in ("rotation", "translation", "scale"):
        assert torch.equal(getattr(got.transform, f), getattr(want.transform, f)), f
    assert torch.equal(got.error, want.error)
    assert got_trace == want_trace and "k5" in got_trace[1]
    assert got_syncs == want_syncs
    assert got_delta["K5_plan"] == 3 * got_delta["K5_denom"] > 0
    assert want_delta["K5_plan"] == 0
    assert kernels.launch_counts()["K5_plan"] == kernels.tally(cuda)[
        list(kernels.TALLIED).index("K5_plan"), 0]


def test_procrustes_moments_entry_against_plain(rng, cuda):
    """P's moments entry (the CPD M-step's sums) against its float64 plain
    version within 1e-12 relative, a pair's bits equal at B = 1 and B = 8,
    and rows that are no multiple of the chunk."""
    from tpuslam_torch.kernels import procrustes as kp

    b, m, n = 8, 20_000, 17_001

    def rand(*shape, lo=0.0, hi=1.0):
        return torch.from_numpy((lo + rng.random(shape) * (hi - lo)).astype(np.float32)).to(cuda)

    ops = (rand(b, m), rand(b, m, 3, hi=10.0), rand(b, m, 3, lo=-1.0), rand(b, n),
           rand(b, n, 3, hi=10.0))
    sums = kp.mstep_moments_batch(*ops)
    for p in range(b):
        ref = kp.mstep_moments_ref(*(o[p] for o in ops))
        assert float(((sums[p] - ref).abs() / ref.abs()).max()) <= 1e-12
        assert torch.equal(kp.mstep_moments_batch(*(o[p:p + 1] for o in ops))[0], sums[p])


def test_replayed_cpd_graph_books_the_launches_the_device_counted(rng, cuda):
    """After Hybrid registrations that capture and replay the CPD loop's
    graphs, each wrapper's count equals the launches the kernels counted
    on the device, the predicated K4 and K5 passes that did no work among
    them as skipped; every M-step is one moments and one SVD launch."""
    from tpuslam_torch.algorithms import icp

    b, a = _cpd_pair(rng, 20_480, cuda)
    kw = dict(approximation_type=ApproximationType.Hybrid, use_fgt=False, weight=0.1,
              tolerance=0.0, const_scale=True, max_iterations=40)
    kernels.reset_launch_counts()
    with icp.graph_scope({}):
        for _ in range(3):
            res = cpd_register(b, a, **kw)
    counts = kernels.launch_counts()
    on_device = kernels.tally(cuda)[:, 0].tolist()
    assert [counts[k] for k in kernels.TALLIED] == on_device
    assert counts["P moments"] == counts["P svd"] >= 3 * res.iterations
    assert counts["K5_denom skipped"] + counts["K4_denom skipped"] > 0


# -- the sharded loops captured under NCCL ----------------------------------------

# name -> (kind, settings): each run captured twice (the second a warm
# registration that replays the kept graph, its synchronising calls
# counted) and once on the eager one-iteration loop.  The "cap" cases run
# to an even cap with no stop before it, so no iteration is frozen and
# the collectives of the two loops match op for op.
_SHARDED = {
    "dense": ("icp", dict(eps=1e-7, max_distance_squared=1e4, max_iterations=30)),
    "hier": ("icp", dict(eps=1e-7, max_distance_squared=1e4, max_iterations=30,
                         use_spatial=True)),
    "dense cap": ("icp", dict(eps=0.0, max_distance_squared=1e18, max_iterations=10,
                              divergence_guard=False)),
    "hier cap": ("icp", dict(eps=0.0, max_distance_squared=1e18, max_iterations=10,
                             divergence_guard=False, use_spatial=True)),
    "hybrid": ("cpd", dict(approximation_type=ApproximationType.Hybrid, use_fgt=True,
                           weight=0.1, tolerance=0.0, const_scale=True, max_iterations=40)),
    "exact cap": ("cpd", dict(weight=0.1, tolerance=0.0, eps=1e-9, max_iterations=10)),
}


# the chunked drivers on two of those cases: case -> driver chunk
_CHUNKED = {"hier": 5, "hybrid": 7}


@pytest.fixture(scope="module")
def nccl_world():
    """A one-rank NCCL world running every ``_SHARDED`` case: name ->
    (first graph run, warm graph run, eager run) records."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpuslam_torch.parallel.launch import run_cases, run_world

    rng = np.random.Generator(np.random.PCG64(14))
    clouds = {}
    for kind, n, noise in (("icp", 32_768, 0.0), ("cpd", 8192, 0.01)):
        before = (rng.random((n, 3)) * 10).astype(np.float32)
        after = before @ get_random_rotation_matrix(rng, 0.15).T + 0.3
        after = after + rng.normal(0.0, noise, after.shape) if noise else after
        clouds[kind] = dict(before=before, after=after.astype(np.float32)[rng.permutation(n)])
    cases = []
    for kind, kw in _SHARDED.values():
        for extra in ({}, dict(syncs=True), dict(eager=True)):
            cases.append((kind, dict(clouds[kind], **kw, **extra)))
    for name, chunk in _CHUNKED.items():
        kind, kw = _SHARDED[name]
        cases.append((kind, dict(clouds[kind], chunk=chunk, **kw)))
    rank0, _ = run_world(run_cases, 1, "nccl", None, 300.0, cases)
    out = {name: tuple(rank0[3 * i:3 * i + 3]) for i, name in enumerate(_SHARDED)}
    out.update(("chunked " + name, rec) for name, rec in zip(_CHUNKED, rank0[3 * len(_SHARDED):]))
    return out


def _colls(rec):
    return [(c.op, c.dtype, c.shape, c.nbytes) for c in rec["collectives"]]


@pytest.mark.parametrize("name", list(_SHARDED))
def test_sharded_graph_loop_equals_eager_one_iteration_loop(nccl_world, name):
    """On one NCCL rank the captured sharded loops (dense and hierarchical
    ICP, Hybrid CPD with the FGT, exact CPD) equal the eager loop of one
    iteration a read, bit for bit, in both captured runs, with the same
    E-steps and K5 routes; the hierarchical arm's unselected searches are
    launched predicated (skipped), the eager loop's never."""
    first, warm, eager = nccl_world[name]
    for rec in (first, warm):
        for k in ("rotation", "translation", "scale", "iterations", "error"):
            np.testing.assert_array_equal(rec["result"][k], eager["result"][k], err_msg=k)
        assert rec["phases"] == eager["phases"] and rec["routes"] == eager["routes"]
    if name.startswith("hier"):
        assert warm["launches"]["K2"] > 0 and warm["launches"]["K3"] > 0
        assert warm["launches"]["K1 skipped"] + warm["launches"]["K3 skipped"] > 0
        assert eager["launches"]["K1 skipped"] + eager["launches"]["K3 skipped"] == 0
    if name == "hybrid":
        assert "fgt" in eager["phases"] and "trunc" in eager["phases"]


@pytest.mark.parametrize("name", list(_SHARDED))
def test_sharded_second_registration_replays_the_kept_graph(nccl_world, name):
    """The second registration of a shape in one ``graph_scope`` (a world's
    cases share one) replays the kept graph from its first chunk: no eager
    warm-up chunk and no capture, so every collective of its loop is a
    replay's, booked with NaN seconds; the first registration's warm-up
    chunk measured its own."""
    first, warm, _ = nccl_world[name]
    kind, kw = _SHARDED[name]
    # the set-up's collectives: CPD's sigma^2_0 (3), the FGT's clusters (1)
    init = (3 if kind == "cpd" else 0) + (1 if kw.get("use_fgt") else 0)
    loop = [c.seconds for c in warm["collectives"][init:]]
    assert loop and all(np.isnan(loop))
    assert not any(np.isnan([c.seconds for c in first["collectives"][:init + 3]]))
    assert not any(np.isnan([c.seconds for c in warm["collectives"][:init]]))


@pytest.mark.parametrize("name", ["dense cap", "hier cap", "exact cap"])
def test_sharded_replays_book_the_eager_runs_collectives(nccl_world, name):
    """A run to an even cap freezes no iteration: the collectives booked by
    its replays (with its warm-up chunk's) equal the eager run's, op for
    op, and the bytes an iteration equal ``comm_model``'s."""
    from tpuslam_torch.parallel import comm_model

    first, warm, eager = nccl_world[name]
    assert _colls(first) == _colls(eager) == _colls(warm)
    its = int(eager["result"]["iterations"])
    if name == "exact cap":
        per = comm_model.cpd_comm_bytes(8192)
        ran = comm_model.logged_iterations(warm["collectives"], per["n_collectives"], 3)
    else:
        per = comm_model.icp_comm_bytes(32_768)
        ran = comm_model.logged_iterations(warm["collectives"], per["n_collectives"])
    assert ran == [per["total"]] * its == [per["total"]] * 10


@pytest.mark.parametrize("name", list(_SHARDED))
def test_sharded_warm_registration_reads_the_host_once_a_chunk(nccl_world, name):
    """A warm captured registration reads the host once a chunk of
    ``LOOP_CHUNK`` iterations (its status) and never inside an iteration:
    no stop-test, arm, K5-route or phase read, nothing in the search, the
    collectives or the M-step (a read inside a chunk would also fail its
    capture)."""
    from tpuslam_torch.algorithms import cpd, icp

    _, warm, _ = nccl_world[name]
    sites = warm["syncs"]["sites"]
    inner = ("nn_hier.py", "nn.py", "cpd_cand.py", "cpd_dense.py", "procrustes.py",
             "collectives.py")
    assert not any(s.startswith(inner) for s in sites), sites
    k = icp.LOOP_CHUNK if _SHARDED[name][0] == "icp" else cpd.LOOP_CHUNK
    its = int(warm["result"]["iterations"])
    reads = sum(v for s, v in sites.items() if s.startswith("device_loop.py"))
    assert 1 <= reads <= -(-(its + 1) // k), sites


@pytest.mark.parametrize("name", list(_CHUNKED))
def test_sharded_chunked_driver_replays_and_equals_the_whole_run(nccl_world, name):
    """The chunked drivers on one NCCL rank, inside the world's
    ``graph_scope`` where the whole run's graphs are kept: every driver
    chunk replays them (no collective of theirs measured on the host) and
    the trajectory is the whole eager run's, bit for bit."""
    rec, eager = nccl_world["chunked " + name], nccl_world[name][2]
    for k in ("rotation", "translation", "scale", "iterations", "error"):
        np.testing.assert_array_equal(rec["result"][k], eager["result"][k], err_msg=k)
    kind, kw = _SHARDED[name]
    # each driver chunk's set-up runs on the host: CPD's sigma^2_0 (3 psums
    # of f32[] and f32[3]) and the FGT's all_gather; ICP's has none
    setup = (3 if kind == "cpd" else 0) + (1 if kw.get("use_fgt") else 0)
    finite = [c for c in rec["collectives"] if not np.isnan(c.seconds)]
    assert all(c.op == "all_gather" or c.shape in ((), (3,)) for c in finite), finite
    assert len(finite) % max(setup, 1) == 0 and (setup or not finite)
    assert len(finite) < len(rec["collectives"])
